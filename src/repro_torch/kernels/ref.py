"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes, in fp32, with the
reference's algebra. ``ops`` runs them for tensors on the CPU; the CPU
tests hold them against the JAX reference, and ``chip_smoke.py`` holds
each kernel against them on the card. All are axis-agnostic over leading
batch dims.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def mu_update_h(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """H <- H * (W^T V) / (W^T W H + eps)."""
    wt = w.transpose(-1, -2)
    return h * (wt @ v) / (wt @ w @ h + _EPS)


def mu_update_w(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """W <- W * (V H^T) / (W H H^T + eps)."""
    ht = h.transpose(-1, -2)
    return w * (v @ ht) / (w @ (h @ ht) + _EPS)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) over rows of x (..., n, d), y (..., m, d)."""
    y = x if y is None else y
    xx = torch.sum(x * x, dim=-1)[..., :, None]
    yy = torch.sum(y * y, dim=-1)[..., None, :]
    d2 = xx + yy - 2.0 * torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def silhouette_dist_sums(
    x: torch.Tensor, onehot: torch.Tensor, y: torch.Tensor | None = None
) -> torch.Tensor:
    """Dense: materialize sqrt distances, contract with the one-hot."""
    return torch.matmul(torch.sqrt(pairwise_sq_dists(x, y)), onehot)
