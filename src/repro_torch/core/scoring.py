"""Cluster-quality scoring in PyTorch: the silhouette of NMFk's pooled columns.

The silhouette only ever consumes the (n, n) distance matrix through one
contraction, ``dist_sums = sqrt(D2) @ onehot``, so ``cluster_dist_sums``
computes the (n, k) sums directly. On the card that is the streaming CUDA
kernel (``repro_torch.kernels.ops.silhouette_dist_sums`` / ``_batched``),
which never writes the distance matrix; on the CPU it is the dense plain
version. Davies-Bouldin, the blocked tier and the noisy score model of the
reference wait for the K-Means slice.

``square_wave_score`` and ``laplacian_score`` are the §III-D synthetic score
models the search-layer tests drive.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import pairwise_sq_dists  # noqa: F401  (the plain tier)


def cluster_dist_sums(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """(…, n, k) sums of sqrt distances from every point to every cluster.

    ``out[..., i, c] = sum_j sqrt(||x_i - x_j||^2) * onehot[..., j, c]``.
    Masked points carry zero one-hot rows and contract to nothing. A 2-D
    problem goes to the 2-D kernel entry, a 3-D one to the batched entry;
    an unbatched x against a batched one-hot is broadcast first.
    """
    if x.dim() == onehot.dim() - 1:
        x = x.expand(onehot.shape[:-2] + x.shape[-2:]).contiguous()
    elif onehot.dim() == x.dim() - 1:
        onehot = onehot.expand(x.shape[:-2] + onehot.shape[-2:]).contiguous()
    if x.dim() == 2:
        return kernel_ops.silhouette_dist_sums(x, onehot)
    if x.dim() == 3:
        return kernel_ops.silhouette_dist_sums_batched(x, onehot)
    raise ValueError(f"cluster_dist_sums takes 2-D or 3-D inputs, got {x.dim()}-D")


def _one_hot(labels: torch.Tensor, num_clusters: int, dtype) -> torch.Tensor:
    return F.one_hot(labels.long(), num_clusters).to(dtype)


def silhouette_score(x: torch.Tensor, labels: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """Mean silhouette coefficient (sklearn semantics: singletons get s(i)=0)."""
    n = x.shape[0]
    labels = labels.long()
    onehot = _one_hot(labels, num_clusters, x.dtype)  # (n, k)
    sizes = onehot.sum(dim=0)  # (k,)
    dist_sums = cluster_dist_sums(x, onehot)
    own_size = sizes[labels]
    a = dist_sums[torch.arange(n, device=x.device), labels] / torch.clamp(own_size - 1.0, min=1.0)
    mean_to = dist_sums / torch.clamp(sizes[None, :], min=1.0)
    mask_own = onehot.bool()
    empty = sizes[None, :] == 0
    b = torch.where(mask_own | empty, torch.full_like(mean_to, math.inf), mean_to).amin(dim=1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12)
    s = torch.where(own_size <= 1.0, torch.zeros_like(s), s)
    return s.mean()


def silhouette_samples_masked(
    x: torch.Tensor,
    labels: torch.Tensor,
    num_clusters: int,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-point silhouette values; padding points and clusters are zeroed.

    x (..., n, d), labels (..., n) int, point_mask (..., n) bool (False =
    padding point, excluded from every cluster; its s(i) is 0). Clusters
    that are empty after masking — in particular the padded slots >= k_eff
    of a mask-padded fit — never appear in b(i). Returns s (..., n).
    """
    labels = labels.long()
    lead = torch.broadcast_shapes(x.shape[:-1], labels.shape)
    mask = torch.ones(lead, dtype=torch.bool, device=x.device)
    if point_mask is not None:
        mask = mask & point_mask
    onehot = _one_hot(labels, num_clusters, x.dtype) * mask[..., None]
    sizes = onehot.sum(dim=-2)  # (..., k) active members only
    dist_sums = cluster_dist_sums(x, onehot)  # (..., n, k)
    own_size = torch.gather(sizes[..., None, :].expand(dist_sums.shape), -1, labels[..., None])[..., 0]
    own_sum = torch.gather(dist_sums, -1, labels[..., None])[..., 0]
    a = own_sum / torch.clamp(own_size - 1.0, min=1.0)
    mean_to = dist_sums / torch.clamp(sizes[..., None, :], min=1.0)
    mask_own = F.one_hot(labels, num_clusters).bool()
    empty = sizes[..., None, :] == 0
    b = torch.where(mask_own | empty, torch.full_like(mean_to, math.inf), mean_to).amin(dim=-1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12)
    s = torch.where(own_size <= 1.0, torch.zeros_like(s), s)
    return torch.where(mask, s, torch.zeros_like(s))


def silhouette_score_masked(
    x: torch.Tensor,
    labels: torch.Tensor,
    num_clusters: int,
    point_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean silhouette over active points only; padded clusters are ignored."""
    s = silhouette_samples_masked(x, labels, num_clusters, point_mask)
    if point_mask is None:
        return s.mean(dim=-1)
    n_active = torch.broadcast_to(point_mask, s.shape).sum(dim=-1).to(s.dtype)
    return s.sum(dim=-1) / torch.clamp(n_active, min=1.0)


# --------------------------------------------------------------------------
# §III-D synthetic score distributions
# --------------------------------------------------------------------------
def square_wave_score(k, k_optimal: int, hi: float = 1.0, lo: float = 0.0) -> torch.Tensor:
    """S(k) = (sgn(k0 - k + 1/2) + 1)/2 scaled to [lo, hi]: high up to k0, a cliff after."""
    k = torch.as_tensor(k, dtype=torch.float32)
    s01 = (torch.sign(k_optimal - k + 0.5) + 1.0) / 2.0
    return lo + (hi - lo) * s01


def laplacian_score(k, k_optimal: int, width: float = 2.0, hi: float = 1.0) -> torch.Tensor:
    """Worst-case §III-D distribution: a Laplacian peak at k0."""
    k = torch.as_tensor(k, dtype=torch.float32)
    return hi * torch.exp(-torch.abs(k - k_optimal) / width)
