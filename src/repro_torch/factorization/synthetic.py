"""Synthetic data matching the paper's experimental setup (§IV-A).

  * ``nmf_data`` — "synthetic data generator with random Gaussian features
    for a predetermined k": V = W_true H_true + noise, 1000x1100 at full
    scale, with block-structured factors so silhouette-vs-k is a square
    wave.
  * ``blob_data`` — K-Means experiment: Gaussian clusters (std 0.5) with
    overlaid random noise.
  * ``rescal_data`` — relational tensors X_r = A R_r A^T + noise for
    RESCALk.

Each draws on the device with a ``torch.Generator`` seeded from ``seed``
(the port's draws, not the reference's bits) and builds every term at
``dtype`` (default float32), as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve


def nmf_data(
    n: int = 1000,
    m: int = 1100,
    k_true: int = 8,
    noise: float = 0.01,
    seed: int = 0,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nonnegative V (n, m) with a planted rank-k_true block structure.

    Each latent component owns a contiguous block of rows/columns with
    strong loading |N(1, 0.1)| plus a weak U[0, 0.02] background.
    """
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=dev, dtype=dtype).uniform_(lo, hi, generator=gen)

    w_bg = uniform((n, k_true), 0.0, 0.02)
    h_bg = uniform((k_true, m), 0.0, 0.02)
    row_block = torch.clamp(torch.arange(n, device=dev) // max(n // k_true, 1), 0, k_true - 1)
    col_block = torch.clamp(torch.arange(m, device=dev) // max(m // k_true, 1), 0, k_true - 1)
    w_sig = F.one_hot(row_block, k_true).to(dtype)
    h_sig = F.one_hot(col_block, k_true).to(dtype).T
    w_load = torch.randn((n, k_true), device=dev, dtype=dtype, generator=gen)
    h_load = torch.randn((k_true, m), device=dev, dtype=dtype, generator=gen)
    w = w_bg + w_sig * torch.abs(1.0 + 0.1 * w_load)
    h = h_bg + h_sig * torch.abs(1.0 + 0.1 * h_load)
    v = w @ h + noise * uniform((n, m), 0.0, 1.0)
    return v, w, h


def blob_data(
    n: int = 600,
    d: int = 8,
    k_true: int = 5,
    std: float = 0.5,
    noise: float = 0.05,
    spread: float = 4.0,
    seed: int = 0,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian blobs (paper §IV-A K-Means: std 0.5 plus overlaid noise).

    Centers ~ spread * N(0, I) in d dimensions, labels uniform in
    [0, k_true), x = centers[labels] + std * N(0, I) + noise * N(0, I).
    Returns x (n, d) at ``dtype`` and labels (n,) int64.
    """
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    centers = spread * torch.randn((k_true, d), device=dev, dtype=dtype, generator=gen)
    labels = torch.randint(0, k_true, (n,), device=dev, generator=gen)
    x = centers[labels] + std * torch.randn((n, d), device=dev, dtype=dtype, generator=gen)
    x = x + noise * torch.randn((n, d), device=dev, dtype=dtype, generator=gen)
    return x, labels


def rescal_data(
    n_entities: int = 120,
    n_relations: int = 4,
    k_true: int = 6,
    noise: float = 0.01,
    seed: int = 0,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nonnegative relational tensor X (nr, n, n) = A R_r A^T + noise.

    Each latent component owns a contiguous block of entities (one-hot A
    plus a U[0, 0.05) background); R_r ~ U[0, 1) is sparsified toward
    block-diagonal interactions by 0.2 + 0.8 I; the noise is U[0, noise).
    Returns x, a (n, k_true), r (nr, k_true, k_true).
    """
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=dev, dtype=dtype).uniform_(lo, hi, generator=gen)

    blocks = torch.clamp(
        torch.arange(n_entities, device=dev) // max(n_entities // k_true, 1), 0, k_true - 1
    )
    a = F.one_hot(blocks, k_true).to(dtype)
    a = a + uniform(a.shape, 0.0, 0.05)
    r = uniform((n_relations, k_true, k_true), 0.0, 1.0)
    r = r * (0.2 + 0.8 * torch.eye(k_true, device=dev, dtype=dtype))[None]
    x = a @ r @ a.T  # (nr, n, n)
    x = x + noise * uniform(x.shape, 0.0, 1.0)
    return x, a, r
