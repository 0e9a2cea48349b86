"""Nonnegative RESCAL via multiplicative updates (the paper's pyDRESCALk model).

X (nr, n, n) ≈ A R_r A^T with A (n, k) >= 0, R_r (k, k) >= 0.

MU updates (Frobenius objective, nonnegative RESCAL):

    A <- A * Σ_r (X_r A R_r^T + X_r^T A R_r)
             / Σ_r (A R_r A^T A R_r^T + A R_r^T A^T A R_r)        (+ eps)
    R_r <- R_r * (A^T X_r A) / (A^T A R_r A^T A + eps)

RESCALk scoring mirrors NMFk: a perturbation ensemble, A columns aligned to
perturbation 0's by NMFk's greedy matching, silhouette stability plus
relative error.

Every function takes optional leading batch axes (the ensemble's
perturbation axis, where the reference vmaps). The products are matmul
chains over the relation axis: ``X_r A`` is one (…, nr·n, n) @ (…, n, k)
product, ``X_r^T A`` reads a transposed view of X, and no (nr, n, n)-sized
intermediate is built beside the perturbed X. No TPU kernel serves these
products; on the card the silhouette of the pooled columns is the
streaming distance-sum kernel (``core.scoring.silhouette_score``).
Randomness enters only through the unscaled U[0.1, 1) draws the caller
passes (see ``repro_torch.random``).

A fit runs at X's dtype, with draws of that dtype (others raise
``TypeError``): float32, or bfloat16 as the reference's fits run on bf16
data. At bf16 the factors and the relative error stay bf16 and the
silhouette is float32 (the silhouette kernels' fp32 distance sums), as on
the reference's kernel route.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.scoring import silhouette_score
from repro_torch.random import RESCALDraws, RESCALDrawSource, check_draws, seeded_rescal_draws

from .nmfk import _align_columns

_EPS = 1e-9


class RESCALResult(NamedTuple):
    a: torch.Tensor  # (..., n, k)
    r: torch.Tensor  # (..., nr, k, k)
    rel_error: torch.Tensor  # (...,) ||X - A R A^T||_F / ||X||_F


def _init(
    x_mean: torch.Tensor, k: int, a_draw: torch.Tensor, r_draw: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaled-uniform A/R init: sqrt(max(mean(X), eps)) / k times the draws
    (RESCAL's scale, not NMF's sqrt(mean / k))."""
    scale = (torch.sqrt(torch.clamp(x_mean, min=_EPS)) / k)[..., None, None]
    return scale * a_draw, scale[..., None] * r_draw


def _xa(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """X_r A for every relation: (..., nr, n, k), one product over nr·n rows."""
    nr, n = x.shape[-3], x.shape[-2]
    return (x.flatten(-3, -2) @ a).unflatten(-2, (nr, n))


def _gram_sandwich(ata: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Σ_r (R_r AᵀA R_rᵀ + R_rᵀ AᵀA R_r): (..., k, k)."""
    g = ata.unsqueeze(-3)
    rt = r.transpose(-1, -2)
    return (r @ g @ rt + rt @ g @ r).sum(dim=-3)


def rescal_step(x: torch.Tensor, a: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One MU sweep (A then R). x (..., nr, n, n), a (..., n, k), r (..., nr, k, k)."""
    rt = r.transpose(-1, -2)
    ata = a.transpose(-1, -2) @ a
    # A update: Σ_r X_r A R_r^T + Σ_r X_r^T A R_r, the second from X's transposed view
    xta = x.transpose(-1, -2) @ a.unsqueeze(-3)  # (..., nr, n, k)
    num = (_xa(x, a) @ rt).sum(dim=-3) + (xta @ r).sum(dim=-3)
    den = a @ _gram_sandwich(ata, r)
    a = a * num / (den + _EPS)
    # R update: (A^T X_r A) / (A^T A R_r A^T A)
    ata = (a.transpose(-1, -2) @ a).unsqueeze(-3)
    num_r = a.transpose(-1, -2).unsqueeze(-3) @ _xa(x, a)
    den_r = ata @ r @ ata
    r = r * num_r / (den_r + _EPS)
    return a, r


def reconstruction_error(x: torch.Tensor, a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """||X - A R A^T||_F / ||X||_F, one relation at a time (an (..., n, n)
    residual, never an (nr, n, n) one). The squares are summed over every
    relation at float32 or wider and rounded once to X's dtype, as the
    reference's one norm over the whole residual."""
    f = torch.promote_types(x.dtype, torch.float32)
    sq = torch.zeros(x.shape[:-3], device=x.device, dtype=f)
    at = a.transpose(-1, -2)
    for i in range(x.shape[-3]):
        diff = x[..., i, :, :] - a @ r[..., i, :, :] @ at
        sq = sq + diff.square().sum(dim=(-2, -1), dtype=f)
    xsq = x.square().sum(dim=(-3, -2, -1))
    return torch.sqrt(sq.to(x.dtype)) / torch.clamp(torch.sqrt(xsq), min=_EPS)


def rescal(
    x: torch.Tensor, k: int, a_draw: torch.Tensor, r_draw: torch.Tensor, iters: int = 150
) -> RESCALResult:
    """RESCAL at rank k for a fixed iteration count from the given init draws
    (a_draw (..., n, k), r_draw (..., nr, k, k), at X's dtype)."""
    check_draws(x, (a_draw, r_draw), "X")
    a, r = _init(x.mean(dim=(-3, -2, -1)), k, a_draw, r_draw)
    for _ in range(iters):
        a, r = rescal_step(x, a, r)
    return RESCALResult(a, r, reconstruction_error(x, a, r))


def rescalk_score(
    x: torch.Tensor, k: int, draws: RESCALDraws, iters: int = 120
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean silhouette of the aligned A-column ensemble, mean rel_error).

    ``draws`` holds the perturbation noise (p, nr, n, n) and the init draws
    at k, all at X's dtype; the p fits run as one batched fit.
    """
    check_draws(x, draws, "X")
    n = x.shape[-1]
    res = rescal(x * draws.noise, k, draws.a, draws.r, iters=iters)  # a (p, n, k)
    a_all = res.a / torch.clamp(torch.linalg.vector_norm(res.a, dim=1, keepdim=True), min=1e-12)
    labels = _align_columns(a_all)  # greedy argmax against perturbation 0, as NMFk
    cols = a_all.transpose(1, 2).reshape(-1, n)  # (p*k, n)
    sil = silhouette_score(cols, labels, num_clusters=k)
    if k <= 1:  # a single cluster: silhouette undefined -> 1.0 (stable)
        sil = torch.ones_like(sil)
    return sil, res.rel_error.mean()


def make_rescalk_evaluator(
    x: torch.Tensor,
    seed: int = 0,
    n_perturbs: int = 6,
    iters: int = 120,
    epsilon: float = 0.015,
    draws: RESCALDrawSource | None = None,
) -> Callable[[int], float]:
    """Binary Bleed ``evaluate(k)`` closure over a relational tensor x (nr, n, n).

    Rank k draws from ``draws(k)``, by default ``seeded_rescal_draws(seed,
    ...)`` at X's dtype (the counterpart of the reference's ``fold_in(key,
    k)``).
    """
    nr, n, _ = x.shape
    source = draws if draws is not None else seeded_rescal_draws(seed, n, nr, n_perturbs, epsilon, x.device,
                                                                 x.dtype)

    def evaluate(k: int, should_abort=None) -> float:
        del should_abort  # one fit per call: no chunk boundary to poll
        sil, _ = rescalk_score(x, int(k), source(int(k)), iters=iters)
        return float(sil)

    return evaluate
