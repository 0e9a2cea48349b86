"""K-Means in PyTorch: k-means++ seeding + Lloyd iterations.

The substrate of the paper's K-Means experiment (Davies-Bouldin,
minimization task).

Every fit is written once, at padded width: centroids live in ``k_pad``
slots of which the first ``k_eff`` are active; inactive slots are masked
out of assignment, update and convergence and stay exactly 0. The fits
are rank-polymorphic over a leading lane axis. Centroids (k_pad, d) with
a 0-d k_eff are one fit, whose distances go to the 2-D pairwise kernel on
the card; centroids (b, k_pad, d) with k_eff (b,) are b fits against one
shared x (n, d), whose distances go to the batched kernel with x read
once. ``kmeans`` is the masked fit at k_pad == k.

A bf16 x is fitted as the reference fits it on its kernel route (the
pairwise kernel writes float32): centroids, counts and the convergence
delta at x's dtype, distances, inertia and the k-means++ probabilities
(so its draws) in float32; the centroid sums are float32 rounded once
(``scoring._cluster_sums``).

Randomness enters only through ``KMeansDraws`` (``repro_torch.random``):
the first center's index and one uniform per further slot, consumed with
the reference's ``choice`` algebra (cumsum, then searchsorted of
``total * (1 - u)``). A fit at k_eff < k_pad uses the first k_eff - 1
uniforms of its k_pad - 1, as the reference burns the draws of inactive
slots, so lane i of ``kmeans_batched`` reproduces ``kmeans(x, ks[i],
draws(ks[i], ks[i]))``.

The reference vmaps a ``while_loop``, which runs until every lane is done
while a lane that has converged keeps its state. Here that is a per-lane
``running`` mask: each Lloyd step is computed for every lane and kept only
where the lane still runs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.core.scoring import _cluster_sums, _one_hot, _sum_dtype, pairwise_sq_dists
from repro_torch.random import (
    KMeansDraws,
    KMeansDrawSource,
    kmeans_draws,
    lane_generator,
    seeded_kmeans_draws,
    stack_draws,
)

from .batching import batched_lanes


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (..., k_pad, d); inactive slots are 0
    labels: torch.Tensor  # (..., n)
    inertia: torch.Tensor  # (...) sum of squared distances to the assigned centroid
    iters: torch.Tensor  # (...) Lloyd iterations run


def _active(k_eff: torch.Tensor, k_pad: int) -> torch.Tensor:
    """(..., k_pad) True on the live slots of each fit."""
    return torch.arange(k_pad, device=k_eff.device) < k_eff[..., None]


def _choice(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index drawn with probabilities p (..., n) from uniforms u (...), as
    ``jax.random.choice(p=p)`` draws it: ties and empty mass go to the first
    index, and an index past the end is clamped as a JAX gather clamps it.

    On the card the cumulative sum runs in float64. ``torch.cumsum`` of a
    CUDA float tensor is not deterministic (its scan adds in an order that
    depends on timing), and in float32 that noise moves a draw to the
    neighbouring index, an unrelated point, in a few percent of draws at
    n = 10^6: the same fit then seeded differently from run to run. The CPU
    keeps the reference's float32."""
    if p.is_cuda:
        p, u = p.double(), u.double()
    cum = torch.cumsum(p, dim=-1)
    r = cum[..., -1:] * (1.0 - u[..., None])
    return torch.searchsorted(cum, r)[..., 0].clamp_(max=p.shape[-1] - 1)


def _masked_kmeanspp_init(
    x: torch.Tensor, k_eff: torch.Tensor, draws: KMeansDraws, k_pad: int
) -> torch.Tensor:
    """k-means++ at padded width: sample the next center ∝ squared distance
    to the nearest chosen one. Slots >= k_eff stay zero and their draws are
    burned, so the active slots match the per-k init."""
    centers = x.new_zeros(k_eff.shape + (k_pad, x.shape[1]))
    centers[..., 0, :] = x[draws.first]
    slots = torch.arange(k_pad, device=x.device)
    for i in range(1, int(k_eff.max())):  # slots past every k_eff only burn draws
        d2 = pairwise_sq_dists(x, centers)  # (..., n, k_pad)
        chosen = slots < torch.clamp(k_eff, max=i)[..., None]
        dmin = d2.masked_fill_(~chosen[..., None, :], math.inf).amin(dim=-1)
        del d2
        p = dmin / torch.clamp(dmin.sum(dim=-1, keepdim=True), min=1e-12)
        pick = x[_choice(p, draws.u[..., i - 1])]  # (..., d)
        centers[..., i, :] = torch.where((i < k_eff)[..., None], pick, centers[..., i, :])
    return centers


def _kmeanspp_init(x: torch.Tensor, k: int, draws: KMeansDraws) -> torch.Tensor:
    """k-means++ seeding of k centers (k, d)."""
    return _masked_kmeanspp_init(x, torch.tensor(int(k), device=x.device), draws, int(k))


def _masked_assign(
    x: torch.Tensor, centers: torch.Tensor, k_eff: torch.Tensor, k_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-active-center labels (..., n) and inertia (...); ties go to
    the first slot, as ``jnp.argmin`` breaks them."""
    d2 = pairwise_sq_dists(x, centers)
    dmin, labels = d2.masked_fill_(~_active(k_eff, k_pad)[..., None, :], math.inf).min(dim=-1)
    return labels, dmin.sum(dim=-1)


def _lloyd_step(
    x: torch.Tensor, centers: torch.Tensor, k_eff: torch.Tensor, k_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One masked Lloyd update of every fit: (new centers, delta)."""
    active = _active(k_eff, k_pad)  # (..., k_pad)
    labels, _ = _masked_assign(x, centers, k_eff, k_pad)
    onehot = _one_hot(labels, k_pad, _sum_dtype(x.dtype))  # (..., n, k_pad)
    counts = onehot.sum(dim=-2).to(x.dtype)  # exact, then rounded once, as the reference's at x's dtype
    new = _cluster_sums(onehot, x) / torch.clamp(counts[..., None], min=1.0)
    del onehot
    # re-seed empty *active* clusters at the point farthest from its centroid
    d2 = pairwise_sq_dists(x, new)
    far = d2.masked_fill_(~active[..., None, :], math.inf).amin(dim=-1).argmax(dim=-1)
    del d2
    empty = (counts == 0) & active
    new = torch.where(empty[..., None], x[far][..., None, :], new)
    new = new.masked_fill(~active[..., None], 0.0)
    delta = ((new - centers).abs() * active[..., None]).amax(dim=(-2, -1))
    return new, delta


def _masked_lloyd(
    x: torch.Tensor,
    centers: torch.Tensor,
    k_eff: torch.Tensor,
    k_pad: int,
    max_iters: int,
    tol: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_iters`` masked Lloyd iterations from ``centers``.

    Returns (centers, delta, iters_done), each with the fits' lead shape.
    A fit stops *exactly* when its delta <= tol, so running this in chunks
    (stop when the returned delta clears tol) applies the same iterations
    as one long call. A fit that has stopped keeps its state while others
    run on (one host read of the running mask per iteration).
    """
    delta = torch.full(k_eff.shape, math.inf, dtype=x.dtype, device=x.device)
    iters = torch.zeros(k_eff.shape, dtype=torch.long, device=x.device)
    while True:
        running = (delta > tol) & (iters < max_iters)
        if not bool(running.any()):
            return centers, delta, iters
        new, new_delta = _lloyd_step(x, centers, k_eff, k_pad)
        centers = torch.where(running[..., None, None], new, centers)
        delta = torch.where(running, new_delta, delta)
        iters = iters + running.long()


# The reference's resumable entry points of the chunked (abortable) path
# are jit wrappers; eagerly they are these functions under their names.
# ``_kmeans_masked_chunk(x, centers, k_eff, k_pad, chunk, tol=1e-6)`` runs
# up to ``chunk`` iterations; the caller stops when the returned delta <=
# tol (the same iterations as the unchunked fit) or polls §III-D abort
# between chunks.
_kmeans_masked_init = _masked_kmeanspp_init
_kmeans_masked_chunk = _masked_lloyd
_kmeans_masked_assign = _masked_assign


def _kmeans_masked(
    x: torch.Tensor,
    k_eff: torch.Tensor,
    draws: KMeansDraws,
    k_pad: int,
    max_iters: int = 100,
    tol: float = 1e-6,
) -> KMeansResult:
    """Lloyd's algorithm on k_pad slots of which only the first k_eff live."""
    centers = _masked_kmeanspp_init(x, k_eff, draws, k_pad)
    centers, _, iters = _masked_lloyd(x, centers, k_eff, k_pad, max_iters, tol)
    labels, inertia = _masked_assign(x, centers, k_eff, k_pad)
    return KMeansResult(centers, labels, inertia, iters)


def kmeans(
    x: torch.Tensor,
    k: int,
    draws: KMeansDraws | None = None,
    max_iters: int = 100,
    tol: float = 1e-6,
    seed: int = 0,
) -> KMeansResult:
    """Lloyd's algorithm on x (n, d); empty clusters re-seeded at the farthest
    point. ``draws`` default: ``seeded_kmeans_draws(seed, ...)(k, k)``."""
    k = int(k)
    if draws is None:
        draws = seeded_kmeans_draws(seed, x.shape[0], x.device)(k, k)
    return _kmeans_masked(x, torch.tensor(k, device=x.device), draws, k, max_iters, tol)


def kmeans_batched(
    x: torch.Tensor,
    ks: Sequence[int],
    seed: int = 0,
    k_pad: int | None = None,
    max_iters: int = 100,
    draws: KMeansDrawSource | None = None,
) -> KMeansResult:
    """Fit every k in ``ks`` as one padded batched K-Means on the shared x.

    Returns a KMeansResult with a leading lane axis aligned with ``ks``:
    centroids (b, k_pad, d) — slots >= ks[i] are zero, labels (b, n) in
    [0, ks[i]). Lane i draws ``draws(ks[i], k_pad)`` (default
    ``seeded_kmeans_draws(seed, ...)``) and matches ``kmeans(x, ks[i],
    draws(ks[i], ks[i]))``.
    """
    ks_t, _, k_pad = batched_lanes(ks, seed, k_pad, x.device)
    source = draws if draws is not None else seeded_kmeans_draws(seed, x.shape[0], x.device)
    lanes = stack_draws([source(int(k), k_pad) for k in ks])
    return _kmeans_masked(x, ks_t, lanes, k_pad, max_iters)


def kmeans_multi_restart(
    x: torch.Tensor,
    k: int,
    seed: int = 0,
    restarts: int = 4,
    max_iters: int = 100,
    draws: Sequence[KMeansDraws] | None = None,
) -> KMeansResult:
    """``restarts`` fits of k as lanes of one batched fit; returns the
    lowest-inertia one (the first on ties). Restart r draws ``draws[r]``,
    by default from ``lane_generator(seed, r)``."""
    k = int(k)
    if draws is None:
        draws = [kmeans_draws(lane_generator(seed, r, x.device), x.shape[0], k) for r in range(restarts)]
    k_eff = torch.full((len(draws),), k, device=x.device)
    res = _kmeans_masked(x, k_eff, stack_draws(list(draws)), k, max_iters)
    best = int(torch.argmin(res.inertia))
    return KMeansResult(*(field[best] for field in res))
