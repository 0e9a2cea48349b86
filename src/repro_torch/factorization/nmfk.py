"""NMFk — automatic model determination for NMF (refs [1]-[3] of the paper).

The scorer Binary Bleed wraps for NMF. For a candidate k:

  1. Make ``p`` resampled copies of V (multiplicative uniform noise).
  2. Factorize each: W^(p), H^(p) — one fit per perturbation, all of them
     on a leading fit axis (lanes x perturbations on the batched path).
  3. Pool all W columns (p × k vectors in R^n, L2-normalized) and cluster
     them into k groups by greedy alignment to perturbation 0 (each group
     holds exactly one column per perturbation).
  4. Score: silhouette of the pooled columns under those clusters. Stable
     k ⇒ tight clusters ⇒ silhouette ≈ 1; overfit k ⇒ silhouette collapses.

Returned score is the ``min`` cluster silhouette, with the mean silhouette
and the mean relative error. Randomness comes only from the ``Draws`` the
caller passes; the evaluator and the batched entry point make them from a
draw source (default: ``repro_torch.random.seeded_draws`` at V's dtype).

A bf16 V is scored at bf16, as the reference scores it on its kernel
route: the fits at bf16 (draws at V's dtype; draws of another dtype raise
``TypeError``), the pooled columns at bf16, and the silhouette's distance
sums in float32 from them, so the silhouettes are float32 and the mean
relative error bf16.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.scoring import silhouette_samples_masked
from repro_torch.random import Draws, DrawSource, check_draws, seeded_draws, stack_draws

from .batching import batched_lanes
from .nmf import _masked_init, _masked_sweeps, _nmf_masked, nmf


class NMFkScore(NamedTuple):
    min_silhouette: torch.Tensor
    mean_silhouette: torch.Tensor
    rel_error: torch.Tensor


def _perturb(v: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Multiplicative resampling: V ∘ noise, noise ~ U[1-eps, 1+eps)."""
    return v * noise


def _greedy_assign(sim: torch.Tensor, k_eff: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """Greedy argmax matching on a batch of (K, K) similarity matrices.

    sim (B, K, K) with -inf where a pairing is invalid; k_eff (B,) matching
    steps per matrix; assign (B, K) initial labels. Step t takes the
    largest remaining entry (i, j) of every matrix with t < k_eff, labels
    column j with i, and retires row i and column j. Ties go to the first
    flat index, as ``jnp.argmax`` does. K batched steps replace a loop over
    every matrix.
    """
    b, k, _ = sim.shape
    sim = sim.clone()
    assign = assign.clone()
    rows = torch.arange(b, device=sim.device)
    idx = torch.arange(k, device=sim.device)
    for t in range(k):
        flat = sim.reshape(b, k * k).argmax(dim=1)
        i, j = flat // k, flat % k
        ok = t < k_eff
        assign[rows, j] = torch.where(ok, i, assign[rows, j])
        kill_row = (idx[None, :] == i[:, None]) & ok[:, None]
        kill_col = (idx[None, :] == j[:, None]) & ok[:, None]
        sim = sim.masked_fill(kill_row[:, :, None] | kill_col[:, None, :], -math.inf)
    return assign


def _align_columns(w_all: torch.Tensor) -> torch.Tensor:
    """Greedy-match each perturbation's columns to perturbation 0's.

    w_all: (p, n, k) L2-normalized columns. Returns labels (p*k,): column j
    of perturbation q belongs to cluster labels[q*k + j].
    """
    p, _, k = w_all.shape
    sim = w_all[0].T[None] @ w_all  # (p, k_ref, k_cols)
    k_eff = torch.full((p,), k, device=w_all.device)
    assign0 = torch.zeros((p, k), dtype=torch.long, device=w_all.device)
    return _greedy_assign(sim, k_eff, assign0).reshape(p * k)


def nmfk_score(v: torch.Tensor, k: int, draws: Draws, nmf_iters: int = 150) -> NMFkScore:
    """Silhouette-stability score of rank k (higher = stable = good).

    ``draws`` holds the perturbation noise (p, n, m) and the init draws at
    k_draw >= k (sliced to k), all at V's dtype.
    """
    check_draws(v, draws)
    n = v.shape[0]
    res = nmf(_perturb(v, draws.noise), k, draws.w, draws.h, iters=nmf_iters)  # (p, n, k)
    w_all = res.w / torch.clamp(torch.linalg.vector_norm(res.w, dim=1, keepdim=True), min=1e-12)
    labels = _align_columns(w_all)  # (p*k,)
    cols = w_all.transpose(1, 2).reshape(-1, n)  # (p*k, n)
    s = silhouette_samples_masked(cols, labels, num_clusters=k)
    # s is float32 at bf16 (float32 distance sums): the reference's bf16
    # one-hot promotes to it in this product, so it is made at s's dtype
    onehot = F.one_hot(labels, k).to(s.dtype)
    sizes = onehot.sum(dim=0)
    per_cluster = (onehot.T @ s) / torch.clamp(sizes, min=1.0)
    if k > 1:
        min_sil, sil_mean = per_cluster.min(), s.mean()
    else:  # a single cluster: silhouette undefined -> 1.0 (stable)
        min_sil = sil_mean = torch.ones((), device=v.device)
    return NMFkScore(min_sil, sil_mean, res.rel_error.mean())


def _align_columns_masked(w_all: torch.Tensor, k_eff: torch.Tensor) -> torch.Tensor:
    """``_align_columns`` per lane at padded width.

    w_all (B, p, n, k_pad), k_eff (B,). Only the first k_eff columns of each
    perturbation take part; padded columns keep their own index as a
    throwaway label (their points are masked out of the scorer). Returns
    labels (B, p*k_pad).
    """
    b, p, _, k_pad = w_all.shape
    sim = w_all[:, :1].transpose(-1, -2) @ w_all  # (B, p, k_ref, k_cols)
    valid = torch.arange(k_pad, device=w_all.device)[None, :] < k_eff[:, None]  # (B, k_pad)
    pair_ok = valid[:, None, :, None] & valid[:, None, None, :]
    sim = sim.masked_fill(~pair_ok, -math.inf).reshape(b * p, k_pad, k_pad)
    assign0 = torch.arange(k_pad, device=w_all.device).expand(b * p, k_pad)
    assign = _greedy_assign(sim, k_eff.repeat_interleave(p), assign0)
    return assign.reshape(b, p * k_pad)


def _pooled_w_score(
    w_all: torch.Tensor, errs: torch.Tensor, k_eff: torch.Tensor, k_pad: int
) -> NMFkScore:
    """Score fitted perturbation ensembles, one per lane.

    w_all (B, p, n, k_pad) raw W factors, errs (B, p) rel errors, k_eff (B,).
    One streamed distance-sum pass over all lanes yields both the mean over
    active points and NMFk's per-cluster min over active clusters.
    """
    b, p, n, _ = w_all.shape
    active = torch.arange(k_pad, device=w_all.device)[None, :] < k_eff[:, None]  # (B, k_pad)
    w_all = w_all / torch.clamp(torch.linalg.vector_norm(w_all, dim=2, keepdim=True), min=1e-12)
    labels = _align_columns_masked(w_all, k_eff)  # (B, p*k_pad)
    cols = w_all.transpose(2, 3).reshape(b, p * k_pad, n)
    point_mask = active.repeat(1, p)  # (B, p*k_pad)
    s = silhouette_samples_masked(cols, labels, num_clusters=k_pad, point_mask=point_mask)
    n_active = point_mask.sum(dim=-1).to(s.dtype)
    sil_mean = s.sum(dim=-1) / torch.clamp(n_active, min=1.0)
    # at s's dtype: float32 at bf16, where the reference's bf16 one-hot promotes to it
    onehot = F.one_hot(labels, k_pad).to(s.dtype) * point_mask[..., None]  # (B, P, k_pad)
    sizes = onehot.sum(dim=-2)
    per_cluster = (onehot.transpose(-1, -2) @ s[..., None])[..., 0] / torch.clamp(sizes, min=1.0)
    min_sil = torch.where(active, per_cluster, torch.full_like(per_cluster, math.inf)).amin(dim=-1)
    one = torch.ones_like(min_sil)
    # k=1: a single cluster, silhouette undefined -> 1.0 (stable)
    min_sil = torch.where(k_eff > 1, min_sil, one)
    sil_mean = torch.where(k_eff > 1, sil_mean, one)
    return NMFkScore(min_sil, sil_mean, errs.mean(dim=-1))


def _nmfk_score_masked(
    v: torch.Tensor, k_eff: torch.Tensor, draws: Draws, k_pad: int, nmf_iters: int = 150
) -> NMFkScore:
    """``nmfk_score`` for B lanes at rank padded to k_pad and masked to k_eff.

    draws: lane-stacked noise (B, p, n, m) and init draws (B, p, n, k_pad),
    (B, p, k_pad, m). All B*p fits run as one batched fit; at k_eff == k_pad
    a lane's draws are the scalar path's.
    """
    check_draws(v, draws)
    b, p, n, m = draws.noise.shape
    vp = _perturb(v, draws.noise).reshape(b * p, n, m)
    res = _nmf_masked(
        vp,
        k_eff.repeat_interleave(p),
        draws.w.reshape(b * p, n, k_pad),
        draws.h.reshape(b * p, k_pad, m),
        k_pad,
        iters=nmf_iters,
    )
    return _pooled_w_score(res.w.reshape(b, p, n, k_pad), res.rel_error.reshape(b, p), k_eff, k_pad)


def nmfk_score_batched(
    v: torch.Tensor,
    ks: Sequence[int],
    seed: int = 0,
    k_pad: int | None = None,
    n_perturbs: int = 8,
    nmf_iters: int = 150,
    epsilon: float = 0.015,
    draws: DrawSource | None = None,
) -> NMFkScore:
    """Score every rank in ``ks`` as one padded NMFk ensemble.

    Fields carry a leading lane axis aligned with ``ks``. Lane i uses
    ``draws(ks[i], k_pad)`` — by default ``seeded_draws(seed, ...)``, the
    same schedule as ``make_nmfk_evaluator`` — so at k_pad == ks[i] the
    scalar and batched scores coincide.
    """
    ks_t, _, k_pad = batched_lanes(ks, seed, k_pad, v.device)
    n, m = v.shape
    source = draws if draws is not None else seeded_draws(seed, n, m, n_perturbs, epsilon, v.device, v.dtype)
    lanes = stack_draws([source(int(k), k_pad) for k in ks])
    return _nmfk_score_masked(v, ks_t, lanes, k_pad, nmf_iters)


def _dist_fits(
    v_l: torch.Tensor, k_eff: torch.Tensor, draws: Draws, k_pad: int, data_group, comm: str, nmf_iters: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """B lanes' perturbation ensembles row-distributed over ``data_group``:
    the whole W (B, p, n, k_pad) on every rank and the errors (B, p).

    ``draws`` are lane-stacked full-shape draws (noise (B, p, n, m), w (B,
    p, n, k_pad), h (B, p, k_pad, m)) and k_eff is (B,). Each fit keeps this
    rank's rows of its perturbation's noise, and all B·p fits run as one
    ``_dnmf_masked_local`` call: each sweep's collectives carry every fit
    (the reference's vmap over lanes and perturbations)."""
    from .distributed import _dnmf_masked_local, _rows, ring_all_gather

    check_draws(v_l, draws)
    b, p, n, m = draws.noise.shape
    n_l = v_l.shape[0]
    vp_l = _perturb(v_l, _rows(draws.noise, n_l, data_group)).reshape(b * p, n_l, m)
    w_l, errs = _dnmf_masked_local(vp_l, k_eff.repeat_interleave(p), draws.w.reshape(b * p, n, k_pad),
                                   draws.h.reshape(b * p, k_pad, m), k_pad, nmf_iters, data_group, comm)
    w_all = ring_all_gather(w_l.transpose(0, 1), data_group)  # (n, b * p, k_pad)
    # contiguous: the pooled score's silhouette kernel takes contiguous columns
    return w_all.transpose(0, 1).reshape(b, p, n, k_pad).contiguous(), errs.reshape(b, p)


def _nmfk_score_masked_dist(
    v_l: torch.Tensor,
    k_eff: int,
    draws: Draws,
    k_pad: int,
    data_group,
    comm: str = "sync",
    nmf_iters: int = 150,
) -> NMFkScore:
    """``_nmfk_score_masked`` of one lane with its fits row-distributed over
    ``data_group``.

    v_l (n_l, m) is this rank's row block of V. ``draws`` are the lane's
    full-shape draws (noise (p, n, m), w (p, n, k_pad), h (p, k_pad, m)),
    the ones the single-device path consumes; each rank keeps its rows
    (``_dist_fits``: W rows local, H replicated, the Gram sums all-reduced;
    ``comm="pipelined"`` overlaps them with the local W-update). W is
    all-gathered (p × n × k_pad, small next to V) and the pooled-column
    score runs on every rank. Fields are 0-d tensors.
    """
    k_t = _k_eff(k_eff, v_l, (1,))
    w_all, errs = _dist_fits(v_l, k_t, stack_draws([draws]), k_pad, data_group, comm, nmf_iters)
    sc = _pooled_w_score(w_all, errs, k_t, k_pad)
    return NMFkScore(*(field[0] for field in sc))


def nmfk_score_sharded(
    v: torch.Tensor,
    ks: Sequence[int],
    seed: int = 0,
    mesh=None,
    k_pad: int | None = None,
    n_perturbs: int = 8,
    nmf_iters: int = 150,
    epsilon: float = 0.015,
    comm: str = "sync",
    draws: DrawSource | None = None,
) -> NMFkScore:
    """``nmfk_score_batched`` over a ``(lane, data)`` mesh
    (``repro_torch.launch.mesh.WaveMesh``), one call per rank; ``mesh=None``
    is one rank, ``nmfk_score_batched`` itself.

    The wave is split into ``mesh.lane_count`` contiguous blocks; this rank
    scores its own block. With one data shard that is ``nmfk_score_batched``
    of the block on the whole V — lane for lane the batched plane's
    arithmetic, so the scores are its bits. With ``data > 1`` the block's
    fits are row-distributed over ``mesh.data_group`` (``_dist_fits`` on
    this rank's rows of V, every fit of the block in each sweep's
    collectives; equal to the batched scores up to the order of the Gram
    sums under ``comm="sync"``, and to the staleness of the overlapped
    schedule under ``"pipelined"``). The three score fields are then
    all-gathered over ``mesh.lane_group``, so every rank returns the whole
    wave's scores, each field at the dtype ``nmfk_score_batched`` gives it
    (the silhouettes float32 at bf16, ``rel_error`` at V's dtype). Lane k
    draws from ``draws(k, k_pad)`` (default ``seeded_draws(seed, ...)`` at
    V's dtype), as in ``nmfk_score_batched``.

    Requires ``len(ks)`` divisible by the lane count (the planes pad the
    wave to a lane multiple) and, with ``data > 1``, V's rows divisible by
    the data count.
    """
    from .distributed import check_comm, check_rows, ring_all_gather, shard_rows

    check_comm(comm)
    ks = [int(k) for k in ks]
    _, _, k_pad = batched_lanes(ks, seed, k_pad, v.device)
    lanes, data = (mesh.lane_count, mesh.data_count) if mesh is not None else (1, 1)
    if len(ks) % lanes:
        raise ValueError(f"wave size {len(ks)} not divisible by lane count {lanes}")
    check_rows(v, data)
    per = len(ks) // lanes
    lane_index = mesh.lane_index if mesh is not None else 0
    block = ks[lane_index * per:(lane_index + 1) * per]
    if data == 1:
        sc = nmfk_score_batched(v, block, seed, k_pad, n_perturbs, nmf_iters, epsilon, draws)
    else:
        ks_t = torch.tensor(block, device=v.device)
        n, m = v.shape
        source = draws if draws is not None else seeded_draws(seed, n, m, n_perturbs, epsilon, v.device, v.dtype)
        w_all, errs = _dist_fits(shard_rows(v, mesh.data_group), ks_t, stack_draws([source(k, k_pad) for k in block]),
                                 k_pad, mesh.data_group, comm, nmf_iters)
        sc = _pooled_w_score(w_all, errs, ks_t, k_pad)
    if mesh is None:
        return sc
    # one gather of the three fields, at the widest field's dtype (exact: a
    # bf16 rel_error widens to float32 without rounding), each cast back
    wide = functools.reduce(torch.promote_types, (field.dtype for field in sc))
    gathered = ring_all_gather(torch.stack([field.to(wide) for field in sc], dim=1), mesh.lane_group)
    return NMFkScore(*(g.to(field.dtype) for g, field in zip(gathered.unbind(dim=1), sc)))


# ---------------------------------------------------------------------------
# elastic lanes: chunked convergence-gated fits with warm starts
# ---------------------------------------------------------------------------
# The elastic executor schedules fit-chunks, not whole fits: one lane is one
# perturbation fit of one k, advanced up to ``chunk`` MU sweeps a dispatch.
# These are the lane lifecycle's device steps: cold and warm init, the
# resumable chunk and the pooled-column score of a completed ensemble. A
# lane starts from its perturbed V (``_perturb(v, draws.noise[p])``, which
# the plane keeps per slot) and the unscaled init draws of its
# perturbation, so a cold lane that runs the whole sweep budget is
# draw-for-draw the batched plane's fit of the same (k, perturbation).


def _k_eff(k: int, like: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """k as an int64 tensor on ``like``'s device, made by a fill (a Python
    scalar handed to ``torch.as_tensor`` would be a copy from the host)."""
    return torch.full(shape, int(k), dtype=torch.long, device=like.device)


def elastic_lane_init(
    vp: torch.Tensor, k_eff: int, w_draw: torch.Tensor, h_draw: torch.Tensor, k_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cold lane init: the (W, H) a masked fit of the perturbed V ``vp``
    (n, m) from the init draws w_draw (n, k_pad) / h_draw (k_pad, m) starts
    from."""
    return _masked_init(vp, _k_eff(k_eff, vp), w_draw, h_draw, k_pad)


def elastic_lane_warm_init(
    vp: torch.Tensor,
    k_eff: int,
    w_draw: torch.Tensor,
    h_draw: torch.Tensor,
    w_src: torch.Tensor,
    k_src: int,
    k_pad: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warm lane init from a completed neighbor's W (n, k_pad) (cross-k
    warm start).

    The first ``min(k_eff, k_src)`` columns of the cold-draw W are replaced
    by the source fit's columns, L2-renormalized to the cold draw's column
    norms so the init's magnitude statistics (and the MU updates' scale
    balance against the fresh H) are preserved; extra columns (k_eff >
    k_src) and H keep their cold draws. Zero source columns fall back to
    the cold draw — a zeroed column is unrecoverable under Lee-Seung.
    """
    w0, h0 = elastic_lane_init(vp, k_eff, w_draw, h_draw, k_pad)
    take = torch.arange(k_pad, device=vp.device) < min(int(k_eff), int(k_src))
    src_norm = torch.linalg.vector_norm(w_src, dim=0, keepdim=True)
    unit = w_src / torch.clamp(src_norm, min=1e-12)
    tgt_norm = torch.linalg.vector_norm(w0, dim=0, keepdim=True)
    w = torch.where((take & (src_norm[0] > 1e-12))[None, :], unit * tgt_norm, w0)
    return w, h0


def elastic_chunk(
    vp: torch.Tensor,
    w: torch.Tensor,
    h: torch.Tensor,
    k_eff: torch.Tensor,
    steps: torch.Tensor,
    k_pad: int,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance a batch of lanes up to ``chunk`` masked MU sweeps.

    vp (L, n, m) / w (L, n, k_pad) / h (L, k_pad, m) / k_eff (L,) / steps
    (L,), all on one device. Lane i applies exactly ``steps[i] <= chunk``
    sweeps (a lane near its budget trims its last chunk; padding lanes take
    0 and come back unchanged); the gate stays on the device, so the chunk
    reads nothing back. Returns (w, h, rel_error (L,)), the error against
    each lane's own perturbed V: the convergence signal the tol gate tests
    on the host. vp, w and h share one dtype (the plane's V's).
    """
    _check_one_dtype(vp, w, h)
    return _masked_sweeps(vp, w, h, k_eff, k_pad, chunk, steps=steps)


def _check_one_dtype(vp: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> None:
    if not vp.dtype == w.dtype == h.dtype:
        raise TypeError(f"an elastic chunk takes vp, w and h of one dtype, got {vp.dtype}, {w.dtype}, {h.dtype}")


def elastic_chunk_sharded(
    vp: torch.Tensor,
    w: torch.Tensor,
    h: torch.Tensor,
    k_eff: torch.Tensor,
    steps: torch.Tensor,
    k_pad: int,
    chunk: int,
    data_group=None,
    comm: str = "sync",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``elastic_chunk`` of this rank's block of lanes on a ``(lane, data)``
    mesh.

    With one data shard (``data_group`` None or of one rank) the block is one
    batched ``elastic_chunk``. Otherwise vp (L, n_l, m) and w (L, n_l, k_pad)
    hold this rank's rows of each lane's perturbed V and W, h (L, k_pad, m)
    is replicated over the group, and the block runs as one batched
    ``_dnmf_masked_chunk_local`` over ``data_group``: each sweep's Gram sums
    (of every lane at once) and the residuals are all-reduced, so the
    returned rel_error is each whole lane's, equal on every rank of the
    group. vp, w and h share one dtype, as in ``elastic_chunk``.
    """
    from .distributed import _dnmf_masked_chunk_local, _world

    _check_one_dtype(vp, w, h)
    if _world(data_group) == 1:
        return elastic_chunk(vp, w, h, k_eff, steps, k_pad, chunk)
    return _dnmf_masked_chunk_local(vp, w, h, k_eff, k_pad, chunk, data_group, comm, steps)


def elastic_pooled_score(
    w_all: torch.Tensor, errs: torch.Tensor, k_eff: int, k_pad: int
) -> NMFkScore:
    """Score one k's completed lane ensemble: w_all (p, n, k_pad) raw W
    factors, errs (p,) rel errors; the pooled-column silhouette tail as one
    lane of ``_pooled_w_score``. Fields are 0-d tensors."""
    sc = _pooled_w_score(w_all[None], errs[None], _k_eff(k_eff, w_all, (1,)), k_pad)
    return NMFkScore(*(field[0] for field in sc))


def make_nmfk_evaluator(
    v: torch.Tensor,
    seed: int = 0,
    n_perturbs: int = 8,
    nmf_iters: int = 150,
    epsilon: float = 0.015,
    statistic: str = "min",
    draws: DrawSource | None = None,
) -> Callable[[int], float]:
    """Binary Bleed ``evaluate(k)`` closure over a dataset; draws at V's
    dtype by default."""
    if statistic not in ("min", "mean"):
        raise ValueError(f"statistic must be 'min' or 'mean', got {statistic!r}")
    n, m = v.shape
    source = draws if draws is not None else seeded_draws(seed, n, m, n_perturbs, epsilon, v.device, v.dtype)

    def evaluate(k: int, should_abort=None) -> float:
        del should_abort  # one fit per call: no chunk boundary to poll
        sc = nmfk_score(v, int(k), source(int(k), int(k)), nmf_iters=nmf_iters)
        return float(sc.min_silhouette if statistic == "min" else sc.mean_silhouette)

    return evaluate
