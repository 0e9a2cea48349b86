"""Distributed NMF / RESCAL on ``torch.distributed`` — the paper's pyDNMFk/pyDRESCALk.

The paper's *distributed* mode: one k evaluation is too big for a node, so
the factorization itself is sharded. Each function here is the body one
rank runs on its own row block, with a process group for the collectives:

    V row-sharded over the group; W row-sharded; H replicated.
      H-update:  all_reduce(W_l^T V_l) (k×m),  all_reduce(W_l^T W_l) (k×k)
      W-update:  purely local (H replicated ⇒ H H^T local)

RESCAL adds an all-gather of the entity factor A (n×k) per sweep.

``group=None`` is one rank: every collective is the identity (the
reference's ``axis_size == 1``). Otherwise the backend follows the tensors'
device and is checked, never switched: NCCL for CUDA tensors, gloo for CPU
tensors; a group whose backend does not match raises. A rank's index is
``dist.get_rank(group)``, and its rows are the index-th of ``world`` equal
blocks.

Two communication schedules for the MU sweeps (``comm=``):

  * ``"sync"`` — each sweep blocks on the two Gram all-reduces before any
    factor update (the textbook pyDNMFk order).
  * ``"pipelined"`` — both Grams fused into one buffer, reduce-scattered
    with ``async_op=True``; the purely-local W-update runs with a
    **one-sweep-stale H** while the reduction is in flight, then the
    scattered chunks are gathered and the H-update finishes. A closing
    synchronous sweep restores the coupled update before the residual is
    measured. At one rank there is nothing to overlap and the schedule is
    the sync one, bit for bit.

On the card the W-update (``w * (v Hᵀ) / (w H Hᵀ + eps)``, then the mask)
is the hand-written MU kernel (``kernels.ops.mu_update_w``); the
H-update's numerator must be all-reduced before its division, so it stays
a plain matmul plus ``all_reduce``.

Init draws are injected: a fit takes the full-shape unscaled draws (W or A
(n, k), H (k, m) or R (nr, k, k)) and keeps its own rank's rows, so the
concatenation over ranks is the single-device draw.

The fits run at V's (or X's) dtype, float32 or bfloat16, with the draws at
that dtype (``check_fit_dtype``: another dtype raises ``TypeError``;
float16 is queued). At bf16 the W-update is the MU kernel's bf16 half, and
each rank forms its Grams, V's sum and the residual sums at float32 from
its bf16 operands (the sums the one-card fit forms, split over the ranks'
rows); the H-update takes the H kernel's arithmetic from them (G rounded
once to bf16, the rest float32, one rounding), so at one rank it is the
one-card fit's. Every sum over ranks (those, the pipelined schedule's
reduce-scatter and gather, RESCAL's all-reduces of its bf16 products)
travels at float32 (``wire_dtype``) and is rounded once, so no backend's
bf16 summation order enters the result. The all-gathers (A, the W rows)
move values, not sums, at the operands' dtype.
"""
from __future__ import annotations

import contextlib
import tempfile
from pathlib import Path
from typing import Iterator, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kernel_ops
from repro_torch.random import check_draws

from .nmf import _active
from .rescal import _gram_sandwich, _xa

COMM_MODES = ("sync", "pipelined")
_EPS = 1e-9

# ``reduce_scatter_tensor`` / ``all_gather_into_tensor`` were renamed to
# ``*_single`` in newer torch (the old names warn there); the same op either way.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def backend_for(device: torch.device | str) -> str:
    """The process-group backend of a device type: NCCL on CUDA, gloo on the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def check_group(group, *tensors: torch.Tensor) -> None:
    """Raise unless ``group``'s backend is the one for the tensors' device
    (``group=None`` takes any single device)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"a distributed fit takes tensors on one device, got {devices}")
    if group is None:
        return
    want = backend_for(next(iter(devices)))
    got = str(dist.get_backend(group))
    if got != want:
        raise ValueError(f"tensors on {next(iter(devices))} need a {want} group, got a {got} group")


def check_fit_dtype(what: str, x: torch.Tensor, draws, name: str = "V") -> None:
    """Raise ``TypeError`` unless the draws have the data's dtype
    (``random.check_draws``: a float32 draw would promote a bf16 fit) and
    that dtype is not float16, which is queued in ROADMAP Queue 2 item 4."""
    if x.dtype == torch.float16:
        raise TypeError(f"{what} takes float32 or bfloat16 operands, got torch.float16; float16 is queued in "
                        f"ROADMAP Queue 2 item 4")
    check_draws(x, draws, name)


def wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum over ranks travels at: float32 for bf16 operands (one
    rounding back to bf16 at the end, in any rank count and backend), the
    operands' own dtype at float32 and above."""
    return torch.promote_types(dtype, torch.float32)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group (``x`` is overwritten and returned),
    carried at ``wire_dtype`` and rounded once to x's dtype."""
    if _world(group) > 1:
        wide = x.to(wire_dtype(x.dtype))
        dist.all_reduce(wide, group=group)
        if wide is not x:
            x.copy_(wide)
    return x


def check_comm(comm: str) -> None:
    """Raise unless ``comm`` is one of ``COMM_MODES``."""
    if comm not in COMM_MODES:
        raise ValueError(f"comm must be one of {COMM_MODES}, got {comm!r}")


def check_rows(v: torch.Tensor, data_count: int) -> None:
    """Raise unless V's rows split into ``data_count`` equal blocks."""
    if data_count > 1 and v.shape[0] % data_count:
        raise ValueError(f"v rows {v.shape[0]} not divisible by data-axis size {data_count}")


def shard_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``world`` equal blocks)."""
    world = _world(group)
    if x.shape[dim] % world:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split into {world} equal blocks")
    rows = x.shape[dim] // world
    return x.narrow(dim, _rank(group) * rows, rows).contiguous()


# ---------------------------------------------------------------------------
# ring collectives: all-reduce decomposed into reduce-scatter + gather
# ---------------------------------------------------------------------------
def ring_all_gather(x: torch.Tensor, group, use_ppermute: bool = False) -> torch.Tensor:
    """All-gather ``x`` (this rank's chunk) along dim 0 over ``group``.

    ``use_ppermute=True`` spells the gather as an explicit (world - 1)-step
    ring of point-to-point transfers — the schedule pyDNMFk's custom
    communicators build by hand; each step posts its send to the next rank
    and its receive from the previous one in one batch. The default is one
    ``all_gather`` call; both give identical values.
    """
    world = _world(group)
    if world == 1:
        return x
    x = x.contiguous()
    chunk = x.shape[0]
    out = torch.empty((world * chunk,) + x.shape[1:], dtype=x.dtype, device=x.device)
    if not use_ppermute:
        _all_gather(out, x, group=group)
        return out
    idx = _rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % world)
    prv = dist.get_global_rank(group, (idx - 1) % world)
    out[idx * chunk:(idx + 1) * chunk] = x
    buf = x
    for step in range(1, world):
        recv = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, buf, nxt, group), dist.P2POp(dist.irecv, recv, prv, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        src = (idx - step) % world
        out[src * chunk:(src + 1) * chunk] = recv
        buf = recv
    return out


def ring_psum_start(x: torch.Tensor, group, async_op: bool = False):
    """First half of a decomposed all-reduce: reduce-scatter ``x`` along dim 0.

    Pads the leading dim to a multiple of the world size (Gram matrices are
    k-leading; k need not divide the rank count) and returns this rank's
    reduced chunk, the original leading extent and, with ``async_op``, the
    in-flight work (else None). Everything between ``ring_psum_start`` and
    ``ring_psum_finish`` may run while the collective is in flight.
    """
    world = _world(group)
    lead = x.shape[0]
    if world == 1:
        return x, lead, None
    pad = (-lead) % world
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)
    x = x.contiguous()
    shard = torch.empty((x.shape[0] // world,) + x.shape[1:], dtype=x.dtype, device=x.device)
    work = _reduce_scatter(shard, x, group=group, async_op=async_op)
    return shard, lead, work


def ring_psum_finish(shard: torch.Tensor, lead: int, group, use_ppermute: bool = False, work=None) -> torch.Tensor:
    """Second half of a decomposed all-reduce: wait for the reduce-scatter
    (``work``, if it was started asynchronously) and gather the chunks."""
    if work is not None:
        work.wait()
    if _world(group) == 1:
        return shard
    full = ring_all_gather(shard, group, use_ppermute=use_ppermute)
    return full[:lead] if full.shape[0] != lead else full


def ring_psum(x: torch.Tensor, group, use_ppermute: bool = False) -> torch.Tensor:
    """All-reduce decomposed into reduce-scatter + ring all-gather.

    Identical result up to float reduction order; the two-phase form is
    what the pipelined MU schedule interleaves compute into.
    """
    shard, lead, _ = ring_psum_start(x, group)
    return ring_psum_finish(shard, lead, group, use_ppermute=use_ppermute)


def overlap_model(
    n_total: int,
    m: int,
    k_pad: int,
    data: int,
    machine_balance: float = 8.0,
) -> dict:
    """Analytic comm/compute model of one pipelined MU sweep per rank.

    The ring moves ``2 (p-1)/p`` of the fused Gram buffer (reduce-scatter +
    all-gather) while the local stale-H W-update runs; ``machine_balance``
    converts moved elements into flop-equivalents (flops the machine
    executes in the time one element crosses the interconnect — a roofline
    balance knob, default representative of a CPU/Ethernet-class ratio).

    Returns ``overlap_fraction`` (share of comm hidden behind the W-update),
    ``comm_fraction`` (comm share of the *sync* sweep), and the modeled
    pipelined-vs-sync ``speedup``. All quantities are per sweep; with
    ``data == 1`` there is no communication and every field degenerates to
    the no-op values.
    """
    if data <= 1:
        return {
            "overlap_fraction": 0.0,
            "comm_fraction": 0.0,
            "speedup": 1.0,
            "comm_flop_equiv": 0.0,
            "local_flops": 0.0,
        }
    n_l = n_total / data
    gram_elems = k_pad * (m + k_pad)
    comm_elems = 2.0 * (data - 1) / data * gram_elems
    comm_cost = comm_elems * machine_balance  # flop-equivalents
    # local work available to hide the in-flight ring: the W-update
    w_update_flops = 2.0 * n_l * m * k_pad + 2.0 * k_pad * k_pad * (m + n_l)
    # rest of the sweep: Gram products + H-update
    gram_flops = 2.0 * n_l * (m + k_pad) * k_pad
    h_update_flops = 2.0 * k_pad * k_pad * m
    compute = w_update_flops + gram_flops + h_update_flops
    overlap = min(w_update_flops, comm_cost) / comm_cost
    t_sync = compute + comm_cost
    t_pipe = compute + comm_cost * (1.0 - overlap)
    return {
        "overlap_fraction": overlap,
        "comm_fraction": comm_cost / t_sync,
        "speedup": t_sync / t_pipe,
        "comm_flop_equiv": comm_cost,
        "local_flops": w_update_flops,
    }


class DistNMFResult(NamedTuple):
    w: torch.Tensor  # (n_local, k): this rank's rows
    h: torch.Tensor  # (k, m) replicated
    rel_error: torch.Tensor  # global ||V - WH||_F / ||V||_F


def _mu_sweeps(
    v_l: torch.Tensor,
    w_l: torch.Tensor,
    h: torch.Tensor,
    active: torch.Tensor | None,
    iters: int,
    group,
    comm: str,
    steps: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``iters`` multiplicative-update sweeps under the chosen schedule.

    The factors may carry a leading fit axis (v_l (B, n_l, m), w_l (B, n_l,
    k), h (B, k, m)): every collective of a sweep then carries all B fits
    at once, and the W-update is one MU launch of B lanes. ``active`` is the
    (k_pad,) or (B, k_pad) float rank mask of the masked fits (None for the
    unmasked path). ``"sync"`` blocks both factor updates on the Gram
    all-reduces; ``"pipelined"`` fuses the two Grams into one ``(k, m+k)``
    buffer, starts its reduce-scatter asynchronously, runs the local
    W-update with the previous sweep's H while it is in flight, then
    gathers and finishes the H-update — a one-sweep-stale schedule closed
    by one synchronous sweep so the measured residual comes from a coupled
    (W, H) pair.

    ``steps`` (a 0-d or (B,) tensor on the fit's device) gates sweeps inside
    the fixed ``iters`` loop: sweep s applies to a fit only while ``s <
    steps``, with no read back to the host. With ``steps < iters`` under
    ``"pipelined"`` the closing synchronous sweep is gated off too.
    """
    check_comm(comm)
    m = v_l.shape[-1]
    wide = wire_dtype(v_l.dtype)

    def mask_h(h):
        return h if active is None else h * active[..., :, None]

    def mask_w(w):
        return w if active is None else w * active[..., None, :]

    def h_update(h, wtv, wtw):
        # the H kernel's arithmetic from the summed Grams: G = W^T W rounded
        # once to H's dtype, the rest at the wire dtype, rounded once (at
        # float32: the plain expression)
        g, hw = wtw.to(h.dtype).to(wide), h.to(wide)
        return mask_h((hw * wtv / (g @ hw + _EPS)).to(h.dtype))

    def sync_sweep(w_l, h):
        # this rank's Grams at the wire dtype (from bf16 operands: the sums the
        # one-card fit forms, split over the ranks' rows)
        wt = w_l.transpose(-1, -2).to(wide)
        wtv = _all_reduce(wt @ v_l.to(wide), group)  # (k, m): the pyDNMFk all-reduce
        wtw = _all_reduce(wt @ w_l.to(wide), group)  # (k, k)
        h = h_update(h, wtv, wtw)
        w_l = mask_w(kernel_ops.mu_update_w(v_l, w_l, h))  # local: H replicated
        return w_l, h

    def pipe_sweep(w_l, h):
        # fused Gram: one scatter+gather pair in flight instead of two all-reduces
        gram = w_l.transpose(-1, -2).to(wide) @ torch.cat([v_l, w_l], dim=-1).to(wide)  # (k, m + k)
        # scattered over every fit's k rows at once
        shard, lead, work = ring_psum_start(gram.reshape(-1, gram.shape[-1]), group, async_op=True)
        # overlapped: the purely-local W-update with the stale (this sweep's input) H
        w_new = mask_w(kernel_ops.mu_update_w(v_l, w_l, h))
        full = ring_psum_finish(shard, lead, group, work=work).reshape(gram.shape)
        h_new = h_update(h, full[..., :m], full[..., m:])
        return w_new, h_new

    def gated(s, w_l, h, sweep):
        w_new, h_new = sweep(w_l, h)
        if steps is None:
            return w_new, h_new
        live = (s < steps)[..., None, None]
        return torch.where(live, w_new, w_l), torch.where(live, h_new, h)

    if comm == "sync" or _world(group) == 1 or iters == 0:
        for s in range(iters):
            w_l, h = gated(s, w_l, h, sync_sweep)
        return w_l, h
    for s in range(iters - 1):
        w_l, h = gated(s, w_l, h, pipe_sweep)
    return gated(iters - 1, w_l, h, sync_sweep)


def _global_rel_error(sq: torch.Tensor, ref_sq: torch.Tensor, group, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(Σ sq) / max(sqrt(Σ ref_sq), eps) over the group, one all-reduce
    (sq and ref_sq 0-d, or (B,) for B fits, at the wire dtype), rounded
    once to ``dtype``."""
    both = _all_reduce(torch.stack([sq, ref_sq]), group)
    return (torch.sqrt(both[0]) / torch.clamp(torch.sqrt(both[1]), min=_EPS)).to(dtype)


def _rows(draw: torch.Tensor, n_l: int, group) -> torch.Tensor:
    """This rank's n_l rows (dim -2) of a full-shape draw (world · n_l rows)."""
    if draw.shape[-2] != _world(group) * n_l:
        raise ValueError(f"a draw of {draw.shape[-2]} rows does not match {_world(group)} ranks of {n_l} rows")
    return draw[..., _rank(group) * n_l:(_rank(group) + 1) * n_l, :]


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ x² of each fit at the wire dtype: 0-d for (n, m), (B,) for (B, n, m)."""
    return x.to(wire_dtype(x.dtype)).square().sum(dim=(-2, -1))


def _dnmf_local(
    v_l: torch.Tensor,
    k: int,
    w_draw: torch.Tensor,
    h_draw: torch.Tensor,
    iters: int,
    group,
    comm: str = "sync",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-rank NMF body. v_l (n_local, m); w_draw (n, k) full, h_draw (k, m)."""
    n_l, _ = v_l.shape
    v_mean = (_all_reduce(v_l.to(wire_dtype(v_l.dtype)).mean(), group) / _world(group)).to(v_l.dtype)
    scale = torch.sqrt(torch.clamp(v_mean, min=_EPS) / k)
    w_l = scale * _rows(w_draw, n_l, group)
    h = scale * h_draw
    w_l, h = _mu_sweeps(v_l, w_l, h, None, iters, group, comm)
    wide = wire_dtype(v_l.dtype)
    err = _global_rel_error((v_l - w_l @ h).to(wide).square().sum(), v_l.to(wide).square().sum(), group, v_l.dtype)
    return w_l, h, err


def distributed_nmf(
    v_l: torch.Tensor,
    k: int,
    w_draw: torch.Tensor,
    h_draw: torch.Tensor,
    group=None,
    iters: int = 200,
    comm: str = "sync",
) -> DistNMFResult:
    """Row-distributed NMF: this rank's rows v_l of V over ``group``.

    ``w_draw`` (n, k) and ``h_draw`` (k, m) are the full unscaled init
    draws; the result holds this rank's W rows, the replicated H and the
    global relative error. ``comm="pipelined"`` overlaps the Gram
    reductions with the local W-update (see the module docstring).
    """
    check_group(group, v_l, w_draw, h_draw)
    check_fit_dtype("distributed_nmf", v_l, (w_draw, h_draw))
    return DistNMFResult(*_dnmf_local(v_l, k, w_draw, h_draw, iters, group, comm))


class DistRESCALResult(NamedTuple):
    a: torch.Tensor  # (n_local, k): this rank's entity rows
    r: torch.Tensor  # (nr, k, k) replicated
    rel_error: torch.Tensor


def _drescal_local(
    x_l: torch.Tensor, k: int, a_draw: torch.Tensor, r_draw: torch.Tensor, iters: int, group
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-rank RESCAL body. x_l (nr, n_local, n): entity-row sharded;
    a_draw (n, k) full, r_draw (nr, k, k)."""
    nr, n_l, _ = x_l.shape
    lo = _rank(group) * n_l
    wide = wire_dtype(x_l.dtype)
    x_mean = (_all_reduce(x_l.to(wide).mean(), group) / _world(group)).to(x_l.dtype)
    scale = torch.sqrt(torch.clamp(x_mean, min=_EPS)) / k
    a_l = scale * _rows(a_draw, n_l, group)
    r = scale * r_draw
    xt_l = x_l.transpose(-1, -2)  # (nr, n, n_l) view
    for _ in range(iters):
        a_full = ring_all_gather(a_l, group)  # (n, k)
        ata = _all_reduce(a_l.T @ a_l, group)  # (k, k)
        # A-update numerator, local rows: X_r A R_r^T + (X_r^T A R_r) rows,
        # X_r^T A summed over the ranks' row blocks
        xar = (_xa(x_l, a_full) @ r.transpose(-1, -2)).sum(dim=0)
        xt_a = _all_reduce(xt_l @ a_l, group)  # (nr, n, k) = X_r^T A
        xar2 = (xt_a[:, lo:lo + n_l] @ r).sum(dim=0)
        den = a_l @ _gram_sandwich(ata, r)
        a_l = a_l * (xar + xar2) / (den + _EPS)
        # R-update
        ata = _all_reduce(a_l.T @ a_l, group)
        a_full = ring_all_gather(a_l, group)
        atxa = _all_reduce(a_l.T @ _xa(x_l, a_full), group)  # (nr, k, k)
        r = r * atxa / (ata @ r @ ata + _EPS)
    a_full_t = ring_all_gather(a_l, group).T
    sq = x_l.new_zeros((), dtype=wide)
    for i in range(nr):  # one (n_local, n) residual at a time
        sq = sq + (x_l[i] - a_l @ r[i] @ a_full_t).to(wide).square().sum()
    err = _global_rel_error(sq, x_l.to(wide).square().sum(), group, x_l.dtype)
    return a_l, r, err


def distributed_rescal(
    x_l: torch.Tensor,
    k: int,
    a_draw: torch.Tensor,
    r_draw: torch.Tensor,
    group=None,
    iters: int = 150,
) -> DistRESCALResult:
    """Entity-row-distributed RESCAL: this rank's rows x_l (nr, n_local, n)
    of X over ``group``, from the full unscaled draws a_draw (n, k) and
    r_draw (nr, k, k)."""
    check_group(group, x_l, a_draw, r_draw)
    check_fit_dtype("distributed_rescal", x_l, (a_draw, r_draw), "X")
    return DistRESCALResult(*_drescal_local(x_l, k, a_draw, r_draw, iters, group))


def _dnmf_masked_local(
    v_l: torch.Tensor,
    k_eff,
    w_draw: torch.Tensor,
    h_draw: torch.Tensor,
    k_pad: int,
    iters: int,
    group,
    comm: str = "sync",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-rank *masked* NMF body: ``_nmf_masked`` distributed over ``group``.

    Same all-reduce structure as ``_dnmf_local``, but draw-compatible with
    the single-device masked fit: ``w_draw`` (n, k_pad) and ``h_draw``
    (k_pad, m) are the full-shape draws ``_nmf_masked`` takes, and each rank
    keeps its rows of W. With ``comm="sync"`` the result matches
    ``_nmf_masked(v, k_eff, w_draw, h_draw, k_pad, iters)`` up to float
    reduction order.

    With a leading fit axis (v_l (B, n_l, m), k_eff (B,), w_draw (B, n,
    k_pad), h_draw (B, k_pad, m)) the B fits run together: each collective
    of a sweep carries all of them (the reference's vmap over fits).

    Returns (w_l, rel_error), rel_error the global ||V - WH||_F / ||V||_F.
    """
    check_group(group, v_l, w_draw, h_draw)
    check_fit_dtype("_dnmf_masked_local", v_l, (w_draw, h_draw))
    n_l, m = v_l.shape[-2:]
    n_total = _world(group) * n_l
    active = _active(k_eff, k_pad, v_l)
    v_mean = (_all_reduce(v_l.to(wire_dtype(v_l.dtype)).sum(dim=(-2, -1)), group) / (n_total * m)).to(v_l.dtype)
    scale = torch.sqrt(torch.clamp(v_mean, min=_EPS) / torch.as_tensor(k_eff, device=v_l.device))[..., None, None]
    w_l = (scale * _rows(w_draw, n_l, group)) * active[..., None, :]
    h = (scale * h_draw) * active[..., :, None]
    w_l, h = _mu_sweeps(v_l, w_l, h, active, iters, group, comm)
    err = _global_rel_error(_sq_sum(v_l - w_l @ h), _sq_sum(v_l), group, v_l.dtype)
    return w_l, err


def _dnmf_masked_chunk_local(
    v_l: torch.Tensor,
    w_l: torch.Tensor,
    h: torch.Tensor,
    k_eff,
    k_pad: int,
    chunk: int,
    group,
    comm: str = "sync",
    steps: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resumable chunk of a masked row-sharded fit: ``chunk`` MU sweeps
    (gated to ``steps`` when given) plus the *global* rel_error.

    The elastic executor's convergence gate under data sharding: the
    residual is assembled from per-rank squared sums with one extra scalar
    all-reduce — no gather of V or W. ``comm="pipelined"`` runs the
    one-sweep-stale schedule within the chunk (closed by one synchronous
    sweep, like a short ``_mu_sweeps`` run).

    v_l (n_local, m) row block; w_l (n_local, k_pad) local rows; h
    replicated. With a leading fit axis (k_eff and steps (B,)) the B fits
    share each sweep's collectives. Returns (w_l, h, rel_error).
    """
    check_group(group, v_l, w_l, h)
    check_fit_dtype("_dnmf_masked_chunk_local", v_l, (w_l, h))
    active = _active(k_eff, k_pad, v_l)
    w_l, h = _mu_sweeps(v_l, w_l, h, active, chunk, group, comm, steps=steps)
    err = _global_rel_error(_sq_sum(v_l - w_l @ h), _sq_sum(v_l), group, v_l.dtype)
    return w_l, h, err


@contextlib.contextmanager
def local_groups(device: torch.device | str, count: int = 1) -> Iterator[list]:
    """``count`` one-rank process groups on ``device``'s backend (NCCL on
    CUDA, gloo on the CPU): the counterpart of the reference's one-device
    local mesh, for a single-process launch.

    Makes a one-rank default group first if none exists, from a ``file://``
    store in a temporary directory, and destroys it (with every group) on
    exit; a default group of more ranks raises. Groups are made here, in
    the calling thread, before workers use them.
    """
    backend = backend_for(device)
    store = None
    if not dist.is_initialized():
        store = tempfile.TemporaryDirectory(prefix="repro_torch_pg_")
        dist.init_process_group(backend, init_method=(Path(store.name) / "store").as_uri(),
                                world_size=1, rank=0)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"local_groups takes a one-rank launch; the default group has "
                           f"{dist.get_world_size()} ranks")
    try:
        groups = [dist.new_group([0], backend=backend) for _ in range(count)]
        try:
            yield groups
        finally:
            if store is None:
                for group in groups:
                    dist.destroy_process_group(group)
    finally:
        if store is not None:
            dist.destroy_process_group()
            store.cleanup()
