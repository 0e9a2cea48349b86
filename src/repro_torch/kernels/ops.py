"""Wrappers around the hand-written CUDA kernels.

The device decides the path: tensors on the CPU go to the plain PyTorch
version in ``ref``; tensors on one CUDA device go to the kernel, and
anything the kernel does not take raises. There is no fallback from the
kernel to the plain version. Every wrapper takes float32 and bfloat16,
each dtype through a kernel of its own (a bf16 tensor is never cast to
feed the float32 one). float16 is queued (ROADMAP Queue 2): it raises.
Each wrapper counts its kernel launches in a plain int attribute,
``<wrapper>.launches``, and its bf16 kernel's in
``<wrapper>.bf16_launches``, reported as ``<wrapper>[bf16]``
(``bf16_name``), so a run can show that its main path went through the
kernels (``reset_launch_counts`` zeroes them).

Unlike the TPU wrappers, nothing is padded here: the kernels mask ragged
edges themselves.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import math
import threading

import torch

from . import build, ref

# nmf_update.cu: ranks up to MU_TILED_MAX_RANK take the tiled, planned
# kernels; larger ranks the any-rank kernel (mu_update_*_any).
MU_TILED_MAX_RANK = 128  # kTiledMaxRank
# silhouette_sums.cu: up to this many points (y rows) take the thin path
# (the d reduction spread over a thread block cluster), more take the
# general path. Both take any k.
SILHOUETTE_THIN_POINTS = 128  # kThinMaxM
# pairwise_dist.cu: the thin path (every K-Means launch) takes m <= 64 and
# d <= 32; larger shapes take the general path, whose grid bounds m (32 y
# rows per block, 65535 blocks). Both bound the lanes: the general path's
# grid.z, the thin path's chunks of lanes on grid.y.
PAIRWISE_THIN_COLS = 64  # kThinMaxM
PAIRWISE_THIN_DIM = 32  # kThinMaxD
MAX_LANES = 65535
MAX_PAIRWISE_COLS = 65535 * 32  # kTileM y rows per block of the general path
MAX_HEAD_DIM = 128  # largest head dim the flash kernel takes (flash_attention.cu)
MAX_GRID_YZ = 65535  # grid limit on heads and batch (flash_attention.cu's split pass)

_count_lock = threading.Lock()


FLASH_BF16 = "flash_attention[bf16]"  # launch_counts' name of the bf16 flash kernel
QUEUED = "queued in ROADMAP Queue 2"


def _on_card(*tensors: torch.Tensor, kernels: str, contiguous: bool = True) -> bool:
    """False for all-CPU tensors (plain path); True for one CUDA device after
    checking what ``kernels`` take (float32 or bfloat16, all of one dtype;
    contiguous, or with ``contiguous=False`` unit stride along the last
    axis); raises for anything else."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors must all lie on the CPU or all on one CUDA device, got {devices}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernels} take float32 or bfloat16 tensors of one dtype, got "
                        f"{sorted(str(d) for d in dtypes)}; float16 is {QUEUED}")
    for t in tensors:
        if contiguous and not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if not contiguous and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError("the flash-attention kernel takes unit stride along the head dim")
    return True


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _count(wrapper, attr: str = "launches") -> None:
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lead3(*tensors: torch.Tensor) -> tuple[bool, list[torch.Tensor]]:
    """2-D operands become one-lane 3-D ones; returns (was_2d, operands)."""
    ndims = {t.dim() for t in tensors}
    if ndims == {2}:
        return True, [t.unsqueeze(0) for t in tensors]
    if ndims == {3}:
        return False, list(tensors)
    raise ValueError(f"expected all 2-D or all 3-D operands, got dims {sorted(ndims)}")


def _mu_shapes(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> tuple[int, int, int, int]:
    lanes, n, m = v.shape
    k = w.shape[-1]
    if w.shape != (lanes, n, k) or h.shape != (lanes, k, m):
        raise ValueError(f"MU shapes v {tuple(v.shape)}, w {tuple(w.shape)}, h {tuple(h.shape)} do not match")
    if min(n, m, k) < 1 or not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"the MU kernels take non-empty operands and 1..{MAX_LANES} lanes")
    return lanes, n, m, k


# -----------------------------------------------------------------------------
# NMF multiplicative updates (csrc/nmf_update.cu)
# -----------------------------------------------------------------------------
H100_SMS = 132  # streaming multiprocessors of an H100 SXM: the planner's default
# Persistent blocks of the MU kernels per SM: one fits (173 KB of shared
# memory for the H-update at KB = 16, nmf_update.cu mu_dynamic_smem).
MU_BLOCKS_PER_SM = 1
MU_H_COLS = 128  # columns of H per tile (nmf_update.cu kHCols)
MU_H_STAGE = 32  # rows of V per pipeline stage of the H kernel (kHRows)
MU_H_STAGE_BF16 = 64  # the same at bf16: 16 KB of V, as fp32's 32 rows (kHRowsBf16)
MU_W_STAGE = 64  # columns of V per pipeline stage of the W kernel (kWCols)
MU_W_STAGE_BF16 = 64  # the same at bf16: one 128-byte swizzled row of V (kWColsBf16)
MU_W_ROWS_BF16 = 128  # rows of W per tile of the bf16 W kernel, at every rank (kWRowsBf16)
# What finishing an item costs a block (park, sum, partials, epilogue), in
# stages: the planner's price for one more split.
MU_ITEM_COST = 1


def rank_bucket(k: int) -> int:
    """The tiled kernels' register tile is compiled for KB in (16, 32, 64, 128) >= k."""
    if not 1 <= k <= MU_TILED_MAX_RANK:
        raise ValueError(f"the tiled MU kernels take 1 <= k <= {MU_TILED_MAX_RANK}, got k={k}")
    return next(kb for kb in (16, 32, 64, MU_TILED_MAX_RANK) if k <= kb)


def mu_w_rows(k: int, elem: int = 4) -> int:
    """Rows of V and W per tile of the W kernel: 1024 / KB at fp32
    (nmf_update.cu WUpdate::kBN), ``MU_W_ROWS_BF16`` at every KB at bf16
    (``elem`` 2: 16 rows a math warp)."""
    kb = rank_bucket(k)
    return 1024 // kb if elem == 4 else MU_W_ROWS_BF16


@dataclasses.dataclass(frozen=True)
class MuPlan:
    """How one MU launch is cut. A unit is one output tile of one lane
    (``tiles`` per lane: column tiles of H, or row tiles of W). The first
    ``whole`` units are reduced (over n for H, over m for W) by one block
    each; every other unit is cut into ``split`` items, item s taking
    ``[s * chunk, min(length, (s + 1) * chunk))``, whose partials the last
    of their blocks adds up. ``blocks`` persistent blocks walk the
    ``items`` round-robin."""

    tiles: int
    units: int
    whole: int
    split: int
    chunk: int
    length: int  # the reduction's length: n for H, m for W
    items: int
    blocks: int
    scratch: tuple[int, ...]  # float32 partials (S, tail units, floats of a tile); () if none
    counters: int  # int32 arrival counters, one per tail unit, when the tail is split; else 0


@functools.lru_cache(maxsize=4096)
def _mu_plan(update: str, lanes: int, n: int, m: int, k: int, sms: int = H100_SMS, elem: int = 4) -> MuPlan:
    """Pick the cut that finishes soonest on ``sms`` SMs. Whole units fill
    ``rounds`` rounds of the persistent blocks; the remaining units are
    split so that their items fill the blocks once more. A round costs the
    stages of its items plus ``MU_ITEM_COST`` each. Every SM gets an item
    where the shape has enough of them; ties go to fewer items. ``elem``
    is V's element size: 4 (fp32), or 2 (bf16: the H-update's stages hold
    ``MU_H_STAGE_BF16`` rows, the W-update's tiles ``MU_W_ROWS_BF16`` rows
    and its stages ``MU_W_STAGE_BF16`` columns)."""
    if elem not in (4, 2):
        raise ValueError(f"elem must be 4 (float32) or 2 (bfloat16), got {elem}")
    if update == "h":
        tiles, length, stage = math.ceil(m / MU_H_COLS), n, MU_H_STAGE if elem == 4 else MU_H_STAGE_BF16
    elif update == "w":
        tiles, length, stage = math.ceil(n / mu_w_rows(k, elem)), m, MU_W_STAGE if elem == 4 else MU_W_STAGE_BF16
    else:
        raise ValueError(f"update must be 'h' or 'w', got {update!r}")
    units, slots, stages = tiles * lanes, MU_BLOCKS_PER_SM * sms, math.ceil(length / stage)
    best = None
    for rounds in range(units // slots + 1):
        whole = rounds * slots
        tail = units - whole
        for per in range(1, stages + 1) if tail else (stages,):  # stages a split item walks
            chunk = per * stage
            split = math.ceil(length / chunk) if tail else 1
            items = whole + tail * split
            cost = rounds * (stages + MU_ITEM_COST) + math.ceil(tail * split / slots) * (per + MU_ITEM_COST)
            key = (items < min(slots, units * stages), cost, items)
            if best is None or key < best[0]:
                best = (key, whole, split, chunk, items)
    _, whole, split, chunk, items = best
    if whole < units and split > 1:
        tile_floats = k * MU_H_COLS if update == "h" else mu_w_rows(k, elem) * k
        scratch, counters = (split, units - whole, tile_floats), units - whole
    else:
        scratch, counters = (), 0
    return MuPlan(tiles, units, whole, split, chunk, length, items, min(items, slots), scratch, counters)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_scratch = threading.local()


def _mu_scratch(device: torch.device, stream: int, n_part: int, n_count: int):
    """This thread's MU scratch for ``stream``: float32 partials and int32
    arrival counters, grown when a launch needs more and kept otherwise.

    Invariant: the counters are zero before every launch. They are zeroed
    when allocated, and a launch that runs to its end leaves them at zero
    (the last block of a split unit resets its counter). A launch that
    fails drops the thread's scratch (``_mu_launch``), so the next one
    allocates zeroed counters. Kept per thread and stream, so no two
    launches that may run at once share them."""
    bufs = _scratch.__dict__.setdefault("bufs", {})
    part, count = bufs.get((device, stream), (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, device=device, dtype=torch.float32)
    if count is None or count.numel() < n_count:
        count = torch.zeros(n_count, device=device, dtype=torch.int32)
    bufs[(device, stream)] = (part, count)
    return part, count


def _mu_args(update: str, device: torch.device, stream: int, lanes: int, n: int, m: int, k: int,
             elem: int = 4) -> tuple:
    """The C arguments of a launch after its five operands: scratch
    pointers, shape, plan and stream. Remembered per thread, so a repeated
    shape costs one dict lookup; each entry holds its scratch tensors, so
    a pointer stays valid after the scratch grows."""
    cache = _scratch.__dict__.setdefault("args", {})
    key = (update, device, stream, lanes, n, m, k, elem)
    hit = cache.get(key)
    if hit is None:
        plan = _mu_plan(update, lanes, n, m, k, _sm_count(device), elem)
        held = _mu_scratch(device, stream, math.prod(plan.scratch), plan.counters) if plan.counters else ()
        ptrs = tuple(t.data_ptr() for t in held) or (None, None)
        if len(cache) >= 1024:
            cache.clear()
        hit = cache[key] = (held, (*ptrs, lanes, n, m, k, plan.split, plan.chunk, plan.whole, plan.blocks, stream))
    return hit[1]


def _mu_launch(name: str, update: str, v3, a, b, gram, out) -> None:
    """Plan one MU launch, find its scratch and launch it: ``<name>`` at
    fp32, ``<name>_bf16`` at bf16. After a failed launch the thread's
    scratch is dropped: its counters may be nonzero. Ranks above
    ``MU_TILED_MAX_RANK`` go to the any-rank kernel (``..._any``), which
    takes no plan and no scratch."""
    lanes, n, m = v3.shape
    k = gram.shape[-1]
    elem = v3.element_size()
    name = name if elem == 4 else f"{name}_bf16"
    ptrs = (v3.data_ptr(), a.data_ptr(), b.data_ptr(), gram.data_ptr(), out.data_ptr())
    lib = build.load("nmf_update")
    if k > MU_TILED_MAX_RANK:
        _check(getattr(lib, f"{name}_any")(*ptrs, lanes, n, m, k, _stream(v3)), f"{name}_any")
        return
    rc = getattr(lib, name)(*ptrs, *_mu_args(update, v3.device, _stream(v3), lanes, n, m, k, elem))
    if rc != 0:
        _scratch.__dict__.clear()
    _check(rc, name)


def mu_update_h(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """H <- H * (W^T V) / (G H + 1e-9), G = W^T W; v (L, n, m) or (n, m).

    float32, or bfloat16 (G a bf16 product, the rest fp32, H's dtype out)."""
    if not _on_card(v, w, h, kernels="the MU kernels"):
        return ref.mu_update_h(v, w, h)
    was_2d, (v3, w3, h3) = _lead3(v, w, h)
    _mu_shapes(v3, w3, h3)
    g = torch.bmm(w3.transpose(1, 2), w3)
    out = torch.empty_like(h3)
    _mu_launch("mu_update_h", "h", v3, w3, h3, g, out)
    _count(mu_update_h, "bf16_launches" if h.dtype == torch.bfloat16 else "launches")
    return out[0] if was_2d else out


def mu_update_w(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """W <- W * (V H^T) / (W Q + 1e-9), Q = H H^T; v (L, n, m) or (n, m).

    float32, or bfloat16 (Q a bf16 product, the rest fp32, W's dtype out)."""
    if not _on_card(v, w, h, kernels="the MU kernels"):
        return ref.mu_update_w(v, w, h)
    was_2d, (v3, w3, h3) = _lead3(v, w, h)
    _mu_shapes(v3, w3, h3)
    q = torch.bmm(h3, h3.transpose(1, 2))
    out = torch.empty_like(w3)
    _mu_launch("mu_update_w", "w", v3, h3, w3, q, out)
    _count(mu_update_w, "bf16_launches" if w.dtype == torch.bfloat16 else "launches")
    return out[0] if was_2d else out


# -----------------------------------------------------------------------------
# Streaming silhouette distance sums (csrc/silhouette_sums.cu)
# -----------------------------------------------------------------------------
def _dist_sums_launch(x: torch.Tensor, y: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    b, n, d = x.shape
    _, m, k = onehot.shape
    if y.shape != (b, m, d) or onehot.shape[0] != b:
        raise ValueError(
            f"dist-sum shapes x {tuple(x.shape)}, y {tuple(y.shape)}, onehot {tuple(onehot.shape)} do not match"
        )
    if min(n, m, d, k) < 1 or not 1 <= b <= MAX_LANES:
        raise ValueError(f"the distance-sum kernel takes non-empty operands and 1..{MAX_LANES} lanes")
    out = torch.empty((b, n, k), device=x.device, dtype=torch.float32)  # fp32 at either dtype, as on the TPU
    name = "silhouette_dist_sums_bf16" if x.dtype == torch.bfloat16 else "silhouette_dist_sums"
    rc = getattr(build.load("silhouette_sums"), name)(
        x.data_ptr(), y.data_ptr(), onehot.data_ptr(), out.data_ptr(),
        b, n, m, d, k, _stream(x),
    )
    _check(rc, name)
    return out


def silhouette_dist_sums(
    x: torch.Tensor, onehot: torch.Tensor, y: torch.Tensor | None = None
) -> torch.Tensor:
    """(n, k) sums ``sqrt(pairwise(x, y)) @ onehot``; x (n, d), y (m, d) (default x), onehot (m, k).

    float32 or bfloat16 operands of one dtype; the sums are float32."""
    y = x if y is None else y
    if not _on_card(x, y, onehot, kernels="the silhouette kernels"):
        return ref.silhouette_dist_sums(x, onehot, y)
    if not x.dim() == y.dim() == onehot.dim() == 2:
        raise ValueError("silhouette_dist_sums takes 2-D operands; use the _batched entry for 3-D")
    out = _dist_sums_launch(x.unsqueeze(0), y.unsqueeze(0), onehot.unsqueeze(0))
    _count(silhouette_dist_sums, "bf16_launches" if x.dtype == torch.bfloat16 else "launches")
    return out[0]


def silhouette_dist_sums_batched(
    x: torch.Tensor, onehot: torch.Tensor, y: torch.Tensor | None = None
) -> torch.Tensor:
    """Leading-lane form: x (b, n, d), y (b, m, d) (default x), onehot (b, m, k) -> (b, n, k)."""
    y = x if y is None else y
    if not _on_card(x, y, onehot, kernels="the silhouette kernels"):
        return ref.silhouette_dist_sums(x, onehot, y)
    if not x.dim() == y.dim() == onehot.dim() == 3:
        raise ValueError("silhouette_dist_sums_batched takes 3-D operands")
    out = _dist_sums_launch(x, y, onehot)
    _count(silhouette_dist_sums_batched, "bf16_launches" if x.dtype == torch.bfloat16 else "launches")
    return out


# -----------------------------------------------------------------------------
# Pairwise squared distances (csrc/pairwise_dist.cu)
# -----------------------------------------------------------------------------
def _pairwise_launch(x: torch.Tensor, y: torch.Tensor, lanes: int) -> torch.Tensor:
    """out (lanes, n, m), float32 at either dtype (as on the TPU); a 2-D
    operand is shared by every lane (lane stride 0). bf16 operands go to
    ``pairwise_sq_dists_bf16``, which widens each element as it loads it."""
    n, d = x.shape[-2:]
    m = y.shape[-2]
    if y.shape[-1] != d or min(n, m, d) < 1:
        raise ValueError(f"pairwise shapes x {tuple(x.shape)}, y {tuple(y.shape)} do not match")
    if not 1 <= lanes <= MAX_LANES or m > MAX_PAIRWISE_COLS:
        raise ValueError(f"the pairwise kernel takes <= {MAX_LANES} lanes and m <= {MAX_PAIRWISE_COLS}")
    out = torch.empty((lanes, n, m), device=x.device, dtype=torch.float32)
    name = "pairwise_sq_dists_bf16" if x.dtype == torch.bfloat16 else "pairwise_sq_dists"
    rc = getattr(build.load("pairwise_dist"), name)(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), lanes, n, m, d,
        n * d if x.dim() == 3 else 0, m * d if y.dim() == 3 else 0, _stream(x),
    )
    _check(rc, name)
    return out


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """(n, m) ``max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)``; x (n, d), y (m, d) (default x).

    float32 or bfloat16 operands of one dtype; the distances are float32."""
    y = x if y is None else y
    if not _on_card(x, y, kernels="the pairwise kernels"):
        return ref.pairwise_sq_dists(x, y)
    if not x.dim() == y.dim() == 2:
        raise ValueError("pairwise_sq_dists takes 2-D operands; use the _batched entry for 3-D")
    out = _pairwise_launch(x, y, 1)
    _count(pairwise_sq_dists, "bf16_launches" if x.dtype == torch.bfloat16 else "launches")
    return out[0]


def pairwise_sq_dists_batched(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Leading-lane form -> (b, n, m): x (b, n, d), y (b, m, d) (default x).

    One operand may be 2-D, (n, d) or (m, d): it is shared by every lane and
    read once, never copied per lane.
    """
    y = x if y is None else y
    if not _on_card(x, y, kernels="the pairwise kernels"):
        return ref.pairwise_sq_dists(x, y)
    dims = (x.dim(), y.dim())
    if dims not in ((3, 3), (2, 3), (3, 2)) or (dims == (3, 3) and x.shape[0] != y.shape[0]):
        raise ValueError(
            f"pairwise_sq_dists_batched takes 3-D operands with one lane count (one may be 2-D), "
            f"got x {tuple(x.shape)}, y {tuple(y.shape)}"
        )
    out = _pairwise_launch(x, y, (x if x.dim() == 3 else y).shape[0])
    _count(pairwise_sq_dists_batched, "bf16_launches" if x.dtype == torch.bfloat16 else "launches")
    return out


# -----------------------------------------------------------------------------
# Flash attention (csrc/flash_attention.cu)
# -----------------------------------------------------------------------------
def flash_kv_tiles(q0: int, bq: int, bk: int, lq: int, lk: int, causal: bool, window: int | None,
                   q_offset: int = 0) -> tuple[int, int]:
    """The live kv tiles [lo, hi] of query rows [q0, min(q0 + bq, lq)), row i
    at position ``q_offset + i``: the tiles the kernel walks for one item
    (flash_attention.cu ``kv_tiles``)."""
    p0 = q_offset + q0
    lo = (p0 - window + 1) // bk if window and p0 - window + 1 > 0 else 0
    hi = (lk - 1) // bk
    if causal:
        hi = min(hi, (q_offset + min(q0 + bq, lq) - 1) // bk)
    return lo, hi


def flash_work_list(
    b: int, hq: int, hk: int, lq: int, lk: int, causal: bool, window: int | None, bq: int, bk: int, blocks: int,
    q_offset: int = 0,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The kernel's schedule: ``(offsets, items)``, block i walking
    ``items[offsets[i]:offsets[i + 1]]``. An item is one q tile of one
    (batch, query head), ``(b * Hq + h) * ceil(Lq / bq) + q tile``; its cost
    is its count of live kv tiles (at ``q_offset``). Items are dealt longest first, each to the
    block with the least work so far (ties: the lower block), so each block
    walks its items longest first. Equal lengths keep the query heads of one
    kv head and neighbouring q tiles together: blocks running at once read
    the same K/V tiles from L2."""
    qtiles = math.ceil(lq / bq)
    group = hq // hk
    costed = []
    for bi in range(b):
        for h in range(hq):
            for qt in range(qtiles):
                lo, hi = flash_kv_tiles(qt * bq, bq, bk, lq, lk, causal, window, q_offset)
                costed.append((-(hi - lo + 1), bi, h // group, qt, h, (bi * hq + h) * qtiles + qt))
    costed.sort()
    if len(costed) >= 2**31:
        raise ValueError("the flash-attention work list exceeds int32 items")
    blocks = min(blocks, len(costed))
    loads = [(0, i) for i in range(blocks)]
    per_block: list[list[int]] = [[] for _ in range(blocks)]
    for neg_cost, *_, item in costed:
        load, i = heapq.heappop(loads)
        per_block[i].append(item)
        heapq.heappush(loads, (load - neg_cost, i))
    offsets = [0]
    for items in per_block:
        offsets.append(offsets[-1] + len(items))
    return tuple(offsets), tuple(item for items in per_block for item in items)


_flash_work_cache: dict = {}


def _flash_launch(q, k, v, out, scale: float, causal: bool, window: int | None, q_offset: int = 0) -> None:
    """Launch the kernel of q's dtype: ``flash_attention`` at fp32 (its K/V
    split images are scratch from ``torch.empty``), ``flash_attention_bf16``
    at bf16 (no scratch). Each takes its own tiles from the library
    (``flash_tiles``), and its work list is copied to the device once per
    shape and tiles."""
    b, hq, lq, d = q.shape
    _, hk, lk, _ = k.shape
    bf16 = q.dtype == torch.bfloat16
    lib = build.load("flash_attention")
    dp, bk, bq = (lib.flash_tiles(d, field, int(bf16)) for field in range(3))
    key = (q.device, b, hq, hk, lq, lk, causal, window, bq, bk, q_offset)
    hit = _flash_work_cache.get(key)
    if hit is None:
        offsets, items = flash_work_list(*key[1:-1], _sm_count(q.device), q_offset)
        if len(_flash_work_cache) >= 256:
            _flash_work_cache.clear()
        tensor = torch.tensor(offsets + items, dtype=torch.int32, device=q.device)
        hit = _flash_work_cache[key] = (tensor, len(offsets) - 1)
    work, blocks = hit
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    tail = (b, hq, hk, lq, lk, d, *strides, scale, int(causal), window or 0, q_offset, _stream(q))
    if bf16:
        rc = lib.flash_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), work.data_ptr(),
                                      blocks, *tail)
        _check(rc, "flash_attention_bf16")
        return
    image = b * hk * math.ceil(lk / bk) * bk * dp * 2  # floats of the K (and of the V) image
    images = torch.empty(2 * image, device=q.device, dtype=torch.float32)
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), images.data_ptr(), images.data_ptr() + 4 * image,
        work.data_ptr(), blocks, *tail,
    )
    _check(rc, "flash_attention")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int | None = None,
) -> torch.Tensor:
    """Causal/windowed GQA softmax attention: q (B, Hq, Lq, D), k and v (B, Hk, Lk, D)
    -> (B, Hq, Lq, D); query head h reads kv head ``h // (Hq // Hk)``.

    ``scale`` defaults to D^-0.5 and multiplies q.k. Query row i is position
    ``q_offset + i`` (key j is live iff j <= q_offset + i when causal, and
    q_offset + i - j < window with a window), which causal or windowed
    attention takes with Lq + q_offset <= Lk, and must name where Lq != Lk
    (``ref.query_offset``; 0 by default otherwise): at 0 and Lq == Lk the TPU
    kernel's case, at r·L/m one rank's query block of a sequence-parallel
    prefill against the whole sequence's keys. On the card the operands may be strided views (unit stride along
    D); the output has q's layout and dtype. q, k and v are float32 (the
    split-TF32 kernel) or bfloat16 (the bf16 kernel: fp32 scores, softmax
    and sums, bf16 out, as the TPU kernel's bf16 half), all of one dtype;
    float16 raises. The kernels have no backward, so on the card the
    wrapper raises when grad mode is on and an operand requires grad.
    """
    if not q.dim() == k.dim() == v.dim() == 4:
        raise ValueError("flash_attention takes 4-D (B, H, L, D) operands")
    b, hq, lq, d = q.shape
    _, hk, lk, _ = k.shape
    if k.shape[0] != b or k.shape[-1] != d or v.shape != k.shape or hk < 1 or hq % hk != 0:
        raise ValueError(
            f"flash_attention shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match "
            "(B, Hq, Lq, D), (B, Hk, Lk, D) with Hq % Hk == 0"
        )
    q_offset = ref.query_offset(lq, lk, causal, window, q_offset)
    if q_offset < 0 or ((causal or window is not None) and lq + q_offset > lk):
        raise ValueError(f"causal or windowed flash_attention takes Lq + q_offset <= Lk (q_offset >= 0), got "
                         f"Lq={lq}, q_offset={q_offset}, Lk={lk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = float(scale if scale is not None else d**-0.5)
    if not _on_card(q, k, v, contiguous=False, kernels="the flash-attention kernels"):
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale, q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel has no backward: its output would drop the gradients of q, k "
            "and v; train through the plain attention (models.attention.gqa_forward) or call it "
            "under torch.no_grad()"
        )
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash-attention kernel takes head dim 1..{MAX_HEAD_DIM}, got {d}")
    if min(b, lq, lk) < 1 or max(b, hq) > MAX_GRID_YZ:
        raise ValueError(f"the flash-attention kernel takes 1 <= B, Hq <= {MAX_GRID_YZ} and non-empty L")
    out = torch.empty_like(q)  # q's layout when q is dense (a transposed view included)
    _flash_launch(q, k, v, out, scale, causal, window, q_offset)
    _count(flash_attention, "bf16_launches" if q.dtype == torch.bfloat16 else "launches")
    return out


KERNEL_WRAPPERS = (
    mu_update_h, mu_update_w, silhouette_dist_sums, silhouette_dist_sums_batched,
    pairwise_sq_dists, pairwise_sq_dists_batched, flash_attention,
)


def bf16_name(wrapper) -> str:
    """``launch_counts``' name of a wrapper's bf16 kernel, e.g. ``mu_update_h[bf16]``."""
    return f"{wrapper.__name__}[bf16]"


def reset_launch_counts() -> None:
    with _count_lock:
        for wrapper in KERNEL_WRAPPERS:
            wrapper.launches = wrapper.bf16_launches = 0


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    """{wrapper name: launches}, and each bf16 kernel's under ``bf16_name``
    (flash attention's is ``FLASH_BF16``)."""
    with _count_lock:
        return {**{wrapper.__name__: wrapper.launches for wrapper in KERNEL_WRAPPERS},
                **{bf16_name(wrapper): wrapper.bf16_launches for wrapper in KERNEL_WRAPPERS}}
