"""Attention mixers: GQA (+RoPE, sliding window, QKV bias) and DeepSeek-V2
MLA (multi-head latent attention), full-sequence, prefill and KV-cache
decode paths.

The serve prefill (``gqa_prefill``) runs the hand-written flash-attention
kernel (``kernels.ops.flash_attention``) on a CUDA tensor and the plain
``_sdpa_auto`` on a CPU tensor. ``gqa_forward``, the full-sequence forward
that training takes, runs ``_sdpa_auto`` on every device, as the
reference's default ``use_flash=False`` does: the kernel has no backward.
Decode attends one query row against the masked cache with the plain
``_sdpa`` on every device.

On a ``(data, model)`` mesh (``sh``, ``layers.Shard``) GQA computes on
this rank's query heads (``gqa_specs`` cut ``wq`` and ``wo`` on heads,
where the heads divide the model axis) and ends in an all-reduce after
``wo``. When the kv heads divide too, a rank holds the kv
heads its query heads use; when they do not, ``wk``/``wv`` are whole and
each rank hands the kernel the kv heads of its own query heads
(``_local_kv``: the local ratio of query to kv heads can differ from the
global one). The decode cache follows ``gqa_cache_specs``: cut on kv heads
when they divide, else on head_dim (``_cache_dim``), in which case decode
scores every query head on this rank's block of head_dim, sums the scores
over the group and gathers the outputs' blocks back.

Windowed archs keep (k, v) in a ring buffer of ``min(window, cache_len)``
slots, entry at absolute position p in slot ``p % s``. ``gqa_decode``
writes the new entry into the cache in place (the reference returns an
updated copy) and returns the same cache.

When the heads do not divide the model axis, ``wq``/``wk``/``wv``/``wo``
are whole. With the reference's sequence-parallel residual
(``transformer.seq_sharded_mode``, ``seq``) a rank projects its own block
of L / m query rows at their absolute positions, all-gathers K and V over
the sequence and attends at ``q_offset = r·L/m`` (the flash kernel on the
card); ``wo`` then needs no all-reduce. Otherwise (decode, a prompt that
the axis does not divide) every rank computes the whole attention.

MLA's full-sequence forward and prefill expand the latent and take the
plain ``_sdpa_auto`` on every device, as the reference's do: its qk head
(nope + rope, 192 at full width) is wider than its v head (128), which the
flash kernel does not take. Its decode is the absorbed-matmul form against
the cached latent (``kv_lora_rank + qk_rope_head_dim`` wide), written in
place at ``pos`` as ``gqa_decode`` does. On a mesh MLA computes on this
rank's heads (``mla_specs``), its q latent cut on ``q_lora_rank`` and
gathered before ``q_norm``, and its latent cache cut on its width.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops

from .layers import P, Axes, Shard, dense_init, frozen, rmsnorm, rmsnorm_init, rmsnorm_specs, split_over

_NEG = -1e30


# -----------------------------------------------------------------------------
# RoPE
# -----------------------------------------------------------------------------
def _rope_freqs(half: int, theta: float) -> torch.Tensor:
    # computed on the CPU for every device, so the card and the CPU rotate
    # by the same float32 frequencies
    return theta ** (-torch.arange(0, half, dtype=torch.float32) / half)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., L, H, hd); positions: (L,) or (B, L)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(half, theta).to(x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., L, half)
    cos, sin = torch.cos(ang).unsqueeze(-2), torch.sin(ang).unsqueeze(-2)  # (..., L, 1, half)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _sdpa(
    q: torch.Tensor,  # (B, Lq, H, hd)
    k: torch.Tensor,  # (B, Lk, Hk, hd)
    v: torch.Tensor,  # (B, Lk, Hk, hd)
    causal: bool,
    window: int | None,
    q_offset: int = 0,
    kv_len: int | None = None,
    scale: float | None = None,
    psum=None,
) -> torch.Tensor:
    """Dense scaled-dot-product attention with GQA + causal/window/len masks.

    ``q_offset``: absolute position of q row 0 (decode: current pos).
    ``kv_len``: number of valid kv entries (decode with ring/full cache).
    ``psum``: sums the scores over ranks that each hold a block of head_dim
    (then ``scale`` must be the whole head_dim's).
    """
    lq, h, hd = q.shape[1:]
    lk, hk = k.shape[1], k.shape[2]
    group = h // hk
    scale = float(scale if scale is not None else hd**-0.5)
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float().repeat_interleave(group, dim=2))
    if psum is not None:
        s = psum(s)
    q_idx = q_offset + torch.arange(lq, device=q.device)[:, None]
    k_idx = torch.arange(lk, device=q.device)[None, :]
    bias = torch.zeros((lq, lk), dtype=torch.float32, device=q.device)
    if causal:
        bias = torch.where(k_idx <= q_idx, bias, _NEG)
    if window is not None:
        bias = torch.where(k_idx > q_idx - window, bias, _NEG)
    if kv_len is not None:
        bias = torch.where(k_idx < kv_len, bias, _NEG)
    p = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float().repeat_interleave(group, dim=2))
    return out.to(q.dtype)


_CHUNK_THRESHOLD = 2048  # above this, full (Lq, Lk) scores would be too large
_Q_CHUNK = 1024


def _sdpa_auto(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int | None,
    scale: float | None = None, q_offset: int = 0,
) -> torch.Tensor:
    """Dense attention for short seqs; q-chunked for long ones. ``q_offset``:
    the position of q's row 0 (a rank's block of a sequence-parallel
    attention).

    The chunked form bounds live scores to (B, H, q_chunk, Lk) per chunk.
    Unlike the reference's scan, the last chunk may be ragged.
    """
    lq = q.shape[1]
    if lq <= _CHUNK_THRESHOLD:
        return _sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset, scale=scale)
    outs = [
        _sdpa(q[:, i : i + _Q_CHUNK], k, v, causal=causal, window=window, q_offset=q_offset + i, scale=scale)
        for i in range(0, lq, _Q_CHUNK)
    ]
    return torch.cat(outs, dim=1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None,
            q_offset: int = 0) -> torch.Tensor:
    """Causal (windowed) attention of (B, Lq, H, hd) q, its row i at position
    ``q_offset + i``, over (B, Lk, Hk, hd) k, v: the flash kernel on the
    card, at the model's dtype (float32, or bfloat16 with fp32 softmax and
    sums), the plain ``_sdpa_auto`` on the CPU."""
    if not q.is_cuda:
        return _sdpa_auto(q, k, v, causal=True, window=window, q_offset=q_offset)
    # the kernel takes (B, H, L, D) with any b/h/l strides: these are views,
    # and the output comes back in q's (B, L, H, hd) layout
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True, window=window, q_offset=q_offset)
    return out.transpose(1, 2)


# =============================================================================
# GQA
# =============================================================================
class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, Hk, hd) — S = min(seq, window) ring buffer
    v: torch.Tensor


def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> nn.ParameterDict:
    d, h, hk = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim()
    p = {
        "wq": dense_init(gen, (d, h, hd), d, dtype),
        "wk": dense_init(gen, (d, hk, hd), d, dtype),
        "wv": dense_init(gen, (d, hk, hd), d, dtype),
        "wo": dense_init(gen, (h, hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros((hk, hd), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros((hk, hd), dtype=dtype, device=gen.device)
    return frozen(**p)


def gqa_specs(ax: Axes, cfg: ArchConfig) -> dict:
    h, hk = cfg.num_heads, cfg.num_kv_heads
    hq_ax = ax.dim_axis(h)
    kv_ax = ax.dim_axis(hk)
    # weights shard on the head axis only; heads that don't divide the
    # axis replicate
    p = {
        "wq": P(None, hq_ax, None),
        "wk": P(None, kv_ax, None),
        "wv": P(None, kv_ax, None),
        "wo": P(hq_ax, None, None),
    }
    if cfg.qkv_bias:
        p["bq"] = P(hq_ax, None)
        p["bk"] = P(kv_ax, None)
        p["bv"] = P(kv_ax, None)
    return p


def gqa_cache_specs(cfg: ArchConfig, ax: Axes) -> "KVCache":
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    kv_pick = ax.pick(hk, hd)
    spec = [None, None]
    if kv_pick >= 0:
        spec[kv_pick] = ax.model
    return KVCache(k=P(ax.b, None, *spec), v=P(ax.b, None, *spec))


def _cache_dim(cfg: ArchConfig, sh: Shard | None) -> int:
    """The dimension of a (B, S, Hk, hd) cache that ``gqa_cache_specs`` cuts
    over the model axis: 2 (kv heads), 3 (head_dim) or -1 (none)."""
    if sh is None or sh.ax.model_size == 1:
        return -1
    pick = sh.ax.pick(cfg.num_kv_heads, cfg.resolved_head_dim())
    return pick + 2 if pick >= 0 else -1


def _block(t: torch.Tensor, dim: int, sh: Shard) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` cut over the model axis."""
    size = t.shape[dim] // sh.ax.model_size
    return t.narrow(dim, sh.model_index * size, size)


def _local_kv(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, sh: Shard | None):
    """The kv heads of (B, L, Hk, hd) k and v that this rank's query heads
    attend with. When the query heads are cut and the kv heads are not,
    query head h uses kv head h // (H / Hk): a contiguous run of kv heads,
    each shared by equally many local query heads, is a view; any other
    pattern takes one kv head per local query head."""
    if sh is None or not sh.split(cfg.num_heads) or sh.split(cfg.num_kv_heads):
        return k, v
    hl = cfg.num_heads // sh.ax.model_size
    group = cfg.num_heads // cfg.num_kv_heads
    idx = [(sh.model_index * hl + j) // group for j in range(hl)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if hl % n == 0 and idx == [lo + j // (hl // n) for j in range(hl)]:
        return k[:, :, lo : lo + n], v[:, :, lo : lo + n]
    return k[:, :, idx], v[:, :, idx]


def _out_proj(params, out: torch.Tensor, cfg: ArchConfig, sh: Shard | None) -> torch.Tensor:
    """(B, L, H, hd) -> (B, L, d) through ``wo``, summed over the model group
    when the heads are cut."""
    y = torch.einsum("blhk,hkd->bld", out, params["wo"])
    sh = split_over(sh, cfg.num_heads)
    return y if sh is None else sh.psum(y)


def _project_qkv(params, x: torch.Tensor, cfg: ArchConfig, sh: Shard | None = None):
    """q, k and v of x. ``sh`` with the query heads cut: x enters the cut
    projections through ``Shard.enter``; whole ``wk``/``wv`` (kv heads that
    do not divide) give whole k and v, which enter as each rank takes its
    query heads' kv heads (``_local_kv``)."""
    heads = split_over(sh, cfg.num_heads)
    kv_cut = heads is not None and heads.split(cfg.num_kv_heads)
    xq = x if heads is None else heads.enter(x)
    xkv = xq if kv_cut else x
    q = torch.einsum("bld,dhk->blhk", xq, params["wq"])
    k = torch.einsum("bld,dhk->blhk", xkv, params["wk"])
    v = torch.einsum("bld,dhk->blhk", xkv, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if heads is not None and not kv_cut:
        k, v = heads.enter(k), heads.enter(v)
    return q, k, v


def _seq_qkv(params, x: torch.Tensor, cfg: ArchConfig, sh: Shard | None, seq: bool):
    """(q, k, v, q_offset) of x for the attention: RoPE'd at the rows'
    absolute positions. ``seq`` (the sequence-parallel residual): x holds
    this rank's block of L / m rows, so its rows start at ``r·L/m``, and k
    and v are all-gathered over the sequence; their gradients are summed
    into each rank's block (each rank's queries read every key)."""
    l = x.shape[1]
    q_offset = sh.model_index * l if seq else 0
    positions = torch.arange(q_offset, q_offset + l, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, sh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if seq:
        k, v = sh.gather(k, 1, reduce=True), sh.gather(v, 1, reduce=True)
    return q, k, v, q_offset


def gqa_forward(params, x: torch.Tensor, cfg: ArchConfig, sh: Shard | None = None, seq: bool = False) -> torch.Tensor:
    """Full-sequence causal attention of x (B, L, d), through the
    differentiable ``_sdpa_auto`` on every device. ``seq``: x is this
    rank's block of the rows (``_seq_qkv``), and so is the output."""
    q, k, v, q_offset = _seq_qkv(params, x, cfg, sh, seq)
    out = _sdpa_auto(q, *_local_kv(k, v, cfg, sh), causal=True, window=cfg.window, q_offset=q_offset)
    return _out_proj(params, out, cfg, sh)


def gqa_cache_init(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.float32,
                   device=None) -> KVCache:
    s = min(seq_len, cfg.window) if cfg.window else seq_len
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    shape = (batch, s, hk, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def gqa_prefill(
    params, x: torch.Tensor, cfg: ArchConfig, cache_len: int | None = None, sh: Shard | None = None,
    seq: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence forward that also returns the (ring-windowed) cache.

    ``cache_len``: total decode capacity (>= l). Window archs get a ring
    buffer of min(window, cache_len) slots aligned to ``slot = pos % s`` —
    the same convention gqa_decode writes with. ``seq``: x is this rank's
    block of the rows, which the kernel takes at their offset against the
    whole sequence's keys; the cache holds the whole sequence's (cut by
    ``gqa_cache_specs``).
    """
    b = x.shape[0]
    q, k, v, q_offset = _seq_qkv(params, x, cfg, sh, seq)
    l = k.shape[1]
    cache_len = cache_len or l
    out = _attend(q, *_local_kv(k, v, cfg, sh), cfg.window, q_offset)
    y = _out_proj(params, out, cfg, sh)
    if _cache_dim(cfg, sh) == 3:
        k, v = _block(k, 3, sh), _block(v, 3, sh)
    s = min(cfg.window, cache_len) if cfg.window is not None else cache_len
    cache = KVCache(k=k.new_zeros((b, s, *k.shape[2:])), v=v.new_zeros((b, s, *v.shape[2:])))
    if cfg.window is not None and l >= s:
        # align the ring: entry at absolute pos p lives in slot p % s
        slots = torch.arange(l - s, l, device=x.device) % s
        cache.k[:, slots] = k[:, l - s :]
        cache.v[:, slots] = v[:, l - s :]
    else:  # slots >= l stay zero, masked by kv_len in decode
        cache.k[:, :l] = k
        cache.v[:, :l] = v
    return y, cache


def gqa_decode(
    params,
    x: torch.Tensor,  # (B, 1, d)
    cache: KVCache,
    pos: int,  # absolute position of this token
    cfg: ArchConfig,
    sh: Shard | None = None,
) -> tuple[torch.Tensor, KVCache]:
    q, k_new, v_new = _project_qkv(params, x, cfg)
    posb = torch.tensor([pos], device=x.device)
    q = rope(q, posb, cfg.rope_theta)
    k_new = rope(k_new, posb, cfg.rope_theta)
    hd_cut = _cache_dim(cfg, sh) == 3
    if hd_cut:
        k_new, v_new = _block(k_new, 3, sh), _block(v_new, 3, sh)
    s = cache.k.shape[1]
    slot = pos % s if cfg.window is not None else min(pos, s - 1)
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    # ring buffer: every slot valid once pos+1 >= s; RoPE phases are
    # absolute so scores are position-correct without rotation.
    kv_len = min(pos + 1, s) if cfg.window is not None else pos + 1
    if hd_cut:
        # every query head scored on this rank's block of head_dim, the
        # scores summed over the group; then the outputs' blocks joined and
        # this rank's query heads kept (when the heads are cut; whole heads,
        # the replicated attention, are every rank's)
        heads = split_over(sh, cfg.num_heads)
        q_all = _block(q if heads is None else sh.gather(q, 2), 3, sh)
        out = _sdpa(q_all, cache.k, cache.v, causal=False, window=None, q_offset=pos, kv_len=kv_len,
                    scale=cfg.resolved_head_dim() ** -0.5, psum=sh.psum)
        out = sh.gather(out, 3)
        out = out if heads is None else _block(out, 2, sh)
    else:
        out = _sdpa(q, *_local_kv(cache.k, cache.v, cfg, sh), causal=False, window=None, q_offset=pos,
                    kv_len=kv_len)
    return _out_proj(params, out, cfg, sh), cache


# =============================================================================
# MLA (DeepSeek-V2)
# =============================================================================
class MLACache(NamedTuple):
    ckv: torch.Tensor  # (B, S, kv_lora + rope_dim): latent ‖ roped shared key


def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> nn.ParameterDict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return frozen(
        wq_a=dense_init(gen, (d, m.q_lora_rank), d, dtype),
        q_norm=rmsnorm_init(m.q_lora_rank, gen.device),
        wq_b=dense_init(gen, (m.q_lora_rank, h, qk_head), m.q_lora_rank, dtype),
        wkv_a=dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim), d, dtype),
        kv_norm=rmsnorm_init(m.kv_lora_rank, gen.device),
        wkv_b=dense_init(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim), m.kv_lora_rank, dtype),
        wo=dense_init(gen, (h, m.v_head_dim, d), h * m.v_head_dim, dtype),
    )


def mla_specs(ax: Axes, cfg: ArchConfig) -> dict:
    ha = ax.dim_axis(cfg.num_heads)
    return {
        "wq_a": P(None, ax.dim_axis(cfg.mla.q_lora_rank)),
        "q_norm": rmsnorm_specs(),
        "wq_b": P(None, ha, None),
        "wkv_a": P(None, None),
        "kv_norm": rmsnorm_specs(),
        "wkv_b": P(None, ha, None),
        "wo": P(ha, None, None),
    }


def mla_cache_specs(cfg: ArchConfig, ax: Axes) -> "MLACache":
    width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    return MLACache(ckv=P(ax.b, None, ax.dim_axis(width)))


def _mla_latent(params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """(c_kv, k_rope): the normed latent (B, L, kv_lora) and the roped shared key (B, L, rope_dim)."""
    r = cfg.mla.kv_lora_rank
    kv = x @ params["wkv_a"]  # (B, L, kv_lora + rdim)
    c_kv = rmsnorm(params["kv_norm"], kv[..., :r], cfg.norm_eps)
    k_rope = rope(kv[..., r:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_query(params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, sh: Shard | None = None):
    """(q_nope, q_rope) of x: this rank's heads when ``sh`` cuts them. The q
    latent is cut on ``q_lora_rank`` where ``wq_a`` is (x entering the cut
    projection), and all-gathered before ``q_norm``, which normalises over
    the whole latent; the gather's gradient is summed into each rank's block
    (each rank's heads read the whole latent), and ``q_norm``'s scale, which
    a rank applies for its own heads only, enters too."""
    nope = cfg.mla.qk_nope_head_dim
    lat = split_over(sh, cfg.mla.q_lora_rank)
    if lat is not None:
        q = lat.gather(lat.enter(x) @ params["wq_a"], -1, reduce=True)
        q = rmsnorm({"scale": lat.enter(params["q_norm"]["scale"])}, q, cfg.norm_eps)
    else:
        q = rmsnorm(params["q_norm"], x @ params["wq_a"], cfg.norm_eps)
        if sh is not None:  # a whole latent before the cut heads: its gradient summed
            q = sh.enter(q)
    q = torch.einsum("blr,rhk->blhk", q, params["wq_b"])
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def mla_forward(params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor | None = None,
                sh: Shard | None = None) -> torch.Tensor:
    """Train/prefill: expand the latent and run standard MHA. ``sh``: on this
    rank's heads (``mla_specs`` cut ``wq_b``, ``wkv_b`` and ``wo`` on heads):
    the whole latent and shared key, which every rank computes alike, enter
    the cut heads (their gradients summed over the group), and the output
    projection ends in an all-reduce."""
    m = cfg.mla
    b, l, _ = x.shape
    positions = torch.arange(l, device=x.device) if positions is None else positions
    sh = split_over(sh, cfg.num_heads)
    q_nope, q_rope = _mla_query(params, x, cfg, positions, sh)
    c_kv, k_rope = _mla_latent(params, x, cfg, positions)
    if sh is not None:
        c_kv, k_rope = sh.enter(c_kv), sh.enter(k_rope)
    kvb = torch.einsum("blr,rhk->blhk", c_kv, params["wkv_b"])
    k_nope, v = kvb[..., : m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim :]
    k_rope_h = k_rope[:, :, None, :].expand(b, l, q_nope.shape[2], m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    out = _sdpa_auto(q, k, v, causal=True, window=None, scale=scale)
    y = torch.einsum("blhv,hvd->bld", out, params["wo"])
    return y if sh is None else sh.psum(y)


def mla_cache_init(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.float32, device=None) -> MLACache:
    m = cfg.mla
    return MLACache(ckv=torch.zeros((batch, seq_len, m.kv_lora_rank + m.qk_rope_head_dim), dtype=dtype,
                                    device=device))


def _latent_cut(cfg: ArchConfig, sh: Shard | None) -> Shard | None:
    """``sh`` when ``mla_cache_specs`` cuts the latent cache's width (kv_lora + rope) over its model axis."""
    return split_over(sh, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)


def mla_prefill(
    params, x: torch.Tensor, cfg: ArchConfig, cache_len: int | None = None, sh: Shard | None = None
) -> tuple[torch.Tensor, MLACache]:
    """The forward, and the latent cache (this rank's block of its width
    when ``mla_cache_specs`` cuts it)."""
    b, l, _ = x.shape
    cache_len = cache_len or l
    positions = torch.arange(l, device=x.device)
    y = mla_forward(params, x, cfg, positions, sh)
    # recompute the latents for the cache (cheap projections)
    ckv = torch.cat(_mla_latent(params, x, cfg, positions), dim=-1)
    cut = _latent_cut(cfg, sh)
    if cut is not None:
        ckv = _block(ckv, 2, cut)
    cache = MLACache(ckv=ckv.new_zeros((b, cache_len, ckv.shape[2])))
    cache.ckv[:, :l] = ckv
    return y, cache


def mla_decode(
    params,
    x: torch.Tensor,  # (B, 1, d)
    cache: MLACache,
    pos: int,
    cfg: ArchConfig,
    sh: Shard | None = None,
) -> tuple[torch.Tensor, MLACache]:
    """Absorbed-matmul MLA decode: attention reads are against the latent,
    not H x head_dim expanded keys. The cache is updated in place.

    ``sh``: this rank's heads absorb ``w_uk`` into their queries. Where the
    cache is cut on its width (``kv_lora + rope``, 576: 144 a rank at model
    4), the absorbed queries ``[q_c | q_rope]`` are gathered over the heads,
    every head is scored on this rank's width block of the cache and the
    scores summed over the group; each rank forms its width block of the
    latent output, the blocks are gathered and the rank's heads apply their
    ``w_uv``. A block may straddle the latent's end and the shared key's
    start (at model 16, rank 14 holds c[504:512] and k_rope[0:28]): the
    scores take both parts alike, and the output keeps the latent's columns."""
    m = cfg.mla
    nope, rdim, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    posb = torch.tensor([pos], device=x.device)
    heads = split_over(sh, cfg.num_heads)
    cut = _latent_cut(cfg, heads)
    q_nope, q_rope = _mla_query(params, x, cfg, posb, heads)
    new = torch.cat(_mla_latent(params, x, cfg, posb), dim=-1)[:, 0]  # (B, kv_lora + rdim)
    s_len = cache.ckv.shape[1]
    cache.ckv[:, min(pos, s_len - 1)] = new if cut is None else _block(new, 1, cut)
    w_uk = params["wkv_b"][..., :nope]  # (r, h, nope)
    w_uv = params["wkv_b"][..., nope:]  # (r, h, vdim)
    # absorb W_UK into the query: [q_c | q_rope] (B, 1, H, r + rdim) against [c | k_rope]
    q_abs = torch.cat([torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk), q_rope], dim=-1)
    if cut is not None:  # every head, on this rank's width block
        q_abs = _block(cut.gather(q_abs, 2), 3, cut)
    scale = (nope + rdim) ** -0.5
    s = torch.einsum("bqhr,bsr->bhqs", q_abs.float(), cache.ckv.float())
    if cut is not None:
        s = cut.psum(s)
    s = s * scale
    mask = torch.arange(s_len, device=x.device) < pos + 1
    p = torch.softmax(torch.where(mask, s, _NEG), dim=-1)
    if cut is None:
        ctx_c = torch.einsum("bhqs,bsr->bqhr", p, cache.ckv[..., :r].float()).to(x.dtype)
    else:  # this rank's width block of the output, joined, the latent's columns and this rank's heads kept
        ctx_c = cut.gather(torch.einsum("bhqs,bsr->bqhr", p, cache.ckv.float()), 3)[..., :r]
        ctx_c = _block(ctx_c, 2, cut).to(x.dtype)
    ctx = torch.einsum("bqhr,rhv->bqhv", ctx_c, w_uv)
    y = torch.einsum("bqhv,hvd->bqd", ctx, params["wo"])
    return (y if heads is None else heads.psum(y)), cache
