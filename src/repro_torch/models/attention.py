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

Windowed archs keep (k, v) in a ring buffer of ``min(window, cache_len)``
slots, entry at absolute position p in slot ``p % s``. ``gqa_decode``
writes the new entry into the cache in place (the reference returns an
updated copy) and returns the same cache.

MLA's full-sequence forward and prefill expand the latent and take the
plain ``_sdpa_auto`` on every device, as the reference's do: its qk head
(nope + rope, 192 at full width) is wider than its v head (128), which the
flash kernel does not take. Its decode is the absorbed-matmul form against
the cached latent (``kv_lora_rank + qk_rope_head_dim`` wide), written in
place at ``pos`` as ``gqa_decode`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops

from .layers import dense_init, frozen, rmsnorm, rmsnorm_init

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
) -> torch.Tensor:
    """Dense scaled-dot-product attention with GQA + causal/window/len masks.

    ``q_offset``: absolute position of q row 0 (decode: current pos).
    ``kv_len``: number of valid kv entries (decode with ring/full cache).
    """
    lq, h, hd = q.shape[1:]
    lk, hk = k.shape[1], k.shape[2]
    group = h // hk
    scale = float(scale if scale is not None else hd**-0.5)
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float().repeat_interleave(group, dim=2))
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
    scale: float | None = None,
) -> torch.Tensor:
    """Dense attention for short seqs; q-chunked for long ones.

    The chunked form bounds live scores to (B, H, q_chunk, Lk) per chunk.
    Unlike the reference's scan, the last chunk may be ragged.
    """
    lq = q.shape[1]
    if lq <= _CHUNK_THRESHOLD:
        return _sdpa(q, k, v, causal=causal, window=window, scale=scale)
    outs = [
        _sdpa(q[:, i : i + _Q_CHUNK], k, v, causal=causal, window=window, q_offset=i, scale=scale)
        for i in range(0, lq, _Q_CHUNK)
    ]
    return torch.cat(outs, dim=1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> torch.Tensor:
    """Causal (windowed) self-attention over (B, L, H, hd) q and (B, L, Hk, hd) k, v:
    the flash kernel on the card, the plain ``_sdpa_auto`` on the CPU."""
    if not q.is_cuda:
        return _sdpa_auto(q, k, v, causal=True, window=window)
    # the kernel takes (B, H, L, D) with any b/h/l strides: these are views,
    # and the output comes back in q's (B, L, H, hd) layout
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True, window=window)
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


def _project_qkv(params, x: torch.Tensor, cfg: ArchConfig):
    q = torch.einsum("bld,dhk->blhk", x, params["wq"])
    k = torch.einsum("bld,dhk->blhk", x, params["wk"])
    v = torch.einsum("bld,dhk->blhk", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q, k, v


def gqa_forward(
    params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor | None = None
) -> torch.Tensor:
    """Full-sequence causal attention of x (B, L, d), through the
    differentiable ``_sdpa_auto`` on every device."""
    l = x.shape[1]
    positions = torch.arange(l, device=x.device) if positions is None else positions
    q, k, v = _project_qkv(params, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _sdpa_auto(q, k, v, causal=True, window=cfg.window)
    return torch.einsum("blhk,hkd->bld", out, params["wo"])


def gqa_cache_init(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.float32,
                   device=None) -> KVCache:
    s = min(seq_len, cfg.window) if cfg.window else seq_len
    hk, hd = cfg.num_kv_heads, cfg.resolved_head_dim()
    shape = (batch, s, hk, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def gqa_prefill(
    params, x: torch.Tensor, cfg: ArchConfig, cache_len: int | None = None
) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence forward that also returns the (ring-windowed) cache.

    ``cache_len``: total decode capacity (>= l). Window archs get a ring
    buffer of min(window, cache_len) slots aligned to ``slot = pos % s`` —
    the same convention gqa_decode writes with.
    """
    b, l, _ = x.shape
    cache_len = cache_len or l
    positions = torch.arange(l, device=x.device)
    q, k, v = _project_qkv(params, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, cfg.window)
    y = torch.einsum("blhk,hkd->bld", out, params["wo"])
    s = min(cfg.window, cache_len) if cfg.window is not None else cache_len
    cache = gqa_cache_init(cfg, b, s, k.dtype, x.device)
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
) -> tuple[torch.Tensor, KVCache]:
    q, k_new, v_new = _project_qkv(params, x, cfg)
    posb = torch.tensor([pos], device=x.device)
    q = rope(q, posb, cfg.rope_theta)
    k_new = rope(k_new, posb, cfg.rope_theta)
    s = cache.k.shape[1]
    slot = pos % s if cfg.window is not None else min(pos, s - 1)
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    # ring buffer: every slot valid once pos+1 >= s; RoPE phases are
    # absolute so scores are position-correct without rotation.
    kv_len = min(pos + 1, s) if cfg.window is not None else pos + 1
    out = _sdpa(q, cache.k, cache.v, causal=False, window=None, q_offset=pos, kv_len=kv_len)
    y = torch.einsum("blhk,hkd->bld", out, params["wo"])
    return y, cache


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


def _mla_latent(params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """(c_kv, k_rope): the normed latent (B, L, kv_lora) and the roped shared key (B, L, rope_dim)."""
    r = cfg.mla.kv_lora_rank
    kv = x @ params["wkv_a"]  # (B, L, kv_lora + rdim)
    c_kv = rmsnorm(params["kv_norm"], kv[..., :r], cfg.norm_eps)
    k_rope = rope(kv[..., r:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_project(params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    nope = cfg.mla.qk_nope_head_dim
    q = rmsnorm(params["q_norm"], x @ params["wq_a"], cfg.norm_eps)
    q = torch.einsum("blr,rhk->blhk", q, params["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _mla_latent(params, x, cfg, positions)
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor | None = None) -> torch.Tensor:
    """Train/prefill: expand the latent and run standard MHA."""
    m = cfg.mla
    b, l, _ = x.shape
    positions = torch.arange(l, device=x.device) if positions is None else positions
    q_nope, q_rope, c_kv, k_rope = _mla_project(params, x, cfg, positions)
    kvb = torch.einsum("blr,rhk->blhk", c_kv, params["wkv_b"])
    k_nope, v = kvb[..., : m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim :]
    k_rope_h = k_rope[:, :, None, :].expand(b, l, cfg.num_heads, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    out = _sdpa_auto(q, k, v, causal=True, window=None, scale=scale)
    return torch.einsum("blhv,hvd->bld", out, params["wo"])


def mla_cache_init(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.float32, device=None) -> MLACache:
    m = cfg.mla
    return MLACache(ckv=torch.zeros((batch, seq_len, m.kv_lora_rank + m.qk_rope_head_dim), dtype=dtype,
                                    device=device))


def mla_prefill(
    params, x: torch.Tensor, cfg: ArchConfig, cache_len: int | None = None
) -> tuple[torch.Tensor, MLACache]:
    b, l, _ = x.shape
    cache_len = cache_len or l
    positions = torch.arange(l, device=x.device)
    y = mla_forward(params, x, cfg, positions)
    # recompute the latents for the cache (cheap projections)
    c_kv, k_rope = _mla_latent(params, x, cfg, positions)
    cache = mla_cache_init(cfg, b, cache_len, c_kv.dtype, x.device)
    cache.ckv[:, :l] = torch.cat([c_kv, k_rope], dim=-1)
    return y, cache


def mla_decode(
    params,
    x: torch.Tensor,  # (B, 1, d)
    cache: MLACache,
    pos: int,
    cfg: ArchConfig,
) -> tuple[torch.Tensor, MLACache]:
    """Absorbed-matmul MLA decode: attention reads are against the latent,
    not H x head_dim expanded keys. The cache is updated in place."""
    m = cfg.mla
    nope, rdim = m.qk_nope_head_dim, m.qk_rope_head_dim
    posb = torch.tensor([pos], device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_project(params, x, cfg, posb)
    s_len = cache.ckv.shape[1]
    cache.ckv[:, min(pos, s_len - 1)] = torch.cat([c_kv_new, k_rope_new], dim=-1)[:, 0]
    c, kr = cache.ckv[..., : m.kv_lora_rank], cache.ckv[..., m.kv_lora_rank :]
    w_uk = params["wkv_b"][..., :nope]  # (r, h, nope)
    w_uv = params["wkv_b"][..., nope:]  # (r, h, vdim)
    # absorb W_UK into the query: q_c (B, 1, H, r)
    q_c = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    scale = (nope + rdim) ** -0.5
    s = (torch.einsum("bqhr,bsr->bhqs", q_c.float(), c.float())
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())) * scale
    mask = torch.arange(s_len, device=x.device) < pos + 1
    p = torch.softmax(torch.where(mask, s, _NEG), dim=-1)
    ctx_c = torch.einsum("bhqs,bsr->bqhr", p, c.float()).to(x.dtype)
    ctx = torch.einsum("bqhr,rhv->bqhv", ctx_c, w_uv)
    y = torch.einsum("bqhv,hvd->bqd", ctx, params["wo"])
    return y, cache
