"""RWKV-6 (Finch) time mix and channel mix: an attention-free mixer with a
data-dependent decay (w_t is a low-rank function of x_t).

Per head (k-dim = v-dim = head_size), state S (hs, hs):
    out_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(w0 + lora(x_t)))

The full-sequence WKV takes the reference's chunk-parallel form when 16
divides L and its token recurrence otherwise; the two round differently,
so the port branches where the reference does. Each is a Python loop (over
chunks, over tokens) where the reference has a ``lax.scan``. Decode
carries (x_prev, S). The channel mix is RWKV's squared-ReLU FFN (the
config's d_ff). Plain PyTorch on every device: the reference has no kernel
for the WKV.

``rwkv_time_mix_with_state`` also returns the WKV state after the
sequence, which the prefill takes from the forward's own scan.

On a ``(data, model)`` mesh (``sh``, ``layers.Shard``; the ``*_specs`` are
the reference's) the time mix runs on this rank's heads: ``wr``, ``wk``,
``wv`` and ``wg`` are cut on their output d (heads × head size), ``u``,
``ln_scale`` and the WKV state on heads, and ``wo`` on its input, followed
by an all-reduce. The decay LoRA (``w0``, ``w_a``, ``w_b``) is whole: a
rank computes the whole decay and takes its channels. The channel mix cuts
``wk`` on ``d_ff`` and ``wv`` on its input (an all-reduce after), and
``wr`` on its output d, whose r is all-gathered before ``r * kv``. For
training, each token-shifted mix enters the cut projection it feeds
through ``Shard.enter`` (its gradient is a partial sum over the ranks),
and so does the whole decay before a rank takes its channels, so that
``w_a`` and ``w_b`` get the whole gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, RWKVConfig

from .layers import P, Axes, Shard, dense_init, frozen, split_over


class RWKVState(NamedTuple):
    x_prev_tm: torch.Tensor  # (B, d) last input to the time mix (token shift)
    x_prev_cm: torch.Tensor  # (B, d) last input to the channel mix
    s: torch.Tensor  # (B, H, hs, hs) WKV state, fp32


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    r: RWKVConfig = cfg.rwkv or RWKVConfig()
    hs = r.head_size
    return cfg.d_model // hs, hs, r.decay_lora


def _halves(d: int, dev) -> torch.Tensor:
    return 0.5 * torch.ones((d,), dtype=torch.float32, device=dev)


def rwkv_time_mix_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> nn.ParameterDict:
    """Drawn in the reference's order: wr, wk, wv, wg, wo, w_a, w_b (w_a and w_b fp32)."""
    d = cfg.d_model
    nh, hs, lora = _dims(cfg)
    dev = gen.device
    w = {name: dense_init(gen, (d, d), d, dtype) for name in ("wr", "wk", "wv", "wg", "wo")}
    w_a = dense_init(gen, (d, lora), d, torch.float32)
    w_b = dense_init(gen, (lora, d), lora, torch.float32)
    return frozen(
        **{f"mix_{c}": _halves(d, dev) for c in "rkvgw"},
        **w,
        # data-dependent decay: w0 + tanh(x W_a) W_b
        w0=-6.0 * torch.ones((d,), dtype=torch.float32, device=dev),
        w_a=w_a,
        w_b=w_b,
        u=torch.zeros((nh, hs), dtype=torch.float32, device=dev),  # per-head bonus
        ln_scale=torch.ones((nh, hs), dtype=torch.float32, device=dev),  # per-head output norm
    )


def rwkv_time_mix_specs(ax: Axes, cfg: ArchConfig) -> dict:
    da = ax.dim_axis(cfg.d_model)
    ha = ax.dim_axis(_dims(cfg)[0])
    return {
        "mix_r": P(None), "mix_k": P(None), "mix_v": P(None), "mix_g": P(None), "mix_w": P(None),
        "wr": P(None, da), "wk": P(None, da), "wv": P(None, da), "wg": P(None, da),
        "wo": P(da, None),
        "w0": P(None), "w_a": P(None, None), "w_b": P(None, None),
        "u": P(ha, None),
        "ln_scale": P(ha, None),
    }


def _mix(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The token shift: each position's previous input, zeros before the first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _decay(params, xw: torch.Tensor) -> torch.Tensor:
    """w_t in (0, 1): exp(-exp(w0 + tanh(x W_a) W_b)), fp32."""
    lo = torch.tanh(xw.float() @ params["w_a"]) @ params["w_b"]
    return torch.exp(-torch.exp(params["w0"] + lo))


def _head_norm(params, out: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMS norm of the WKV output. out: (..., H, hs), fp32."""
    var = torch.mean(out * out, dim=-1, keepdim=True)
    return out * torch.rsqrt(var + eps) * params["ln_scale"]


_WKV_CHUNK = 16  # tokens per parallel chunk (C x C score blocks)
# fp32 floor of the per-chunk cumulative log decay: the factored r~ / k~
# form is exact while a chunk's log-decay span stays under 25 nats; pairs
# further apart contribute < e^-25 in exact arithmetic
_LOG_DECAY_CLAMP = -25.0


def _wkv_naive(rh, kh, vh, wh, u, s0):
    """The token recurrence. rh, kh, vh, wh: (B, L, H, hs); u: (H, hs);
    s0: (B, H, hs, hs). Returns (final state, out (B, L, H, hs))."""
    s, outs = s0, []
    for t in range(rh.shape[1]):
        r_t, k_t, v_t, w_t = rh[:, t], kh[:, t], vh[:, t], wh[:, t]  # each (B, H, hs)
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, hs, hs)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, s + u[..., None] * kv))
        s = w_t[..., None] * s + kv
    return s, torch.stack(outs, dim=1)


def _wkv_chunked(rh, kh, vh, wh, u, s0, chunk: int = _WKV_CHUNK):
    """The chunk-parallel WKV: the state crosses once a chunk, the work
    inside a chunk is C x C products. With lw_i = sum_{j<=i} log w_j (the
    cumulative log decay inside the chunk):
      out_i  = (r_i * e^{lw_{i-1}}) S_prev
             + sum_{j<i} (r_i . (k_j * e^{lw_{i-1}-lw_j})) v_j
             + (r_i . (u * k_i)) v_i
      S_next = e^{lw_last} S_prev + sum_j (k_j e^{lw_last - lw_j}) v_j^T
    lw is clamped at ``_LOG_DECAY_CLAMP``, so the k-side e^{-lw_j} stays
    inside fp32."""
    b, l, nh, hs = rh.shape
    assert l % chunk == 0, (l, chunk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=rh.device), diagonal=-1)
    s, outs = s0, []
    for start in range(0, l, chunk):
        r, k, v, w = (a[:, start : start + chunk] for a in (rh, kh, vh, wh))  # (B, C, H, hs)
        lw = torch.cumsum(torch.log(torch.clamp(w, min=1e-38)), dim=1)
        lw = torch.clamp(lw, min=_LOG_DECAY_CLAMP)
        lw_prev = F.pad(lw, (0, 0, 0, 0, 1, 0))[:, :-1]  # lw_{i-1}
        lw_last = lw[:, -1:]  # (B, 1, H, hs)
        r_dec = r * torch.exp(lw_prev)  # r~_i
        k_dec = k * torch.exp(-lw)  # k~_j
        # inter-chunk contribution + intra-chunk strictly lower-triangular attention
        out_state = torch.einsum("bchk,bhkv->bchv", r_dec, s)
        scores = torch.einsum("bihk,bjhk->bhij", r_dec, k_dec) * tri[None, None]  # (B, H, C, C)
        out_intra = torch.einsum("bhij,bjhv->bihv", scores, v)
        out_diag = torch.einsum("bchk,bchk->bch", r, u[None, None] * k)[..., None] * v
        outs.append(out_state + out_intra + out_diag)
        k_fwd = k * torch.exp(lw_last - lw)  # k_j e^{lw_last - lw_j}
        s = torch.exp(lw_last[:, 0])[..., None] * s + torch.einsum("bchk,bchv->bhkv", k_fwd, v)
    return s, torch.cat(outs, dim=1)


def _cut(sh: Shard | None, t: torch.Tensor) -> torch.Tensor:
    """``t`` (whole on every rank) as it enters a projection cut over ``sh``'s model axis."""
    return t if sh is None else sh.enter(t)


def _time_mix_inputs(params, x: torch.Tensor, x_prev: torch.Tensor, cfg: ArchConfig, sh: Shard | None):
    """(r, k, v, g, w) of the time mix for inputs x and their token shift
    x_prev: (B, L, d) or, with ``sh``, this rank's channels (B, L, d / m)."""
    r = _cut(sh, _mix(x, x_prev, params["mix_r"])) @ params["wr"]
    k = _cut(sh, _mix(x, x_prev, params["mix_k"])) @ params["wk"]
    v = _cut(sh, _mix(x, x_prev, params["mix_v"])) @ params["wv"]
    g = F.silu(_cut(sh, _mix(x, x_prev, params["mix_g"])) @ params["wg"])
    w = _decay(params, _mix(x, x_prev, params["mix_w"]))  # (B, L, d) fp32, whole
    if sh is not None:
        width = w.shape[-1] // sh.ax.model_size
        w = sh.enter(w).narrow(-1, sh.model_index * width, width)
    return r, k, v, g, w


def _mix_sh(cfg: ArchConfig, sh: Shard | None) -> Shard | None:
    """``sh`` when the time mix's heads, and so its d_model, are cut over its
    model axis (``rwkv_time_mix_specs``)."""
    return split_over(sh, _dims(cfg)[0])


def rwkv_time_mix_with_state(params, x: torch.Tensor, cfg: ArchConfig, chunked: bool = True,
                             sh: Shard | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> ((B, L, d), the WKV state after x: this rank's heads
    with ``sh``). The chunk-parallel WKV where L allows it and ``chunked``,
    as the reference."""
    b, l, d = x.shape
    _, hs, _ = _dims(cfg)
    sh = _mix_sh(cfg, sh)
    r, k, v, g, w = _time_mix_inputs(params, x, _shift(x), cfg, sh)
    nh = r.shape[-1] // hs  # this rank's heads
    rh, kh, vh = (t.reshape(b, l, nh, hs).float() for t in (r, k, v))
    wh = w.reshape(b, l, nh, hs)
    s0 = torch.zeros((b, nh, hs, hs), dtype=torch.float32, device=x.device)
    wkv = _wkv_chunked if chunked and l % _WKV_CHUNK == 0 else _wkv_naive
    s, out = wkv(rh, kh, vh, wh, params["u"], s0)
    out = _head_norm(params, out).reshape(b, l, nh * hs).to(x.dtype)
    y = (out * g) @ params["wo"]
    return (y if sh is None else sh.psum(y)), s


def rwkv_time_mix(params, x: torch.Tensor, cfg: ArchConfig, chunked: bool = True,
                  sh: Shard | None = None) -> torch.Tensor:
    """x: (B, L, d) -> (B, L, d)."""
    return rwkv_time_mix_with_state(params, x, cfg, chunked, sh)[0]


def rwkv_channel_mix_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> nn.ParameterDict:
    """Drawn in the reference's order: wk, wv, wr."""
    d, dff = cfg.d_model, cfg.d_ff
    wk = dense_init(gen, (d, dff), d, dtype)
    wv = dense_init(gen, (dff, d), dff, dtype)
    wr = dense_init(gen, (d, d), d, dtype)
    return frozen(mix_k=_halves(d, gen.device), mix_r=_halves(d, gen.device), wk=wk, wv=wv, wr=wr)


def rwkv_channel_mix_specs(ax: Axes, cfg: ArchConfig) -> dict:
    ff = ax.dim_axis(cfg.d_ff)
    return {
        "mix_k": P(None), "mix_r": P(None),
        "wk": P(None, ff), "wv": P(ff, None), "wr": P(None, ax.dim_axis(cfg.d_model)),
    }


def rwkv_channel_mix(params, x: torch.Tensor, x_prev: torch.Tensor | None = None, cfg: ArchConfig | None = None,
                     sh: Shard | None = None) -> torch.Tensor:
    """Squared-ReLU FFN with token shift. x: (B, L, d); x_prev (B, d), the
    input before x (zeros when None). ``sh`` (with ``cfg``): ``wk`` cut on
    d_ff and ``wv`` on its input (summed over the group after), ``wr`` on
    its output d (r gathered), each where its dimension divides the axis."""
    xp = _shift(x) if x_prev is None else torch.cat([x_prev[:, None], x], dim=1)[:, :-1]
    ff = split_over(sh, cfg.d_ff) if sh is not None else None
    dr = split_over(sh, cfg.d_model) if sh is not None else None
    k = _cut(ff, _mix(x, xp, params["mix_k"])) @ params["wk"]
    kv = (F.relu(k) ** 2) @ params["wv"]
    if ff is not None:
        kv = ff.psum(kv)
    r = torch.sigmoid(_cut(dr, _mix(x, xp, params["mix_r"])) @ params["wr"])
    if dr is not None:
        r = dr.gather(r, -1)
    return r * kv


def rwkv_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> RWKVState:
    nh, hs, _ = _dims(cfg)
    d = cfg.d_model
    return RWKVState(
        x_prev_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        x_prev_cm=torch.zeros((batch, d), dtype=dtype, device=device),
        s=torch.zeros((batch, nh, hs, hs), dtype=torch.float32, device=device),
    )


def rwkv_state_specs(cfg: ArchConfig, ax: Axes) -> RWKVState:
    return RWKVState(
        x_prev_tm=P(ax.b, None),
        x_prev_cm=P(ax.b, None),
        s=P(ax.b, ax.dim_axis(_dims(cfg)[0]), None, None),
    )


def rwkv_decode(tm_params, cm_params, x_tm: torch.Tensor, state: RWKVState,
                cfg: ArchConfig, sh: Shard | None = None) -> tuple[torch.Tensor, RWKVState]:
    """Single-token time-mix step on x_tm (B, 1, d), the post-norm input.
    Returns (time-mix output, state with the new x_prev_tm and S); the
    caller applies the channel mix with ``state.x_prev_cm``. ``cm_params``
    is not read (the reference's signature). ``sh``: on this rank's heads,
    whose block of S the state holds."""
    b = x_tm.shape[0]
    _, hs, _ = _dims(cfg)
    sh = _mix_sh(cfg, sh)
    r, k, v, g, w = _time_mix_inputs(tm_params, x_tm, state.x_prev_tm[:, None], cfg, sh)
    nh = r.shape[-1] // hs
    w = w[:, 0].reshape(b, nh, hs)
    r_t, k_t, v_t = (t[:, 0].reshape(b, nh, hs).float() for t in (r, k, v))
    kv = k_t[..., :, None] * v_t[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r_t, state.s + tm_params["u"][..., None] * kv)
    s_new = w[..., None] * state.s + kv
    out = _head_norm(tm_params, out[:, None]).reshape(b, 1, nh * hs).to(x_tm.dtype)
    y = (out * g) @ tm_params["wo"]
    return (y if sh is None else sh.psum(y)), RWKVState(x_prev_tm=x_tm[:, 0], x_prev_cm=state.x_prev_cm, s=s_new)
