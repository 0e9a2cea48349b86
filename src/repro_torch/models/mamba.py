"""Mamba selective-SSM block (Jamba's mixer): full-sequence scan and decode step.

Recurrence (per channel c, state dim n):
    h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t B_t x_t
    y_t = C_t · h_t + D x_t

The reference runs the scan as a ``lax.scan`` over chunks of 16 unrolled
tokens (of 1 when 16 does not divide L); here it is a Python loop over
tokens carrying the (B, d_in, n) state, with the reference's per-token
update in its order. The chunking changes no arithmetic. Decode carries
(conv_state, ssm_state). Plain PyTorch on every device: the reference has
no kernel for the scan. On the ``meta`` device (the dry run, which has no
values to be sequential about) the loop's shapes, FLOPs and live bytes are
made without its L steps (``_ssm_scan_meta``).

On a ``(data, model)`` mesh (``sh``) the mixer runs on this rank's block
of the ``d_in`` channels (``mamba_specs``): the conv, dt, A, D and the scan
are per channel; ``x_proj``'s dt, B and C are partial sums over the
channels, all-reduced before ``dt_proj``, and ``out_proj``'s output is
all-reduced. For training, the input and the all-reduced projection enter
the rank's channels through ``Shard.enter`` (their gradients are partial
sums over the channels). ``in_proj`` is cut on its fused ``2·d_in`` output; the port
lays a rank's block out as ``[x_r | z_r]`` (``in_proj_layout``), its own
channels of x and of z, where the spec's contiguous block of ``[x | z]``
would hand rank r other channels of x or of z than its own. Where d_in
does not divide the axis but 2·d_in does, ``in_proj`` alone is cut, in its
natural [x | z] order; its output is all-gathered and the rest of the mixer
runs whole on every rank.

``mamba_forward_with_state`` also returns the decode state after the
sequence (the last ``d_conv - 1`` rows of the pre-conv ``x`` and the
scan's final state), which the prefill takes from the forward's own scan.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, SSMConfig

from .layers import P, Axes, Shard, dense_init, frozen, split_over


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_in): trailing inputs for the causal conv
    ssm: torch.Tensor  # (B, d_in, d_state), fp32


def _dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, s.d_state, s.d_conv, dt_rank


def mamba_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> nn.ParameterDict:
    """Drawn in the reference's order: in_proj, conv_w, x_proj, dt_proj, out_proj."""
    d = cfg.d_model
    d_in, d_state, d_conv, dt_rank = _dims(cfg)
    dev = gen.device
    in_proj = dense_init(gen, (d, 2 * d_in), d, dtype)
    conv_w = dense_init(gen, (d_conv, d_in), d_conv, dtype)
    x_proj = dense_init(gen, (d_in, dt_rank + 2 * d_state), d_in, dtype)
    dt_proj = dense_init(gen, (dt_rank, d_in), dt_rank, dtype)
    out_proj = dense_init(gen, (d_in, d), d_in, dtype)
    dt_floor = torch.log(torch.expm1(torch.tensor(0.01, dtype=torch.float32)))
    states = torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
    return frozen(
        in_proj=in_proj,
        conv_w=conv_w,
        conv_b=torch.zeros((d_in,), dtype=dtype, device=dev),
        x_proj=x_proj,
        dt_proj=dt_proj,
        dt_bias=dt_floor.to(dev) * torch.ones((d_in,), dtype=torch.float32, device=dev),
        a_log=torch.log(states.expand(d_in, d_state).contiguous()),
        d_skip=torch.ones((d_in,), dtype=torch.float32, device=dev),
        out_proj=out_proj,
    )


def mamba_specs(ax: Axes, cfg: ArchConfig) -> dict:
    d_in, _, _, _ = _dims(cfg)
    di = ax.dim_axis(d_in)
    return {
        "in_proj": P(None, ax.dim_axis(2 * d_in)),
        "conv_w": P(None, di),
        "conv_b": P(di),
        "x_proj": P(di, None),
        "dt_proj": P(None, di),
        "dt_bias": P(di),
        "a_log": P(di, None),
        "d_skip": P(di),
        "out_proj": P(di, None),
    }


def mamba_state_specs(cfg: ArchConfig, ax: Axes) -> "MambaState":
    d_in, _, _, _ = _dims(cfg)
    di = ax.dim_axis(d_in)
    return MambaState(conv=P(ax.b, None, di), ssm=P(ax.b, di, None))


def in_proj_layout(w: torch.Tensor, blocks: int, inverse: bool = False) -> torch.Tensor:
    """``in_proj`` (d, 2·d_in) = [x | z] with its columns reordered so that
    contiguous block r of ``blocks`` is [x_r | z_r] (``inverse``: back)."""
    d, width = w.shape
    cols = (2, blocks, width // (2 * blocks))
    if inverse:
        cols = (blocks, 2, width // (2 * blocks))
    return w.reshape(d, *cols).transpose(1, 2).reshape(d, width)


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, d_in), w: (d_conv, d_in)."""
    d_conv, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(xp[:, i : i + l] * w[i] for i in range(d_conv))
    return out + b


_SSM_CHUNK = 16  # the reference's tokens per scan step; no arithmetic depends on it


def _ssm_state(h: torch.Tensor, dt_t: torch.Tensor, x_t: torch.Tensor, b_t: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """One token's state update: h (B, d_in, n); dt_t, x_t (B, d_in); b_t (B, n)."""
    da = torch.exp(dt_t[..., None] * a)  # (B, d_in, n)
    return da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]


def _ssm_scan(xs: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
              h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xs, dt: (B, L, d_in); b, c: (B, L, n); a: (d_in, n); h0: (B, d_in, n).
    Returns (final state, ys (B, L, d_in))."""
    if xs.is_meta:
        return _ssm_scan_meta(xs, dt, b, c, a, h0)
    l = xs.shape[1]
    chunk = _SSM_CHUNK if l % _SSM_CHUNK == 0 else 1

    def token_update(h, t):
        h = _ssm_state(h, dt[:, t], xs[:, t], b[:, t], a)
        return h, torch.einsum("bdn,bn->bd", h, c[:, t])

    h, ys = h0, []
    for start in range(0, l, chunk):
        for t in range(start, start + chunk):
            h, y = token_update(h, t)
            ys.append(y)
    return h, torch.stack(ys, dim=1)


def _ssm_scan_meta(xs: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_ssm_scan`` on the ``meta`` device (the dry run), which holds no
    values to be sequential about: the token loop's shapes, dtypes,
    contraction FLOPs and live bytes without its L steps. Under autograd
    the loop keeps every token's decay and state for the backward, so they
    are made for the whole sequence at once; without it (prefill) the loop
    holds a few (B, d_in, n) states and its outputs, and so does this: one
    (B, d_in, L) product for the L contractions, then the loop's state
    updates from its second token on (h0 and the previous state live)."""
    if torch.is_grad_enabled():
        da = torch.exp(dt[..., None] * a)  # (B, L, d_in, n): every token's decay
        hs = torch.addcmul(da * h0[:, None], (dt * xs)[..., None], b[:, :, None, :])  # every token's state
        return hs[:, -1].clone(), torch.einsum("bldn,bln->bld", hs, c)
    ys = torch.bmm(h0, c.transpose(1, 2))  # (B, d_in, L): each token's (B, d_in, n) x (B, n) contraction
    h = _ssm_state(h0, dt[:, 0], xs[:, 0], b[:, 0], a)
    if xs.shape[1] > 1:
        h = _ssm_state(h, dt[:, -1], xs[:, -1], b[:, -1], a)
    return h, ys.transpose(1, 2).contiguous()


def _channels_cut(cfg: ArchConfig, sh: Shard | None) -> Shard | None:
    """``sh`` when the mixer's d_in channels are cut over its model axis (``mamba_specs``)."""
    return split_over(sh, _dims(cfg)[0])


def _in_proj_cut(cfg: ArchConfig, sh: Shard | None) -> Shard | None:
    """``sh`` when ``in_proj`` alone is cut: 2·d_in divides the axis, d_in does not."""
    return split_over(sh, 2 * _dims(cfg)[0]) if _channels_cut(cfg, sh) is None else None


def _project(params, u: torch.Tensor, cfg: ArchConfig, sh: Shard | None = None):
    """(x, z, d_in, d_state, dt_rank); d_in is this rank's channels (half of
    in_proj's columns). ``sh``: the mixer's mesh, which cuts u's projection
    (u enters it), and whose blocks of ``in_proj``'s output are gathered
    where ``in_proj`` alone is cut."""
    _, d_state, _, dt_rank = _dims(cfg)
    whole = _in_proj_cut(cfg, sh)
    cut = _channels_cut(cfg, sh) or whole
    xz = (u if cut is None else cut.enter(u)) @ params["in_proj"]  # (B, L, 2*d_in)
    if whole is not None:
        xz = whole.gather(xz, -1)
    d_in = xz.shape[-1] // 2
    return xz[..., :d_in], xz[..., d_in:], d_in, d_state, dt_rank


def _ssm_params(params, x: torch.Tensor, d_state: int, dt_rank: int, sh: Shard | None = None):
    """dt, B, C and A from the conv's output x. ``sh``: x holds this rank's
    block of channels, so ``x_proj``'s output is summed over the group."""
    proj = x @ params["x_proj"]  # (B, L, dt_rank + 2n)
    if sh is not None:  # whole again, and entering this rank's channels (dt_proj, the scan)
        proj = sh.enter(sh.psum(proj))
    dt = F.softplus(proj[..., :dt_rank] @ params["dt_proj"] + params["dt_bias"]).float()
    b = proj[..., dt_rank : dt_rank + d_state].float()
    c = proj[..., dt_rank + d_state :].float()
    a = -torch.exp(params["a_log"])
    return dt, b, c, a


def mamba_forward_with_state(params, u: torch.Tensor, cfg: ArchConfig,
                             sh: Shard | None = None) -> tuple[torch.Tensor, MambaState]:
    """u: (B, L, d) -> ((B, L, d), the decode state after u). ``sh``: the
    mesh, which cuts the d_in channels (``_channels_cut``) or ``in_proj`` alone."""
    x, z, d_in, d_state, dt_rank = _project(params, u, cfg, sh)
    sh = _channels_cut(cfg, sh)
    d_conv = params["conv_w"].shape[0]
    xc = F.silu(_conv_causal(x, params["conv_w"], params["conv_b"]))
    dt, b, c, a = _ssm_params(params, xc, d_state, dt_rank, sh)
    h0 = torch.zeros((u.shape[0], d_in, d_state), dtype=torch.float32, device=u.device)
    h, y = _ssm_scan(xc.float(), dt, b, c, a, h0)
    y = y + params["d_skip"] * xc.float()
    y = y.to(u.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    # a copy, so the state does not hold the whole (B, L, 2 d_in) projection
    return out if sh is None else sh.psum(out), MambaState(conv=x[:, -(d_conv - 1) :].clone(), ssm=h)


def mamba_forward(params, u: torch.Tensor, cfg: ArchConfig, sh: Shard | None = None) -> torch.Tensor:
    """u: (B, L, d) -> (B, L, d)."""
    return mamba_forward_with_state(params, u, cfg, sh)[0]


def mamba_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> MambaState:
    d_in, d_state, d_conv, _ = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, d_conv - 1, d_in), dtype=dtype, device=device),
        ssm=torch.zeros((batch, d_in, d_state), dtype=torch.float32, device=device),
    )


def mamba_decode(params, u: torch.Tensor, state: MambaState, cfg: ArchConfig,
                 sh: Shard | None = None) -> tuple[torch.Tensor, MambaState]:
    """u: (B, 1, d) single-token step."""
    x, z, d_in, d_state, dt_rank = _project(params, u, cfg, sh)
    sh = _channels_cut(cfg, sh)
    window = torch.cat([state.conv, x], dim=1)  # (B, d_conv, d_in): conv over [state.conv ‖ x]
    xc = torch.einsum("bld,ld->bd", window, params["conv_w"]) + params["conv_b"]
    xc = F.silu(xc)[:, None, :]  # (B, 1, d_in)
    dt, b, c, a = _ssm_params(params, xc, d_state, dt_rank, sh)
    da = torch.exp(dt[:, 0, :, None] * a)  # (B, d_in, n)
    h = da * state.ssm + (dt[:, 0] * xc[:, 0].float())[..., None] * b[:, 0][:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c[:, 0]) + params["d_skip"] * xc[:, 0].float()
    y = y[:, None, :].to(u.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    return out if sh is None else sh.psum(out), MambaState(conv=window[:, 1:], ssm=h)
