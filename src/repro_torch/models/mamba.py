"""Mamba selective-SSM block (Jamba's mixer): full-sequence scan and decode step.

Recurrence (per channel c, state dim n):
    h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t B_t x_t
    y_t = C_t · h_t + D x_t

The reference runs the scan as a ``lax.scan`` over chunks of 16 unrolled
tokens (of 1 when 16 does not divide L); here it is a Python loop over
tokens carrying the (B, d_in, n) state, with the reference's per-token
update in its order. The chunking changes no arithmetic. Decode carries
(conv_state, ssm_state). Plain PyTorch on every device: the reference has
no kernel for the scan.

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

from .layers import dense_init, frozen


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


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, d_in), w: (d_conv, d_in)."""
    d_conv, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(xp[:, i : i + l] * w[i] for i in range(d_conv))
    return out + b


_SSM_CHUNK = 16  # the reference's tokens per scan step; no arithmetic depends on it


def _ssm_scan(xs: torch.Tensor, dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
              h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xs, dt: (B, L, d_in); b, c: (B, L, n); a: (d_in, n); h0: (B, d_in, n).
    Returns (final state, ys (B, L, d_in))."""
    l = xs.shape[1]
    chunk = _SSM_CHUNK if l % _SSM_CHUNK == 0 else 1

    def token_update(h, t):
        da = torch.exp(dt[:, t, :, None] * a)  # (B, d_in, n)
        h = da * h + (dt[:, t] * xs[:, t])[..., None] * b[:, t, None, :]
        return h, torch.einsum("bdn,bn->bd", h, c[:, t])

    h, ys = h0, []
    for start in range(0, l, chunk):
        for t in range(start, start + chunk):
            h, y = token_update(h, t)
            ys.append(y)
    return h, torch.stack(ys, dim=1)


def _project(params, u: torch.Tensor, cfg: ArchConfig):
    d_in, d_state, _, dt_rank = _dims(cfg)
    xz = u @ params["in_proj"]  # (B, L, 2*d_in)
    return xz[..., :d_in], xz[..., d_in:], d_in, d_state, dt_rank


def _ssm_params(params, x: torch.Tensor, d_state: int, dt_rank: int):
    proj = x @ params["x_proj"]  # (B, L, dt_rank + 2n)
    dt = F.softplus(proj[..., :dt_rank] @ params["dt_proj"] + params["dt_bias"]).float()
    b = proj[..., dt_rank : dt_rank + d_state].float()
    c = proj[..., dt_rank + d_state :].float()
    a = -torch.exp(params["a_log"])
    return dt, b, c, a


def mamba_forward_with_state(params, u: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, MambaState]:
    """u: (B, L, d) -> ((B, L, d), the decode state after u)."""
    x, z, d_in, d_state, dt_rank = _project(params, u, cfg)
    d_conv = params["conv_w"].shape[0]
    xc = F.silu(_conv_causal(x, params["conv_w"], params["conv_b"]))
    dt, b, c, a = _ssm_params(params, xc, d_state, dt_rank)
    h0 = torch.zeros((u.shape[0], d_in, d_state), dtype=torch.float32, device=u.device)
    h, y = _ssm_scan(xc.float(), dt, b, c, a, h0)
    y = y + params["d_skip"] * xc.float()
    y = y.to(u.dtype) * F.silu(z)
    # a copy, so the state does not hold the whole (B, L, 2 d_in) projection
    return y @ params["out_proj"], MambaState(conv=x[:, -(d_conv - 1) :].clone(), ssm=h)


def mamba_forward(params, u: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """u: (B, L, d) -> (B, L, d)."""
    return mamba_forward_with_state(params, u, cfg)[0]


def mamba_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> MambaState:
    d_in, d_state, d_conv, _ = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, d_conv - 1, d_in), dtype=dtype, device=device),
        ssm=torch.zeros((batch, d_in, d_state), dtype=torch.float32, device=device),
    )


def mamba_decode(params, u: torch.Tensor, state: MambaState, cfg: ArchConfig) -> tuple[torch.Tensor, MambaState]:
    """u: (B, 1, d) single-token step."""
    x, z, d_in, d_state, dt_rank = _project(params, u, cfg)
    window = torch.cat([state.conv, x], dim=1)  # (B, d_conv, d_in): conv over [state.conv ‖ x]
    xc = torch.einsum("bld,ld->bd", window, params["conv_w"]) + params["conv_b"]
    xc = F.silu(xc)[:, None, :]  # (B, 1, d_in)
    dt, b, c, a = _ssm_params(params, xc, d_state, dt_rank)
    da = torch.exp(dt[:, 0, :, None] * a)  # (B, d_in, n)
    h = da * state.ssm + (dt[:, 0] * xc[:, 0].float())[..., None] * b[:, 0][:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c[:, 0]) + params["d_skip"] * xc[:, 0].float()
    y = y[:, None, :].to(u.dtype) * F.silu(z)
    return y @ params["out_proj"], MambaState(conv=window[:, 1:], ssm=h)
