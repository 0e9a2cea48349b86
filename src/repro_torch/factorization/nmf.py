"""Nonnegative Matrix Factorization via multiplicative updates (Frobenius).

The paper's T_model: V (n, m) ≈ W (n, k) H (k, m), W,H >= 0, with the
classic Lee-Seung updates

    H <- H * (W^T V) / (W^T W H + eps)
    W <- W * (V H^T) / (W H H^T + eps)

``nmf`` runs a fixed number of sweeps; ``nmf_chunked`` runs them in
chunks with a ``should_abort`` poll and an optional convergence ``tol``
between chunks (the paper's §III-D: a k pruned by another resource stops
paying for its fit at the next chunk boundary).

Every function takes optional leading batch axes (one per independent
fit), written out where the reference vmaps. ``mu_step`` is the kernel
boundary: on a CUDA tensor each half-sweep is the hand-written Hopper
kernel (``repro_torch.kernels.ops.mu_update_h`` / ``mu_update_w``), on a
CPU tensor its plain version. Randomness enters only through the unscaled
U[0.1, 1) init draws the caller passes (see ``repro_torch.random``).

A fit runs at V's dtype, with draws of that dtype: float32, or bfloat16 as
the reference's fits run on bf16 data (each MU half-sweep is then the bf16
half of its kernel, and the relative error is taken from norms at bf16).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.random import init_draws, seeded_generator

from .batching import batched_lanes

_EPS = 1e-9


class NMFResult(NamedTuple):
    w: torch.Tensor
    h: torch.Tensor
    rel_error: torch.Tensor  # ||V - WH||_F / ||V||_F
    iters: int


def _mean(v: torch.Tensor) -> torch.Tensor:
    return v.mean(dim=(-2, -1))


def nmf_init(
    v_mean: torch.Tensor, k: int, w_draw: torch.Tensor, h_draw: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaled-uniform W/H init: sqrt(max(mean(V), eps) / k) times the draws.

    The draws may be at a larger rank k_draw (the padded rank of a batched
    fit); they are sliced to k — the active block a mask-padded fit starts
    from for the same draws.
    """
    scale = torch.sqrt(torch.clamp(v_mean, min=_EPS) / k)[..., None, None]
    return scale * w_draw[..., :, :k], scale * h_draw[..., :k, :]


def mu_step(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One multiplicative-update sweep (H then W)."""
    h = kernel_ops.mu_update_h(v, w, h)
    w = kernel_ops.mu_update_w(v, w, h)
    return w, h


def reconstruction_error(v: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    num = torch.linalg.matrix_norm(v - w @ h)
    return num / torch.clamp(torch.linalg.matrix_norm(v), min=_EPS)


def nmf(
    v: torch.Tensor, k: int, w_draw: torch.Tensor, h_draw: torch.Tensor, iters: int = 200
) -> NMFResult:
    """NMF at rank k for a fixed iteration count from the given init draws."""
    w, h = nmf_init(_mean(v), k, w_draw, h_draw)
    for _ in range(iters):
        w, h = mu_step(v, w, h)
    return NMFResult(w, h, reconstruction_error(v, w, h), iters)


def nmf_chunked(
    v: torch.Tensor,
    k: int,
    w_draw: torch.Tensor,
    h_draw: torch.Tensor,
    iters: int = 200,
    chunk: int = 25,
    should_abort: Callable[[], bool] | None = None,
    tol: float | None = None,
) -> NMFResult:
    """Chunked NMF with §III-D early abort and an optional convergence tol.

    Before each chunk of up to ``chunk`` sweeps, ``should_abort()`` may stop
    the fit; after it, with ``tol``, the fit stops once the relative error
    improved by less than ``tol`` over the chunk (one host read a chunk).
    ``iters`` of the result is the sweeps applied; an aborted fit returns
    its partial factors (callers treat it as void). Never aborted and
    without ``tol``, it applies the sweeps ``nmf`` applies.
    """
    w, h = nmf_init(_mean(v), k, w_draw, h_draw)
    done = 0
    prev_err = float("inf")
    while done < iters:
        if should_abort is not None and should_abort():
            break
        step = min(chunk, iters - done)
        for _ in range(step):
            w, h = mu_step(v, w, h)
        done += step
        if tol is not None:
            err = float(reconstruction_error(v, w, h))
            if prev_err - err < tol:
                break
            prev_err = err
    return NMFResult(w, h, reconstruction_error(v, w, h), done)


def _active(k_eff: torch.Tensor, k_pad: int, like: torch.Tensor) -> torch.Tensor:
    """(..., k_pad) float mask of the live components of each fit."""
    k_eff = torch.as_tensor(k_eff, device=like.device)
    return (torch.arange(k_pad, device=like.device) < k_eff[..., None]).to(like.dtype)


def _masked_init(
    v: torch.Tensor, k_eff, w_draw: torch.Tensor, h_draw: torch.Tensor, k_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked W/H init at padded rank: the scale uses k_eff, not k_pad."""
    k_eff = torch.as_tensor(k_eff, device=v.device)
    active = _active(k_eff, k_pad, v)
    scale = torch.sqrt(torch.clamp(_mean(v), min=_EPS) / k_eff)[..., None, None]
    return (scale * w_draw) * active[..., None, :], (scale * h_draw) * active[..., :, None]


def _masked_sweeps(
    v: torch.Tensor,
    w: torch.Tensor,
    h: torch.Tensor,
    k_eff,
    k_pad: int,
    sweeps: int,
    steps: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``sweeps`` masked MU sweeps from (w, h); returns (w, h, rel_error).

    Components >= k_eff are re-masked after every sweep, so zero columns
    stay zero over hundreds of sweeps. Running s1 then s2 sweeps applies
    the same operations as one (s1 + s2)-sweep fit. ``steps`` (one per
    fit) gates the loop per fit: sweep s applies only while ``s < steps``,
    so a fit advances exactly ``steps`` sweeps inside a longer call.
    """
    active = _active(k_eff, k_pad, v)
    w_mask, h_mask = active[..., None, :], active[..., :, None]
    for s in range(sweeps):
        w_new, h_new = mu_step(v, w, h)
        w_new, h_new = w_new * w_mask, h_new * h_mask
        if steps is not None:
            live = (s < steps)[..., None, None]
            w_new, h_new = torch.where(live, w_new, w), torch.where(live, h_new, h)
        w, h = w_new, h_new
    return w, h, reconstruction_error(v, w, h)


def _nmf_masked(
    v: torch.Tensor, k_eff, w_draw: torch.Tensor, h_draw: torch.Tensor, k_pad: int, iters: int = 200
) -> NMFResult:
    """NMF at padded rank k_pad with components >= k_eff zero-masked."""
    w, h = _masked_init(v, k_eff, w_draw, h_draw, k_pad)
    w, h, err = _masked_sweeps(v, w, h, k_eff, k_pad, iters)
    return NMFResult(w, h, err, iters)


def nmf_batched(
    v: torch.Tensor,
    ks: Sequence[int],
    seed: int = 0,
    k_pad: int | None = None,
    iters: int = 200,
    draws: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> NMFResult:
    """Fit every rank in ``ks`` as one padded NMF with a leading lane axis.

    w (b, n, k_pad) / h (b, k_pad, m) with components >= ks[i] zeroed.
    Lane i draws its init at k_pad from ``lane_seed(seed, ks[i])`` unless
    ``draws`` = (w (b, n, k_pad), h (b, k_pad, m)) is given; it reproduces
    ``nmf(v, ks[i], w_draw, h_draw)`` when ks[i] == k_pad.
    """
    ks_t, seeds, k_pad = batched_lanes(ks, seed, k_pad, v.device)
    n, m = v.shape
    if draws is None:
        parts = [init_draws(seeded_generator(s, v.device), n, m, k_pad, dtype=v.dtype) for s in seeds]
        draws = (torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))
    vb = v.expand(len(seeds), n, m).contiguous()
    return _nmf_masked(vb, ks_t, draws[0], draws[1], k_pad, iters)
