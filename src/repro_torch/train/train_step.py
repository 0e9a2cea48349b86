"""Training step: microbatched gradient accumulation, optional gradient
compression, AdamW.

``make_train_step(model, tcfg)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``. ``accumulate_grads`` runs each of
the ``microbatches`` slices of the batch forward and backward on its own
(activations never exceed one microbatch); the gradients are summed in
``accum_dtype`` and divided by their count, as the reference's scan does.
The reference's ``batch_specs`` and ``metric_specs`` are sharding specs and
have no counterpart on one card (ROADMAP Queue 1 M5).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from repro_torch.models.transformer import Model
from .compression import compress_tree
from .optimizer import AdamWConfig, OptState, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1  # grad-accumulation steps per optimizer step
    compression: str = "none"  # none | bf16 | int8
    accum_dtype: torch.dtype = torch.float32  # bf16 halves the grad buffer at 405B


def auto_train_config(param_count: int, global_batch: int, dp: int, moe: bool = False) -> TrainConfig:
    """Memory-fitting defaults per model scale, the reference's table."""
    if param_count >= 100e9 and not moe:
        # few microbatches = few FSDP weight-gather passes; dense only —
        # MoE dispatch buffers scale with microbatch size
        n, state, accum = 4, torch.bfloat16, torch.bfloat16
    elif param_count >= 100e9:
        n, state, accum = 16, torch.bfloat16, torch.bfloat16
    elif param_count >= 20e9:
        n, state, accum = 8, torch.float32, torch.float32
    elif param_count >= 2e9:
        n, state, accum = 4, torch.float32, torch.float32
    else:
        n, state, accum = 2, torch.float32, torch.float32
    n = max(1, min(n, global_batch // dp))
    while global_batch % n or (global_batch // n) % dp:
        n -= 1
    return TrainConfig(opt=AdamWConfig(state_dtype=state), microbatches=n, accum_dtype=accum)


def _split_microbatches(batch: dict[str, torch.Tensor], n: int) -> dict[str, torch.Tensor]:
    """(B, ...) -> (n, B/n, ...): microbatch i is ``{k: v[i]}``."""

    def r(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not split into {n} microbatches")
        return x.reshape(n, b // n, *x.shape[1:])

    return {k: r(v) for k, v in batch.items()}


def accumulate_grads(
    model: Model, batch: dict[str, torch.Tensor], n: int, accum_dtype: torch.dtype = torch.float32
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(mean loss, gradients by parameter name) of ``model.params`` over
    ``batch`` in ``n`` microbatches: each runs its forward and backward on
    its own, the gradients are summed in ``accum_dtype`` and divided by
    ``n``. Turns gradients on for ``model.params``."""
    model.params.requires_grad_(True)
    names, leaves = zip(*model.params.named_parameters())
    with torch.enable_grad():
        if n == 1:
            loss = model.loss_fn(batch)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
        else:
            mb = _split_microbatches(batch, n)
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
            for i in range(n):
                loss_i = model.loss_fn({k: v[i] for k, v in mb.items()})
                for g_sum, g_i in zip(grads, torch.autograd.grad(loss_i, leaves)):
                    g_sum += g_i.to(accum_dtype)
                loss = loss + loss_i.detach()
            loss = loss / n
            grads = [g / n for g in grads]
    return loss, dict(zip(names, grads))


def make_train_step(
    model: Model, tcfg: TrainConfig
) -> Callable[[nn.Module, OptState, dict[str, torch.Tensor]], tuple[nn.Module, OptState, dict[str, torch.Tensor]]]:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` becomes the model's parameter tree, with gradients turned on,
    and is updated in place; ``metrics`` holds ``loss``, ``grad_norm`` and
    ``lr`` as 0-d tensors on the parameters' device."""

    def train_step(params: nn.Module, opt_state: OptState, batch: dict[str, torch.Tensor]):
        model.params = params
        loss, grads = accumulate_grads(model, batch, tcfg.microbatches, tcfg.accum_dtype)
        grads = compress_tree(grads, tcfg.compression)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, tcfg.opt)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step
