"""Training step: microbatched gradient accumulation, optional gradient
compression, AdamW, and the reference's batch and metric specs.

``make_train_step(model, tcfg)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``. ``accumulate_grads`` runs each of
the ``microbatches`` slices of the batch forward and backward on its own
(activations never exceed one microbatch); each parameter's gradient is
added into one ``accum_dtype`` buffer as autograd produces it (a
post-accumulate hook), so no second full set of gradients is held, and the
sums are divided by their count, as the reference's scan does.

On a ``(data, model)`` or ``(pod, data, model)`` mesh (``Model(mesh=...)``)
every rank is handed the whole global batch: it is split into microbatches
first, as the reference's ``_split_microbatches`` splits it, and each
microbatch is then cut to this rank's rows by ``batch_specs``, so a
microbatch holds the reference's rows (an MoE layer's capacity is the
microbatch's). A rank's gradients are ``dp`` (pod × data) times its rows'
share (``models.layers``); after the microbatch loop the gradients of
leaves whole over the data axis are all-reduced over the pod × data ranks,
an FSDP leaf's (summed over the data ranks by its gather's
reduce-scatter) over the pod ranks, and every gradient is divided by
``dp``. ZeRO-1 moments (``TrainConfig.zero1``) keep a rank's slices of
each moment (``optimizer.zero1_layout``; build the state with
``init_state``). ``int8`` compression runs on the reference's whole
leaf, a segment's repeats stacked, as its blocks of 256 run over that
leaf's whole order (``compress_grads``). ``state_placement`` tells the checkpointer how the
``(params, opt_state)`` tree lies on the mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models.layers import P, block_count
from repro_torch.models.transformer import Model
from .compression import BLOCK, compress_tree, int8_roundtrip
from .optimizer import AdamWConfig, OptState, Zero1Slice, adamw_update, init_opt_state, zero1_layout


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1  # grad-accumulation steps per optimizer step
    compression: str = "none"  # none | bf16 | int8
    accum_dtype: torch.dtype = torch.float32  # bf16 halves the grad buffer at 405B
    # AdamW moments cut further over 'data' (opt_state_specs(zero1=True), optimizer.zero1_layout)
    zero1: bool = False


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


def batch_specs(model: Model, shape_kind: str = "train") -> dict[str, P]:
    """The reference's: tokens, labels (and embeds) cut by batch."""
    ax = model.ax
    specs = {"tokens": P(ax.b, None), "labels": P(ax.b, None)}
    if model.cfg.input_mode == "embeddings":
        specs["embeds"] = P(ax.b, None, None)
    return specs


def metric_specs() -> dict[str, P]:
    return {"loss": P(), "grad_norm": P(), "lr": P()}


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
    its own, each gradient is added into its ``accum_dtype`` buffer as it
    appears and the sums are divided by ``n`` (``n`` 1: autograd's gradients
    as they come). On a mesh ``batch`` is the global batch and the
    gradients are this rank's blocks, reduced over the pod × data ranks. Turns
    gradients on for ``model.params``."""
    model.params.requires_grad_(True)
    names, leaves = zip(*model.params.named_parameters())
    sh = model.sh
    rows = batch_specs(model)
    grads: list = ([None] * len(leaves) if n == 1 else
                   [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves])

    def adder(i: int):
        def add(p: torch.Tensor) -> None:
            if n == 1:
                grads[i] = p.grad
            else:
                grads[i] += p.grad.to(accum_dtype)
            p.grad = None

        return add

    def mine(part: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return part if sh is None else {k: sh.cut(v, rows[k]) for k, v in part.items()}

    hooks = [p.register_post_accumulate_grad_hook(adder(i)) for i, p in enumerate(leaves)]
    try:
        with torch.enable_grad():
            if n == 1:
                loss = model.loss_fn(mine(batch))
                loss.backward()
                loss = loss.detach()
            else:
                mb = _split_microbatches(batch, n)
                loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                for i in range(n):
                    loss_i = model.loss_fn(mine({k: v[i] for k, v in mb.items()}))
                    loss_i.backward()
                    loss = loss + loss_i.detach()
                loss = loss / n
                for g in grads:  # in place: a second full set of gradients would not fit a large model
                    g.div_(n)
    finally:
        for hook in hooks:
            hook.remove()
    missing = [name for name, g in zip(names, grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached {missing}")
    if sh is not None and sh.dp > 1:
        specs = model.leaf_specs()
        for name, g in zip(names, grads):
            if "data" not in sh.cut_axes(specs[name]):
                dist.all_reduce(g, group=sh.group(("pod", "data")))
            elif sh.pod_count > 1:  # summed over the data ranks by its gather's reduce-scatter
                dist.all_reduce(g, group=sh.pod_group)
            g /= sh.dp
    return loss, dict(zip(names, grads))


def _leaf_runs(names) -> list[list[str]]:
    """The names grouped by the reference's leaves: the repeats of a
    segment's leaf (``seg{i}.{r}.rest``) in repeat order, the reference's
    one stacked ``(R, ...)`` leaf; any other name alone."""
    runs: dict[str, list[tuple[int, str]]] = {}
    for name in names:
        parts = name.split(".")
        stacked = parts[0].startswith("seg")
        key = ".".join([parts[0], *parts[2:]]) if stacked else name
        runs.setdefault(key, []).append((int(parts[1]) if stacked else 0, name))
    return [[name for _, name in sorted(run)] for run in runs.values()]


def compress_grads(model: Model, grads: dict[str, torch.Tensor], mode: str) -> dict[str, torch.Tensor]:
    """``compress_tree`` of a rank's gradients, in the reference's tree.
    ``int8`` quantizes each of the reference's leaves in the 256-element
    blocks of its whole flattened order, as ``compress_tree`` does. A
    segment's leaf is its R repeats stacked: where a repeat's whole tensor
    holds a multiple of 256 elements every block lies in one repeat, and
    each repeat is compressed as an unstacked leaf is; else blocks straddle
    repeats, and the run of the R tensors (on a mesh each cut one first
    joined over its cut axes) is concatenated in repeat order, compressed
    and cut back to the rank's tensors. A leaf's tensor (one repeat, or an
    unstacked leaf) is compressed where it lies when it is whole on the
    rank, or cut on its first dimension alone into blocks of a multiple of
    256 elements (a run of the whole order whose blocks are the whole
    leaf's); else it is joined, compressed whole and cut back."""
    if mode != "int8":
        return compress_tree(grads, mode)
    sh = model.sh
    specs = model.leaf_specs() if sh is not None else {}
    out = {}
    for run in _leaf_runs(grads):
        cut = [sh is not None and bool(sh.cut_axes(specs[name])) for name in run]
        blocks = math.prod(block_count(e, sh.sizes) for e in specs[run[0]]) if sh is not None else 1
        whole = grads[run[0]].numel() * blocks  # the elements of one repeat's whole tensor
        if len(run) > 1 and whole % BLOCK:
            wholes = [model.join_leaf(name, grads[name]) if c else grads[name] for name, c in zip(run, cut)]
            flat = int8_roundtrip(torch.cat([w.reshape(-1) for w in wholes]))
            for name, c, part in zip(run, cut, flat.split(whole)):
                part = part.view(wholes[0].shape)
                out[name] = model.cut_leaf(name, part).clone() if c else part
            continue
        for name, c in zip(run, cut):
            g = grads[name]
            if not c or (g.numel() % BLOCK == 0 and all(e is None for e in specs[name][1:])):
                out[name] = int8_roundtrip(g)
            else:
                out[name] = model.cut_leaf(name, int8_roundtrip(model.join_leaf(name, g))).clone()
    return out


def init_state(model: Model, tcfg: TrainConfig) -> OptState:
    """``init_opt_state`` of ``model.params`` for the step ``make_train_step``
    makes: with ``tcfg.zero1`` on a mesh, this rank's ZeRO-1 slices."""
    return init_opt_state(model.params, tcfg.opt, zero1_layout(model) if tcfg.zero1 else None)


def make_train_step(
    model: Model, tcfg: TrainConfig
) -> Callable[[nn.Module, OptState, dict[str, torch.Tensor]], tuple[nn.Module, OptState, dict[str, torch.Tensor]]]:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` becomes the model's parameter tree, with gradients turned on,
    and is updated in place; ``metrics`` holds ``loss``, ``grad_norm`` and
    ``lr`` as 0-d tensors on the parameters' device (on a mesh, the same on
    every rank). With ``tcfg.zero1`` on a mesh of data ranks ``opt_state``
    holds this rank's ZeRO-1 slices (``init_state``); a FSDP leaf then
    raises ``ValueError`` here (``optimizer.zero1_layout``)."""
    sh = model.sh
    specs = model.leaf_specs() if sh is not None else None
    layout = zero1_layout(model) if tcfg.zero1 else None

    def train_step(params: nn.Module, opt_state: OptState, batch: dict[str, torch.Tensor]):
        model.params = params
        loss, grads = accumulate_grads(model, batch, tcfg.microbatches, tcfg.accum_dtype)
        grads = compress_grads(model, grads, tcfg.compression)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, tcfg.opt, sh, specs, layout)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


class StatePlacement:
    """How the training state ``(params, opt_state)`` (the tree
    ``launch.train`` checkpoints; key paths ``0.<parameter>``, ``1.step``,
    ``1.m.<parameter>``, ``1.v.<parameter>``) lies on a mesh, for
    ``checkpoint.checkpointer``: each leaf is joined to the whole tensor a
    one-card run holds (a parameter, or a moment of its layout, by
    ``Model.join_leaf``; a ZeRO-1 slice first joined to its block) and cut
    back to this rank's block. ``writer``: global rank 0."""

    def __init__(self, model: Model, layout: dict[str, Zero1Slice] | None = None):
        self.model, self.layout = model, layout or {}
        self.writer = dist.get_rank() == 0
        self._shapes = model.leaf_shapes()

    def _leaf(self, key: str) -> tuple[str | None, Zero1Slice | None]:
        """(parameter name, its ZeRO-1 slice for a moment) of a key path; (None, None) for the step."""
        if key.startswith("0."):
            return key[2:], None
        if key.startswith(("1.m.", "1.v.")):
            return key[4:], self.layout.get(key[4:])
        return None, None

    def whole_shape(self, key: str, block: torch.Tensor) -> tuple[int, ...]:
        name, _ = self._leaf(key)
        return tuple(block.shape) if name is None else tuple(self._shapes[name])

    def join(self, key: str, block: torch.Tensor) -> torch.Tensor:
        name, z = self._leaf(key)
        if name is None:
            return block
        return self.model.join_leaf(name, block if z is None else z.join(block, self.model.sh))

    def cut(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        name, z = self._leaf(key)
        if name is None:
            return whole
        block = self.model.cut_leaf(name, whole)
        return block if z is None else z.take(block)

    def barrier(self) -> None:
        dist.barrier()
