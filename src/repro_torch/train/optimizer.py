"""AdamW with gradient clipping, a warm-up + cosine schedule and an
optional bf16 state, functional over a parameter tree.

The tree is an ``nn.Module`` (the model's ``params``) or a mapping of name
to tensor; its leaves are keyed by ``named_parameters()`` names, and so are
the gradients and the moments ``m`` and ``v``. The arithmetic is the
reference's line for line: clip by the pre-clip global norm, the schedule
and the bias corrections in float32, ``delta = mhat / (sqrt(vhat) + eps) +
wd * p``, the state stored in ``state_dtype``. ``torch.optim.AdamW`` is not
used: its decoupled decay ``p * (1 - lr * wd)`` rounds differently, and it
has no clip, schedule or bf16 state of this form.

On a ``(data, model)`` mesh the tree holds this rank's blocks and the
moments take the parameters' blocks (``opt_state_specs(..., zero1=False)``,
as the reference's dry run places them); the update is elementwise on the
blocks, and ``global_norm`` sums each leaf's block's squares and
all-reduces them over exactly the groups the leaf is cut over, so a leaf
whole on a group counts once. ZeRO-1 moments (``zero1=True``: cut further
over ``data``) are specs only here; a step with them raises
(``train_step.make_train_step``, ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models.layers import P, Shard


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32  # torch.bfloat16 halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the parameters' device
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def named_leaves(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The tree's leaves by name: ``named_parameters()`` of a module, or the mapping itself."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def init_opt_state(params: nn.Module | Mapping[str, torch.Tensor], cfg: AdamWConfig) -> OptState:
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device
    m = {k: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device) for k, p in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), m=m, v=v)


def opt_state_specs(param_specs: dict, axes, zero1: bool = True) -> OptState:
    """The reference's: m and v inherit the param specs; with ``zero1`` each
    takes ``"data"`` on its first whole dimension (ZeRO-1 partitioning)."""

    def shard_more(spec: P) -> P:
        if not zero1:
            return spec
        entries = list(spec)
        for i, e in enumerate(entries):
            if e is None:
                entries[i] = "data"
                return P(*entries)
        return spec

    def tree_map(node):
        return shard_more(node) if isinstance(node, P) else {k: tree_map(v) for k, v in node.items()}

    return OptState(step=P(), m=tree_map(param_specs), v=tree_map(param_specs))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: Mapping[str, torch.Tensor], sh: Shard | None = None,
                specs: Mapping[str, P] | None = None) -> torch.Tensor:
    """The norm of every leaf together. ``sh``: the leaves are this rank's
    blocks by ``specs``; the squares of the leaves cut over the same axes
    are summed, all-reduced over those axes' groups, then added up."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    if sh is None:
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    by_axes: dict[tuple[str, ...], list[torch.Tensor]] = {}
    for name, square in zip(tree, leaves):
        by_axes.setdefault(sh.cut_axes(specs[name]), []).append(square)
    sums = []
    for axes, squares in by_axes.items():
        total = torch.sum(torch.stack(squares))
        for axis in axes:
            dist.all_reduce(total, group=sh.group(axis))
        sums.append(total)
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(
    params: nn.Module | Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: OptState,
    cfg: AdamWConfig,
    sh: Shard | None = None,
    specs: Mapping[str, P] | None = None,
) -> tuple[nn.Module | Mapping[str, torch.Tensor], OptState, dict[str, torch.Tensor]]:
    """One AdamW step. Writes the new parameters into ``params`` in place and
    returns it, with the new ``OptState`` and the metrics ``grad_norm``
    (before the clip) and ``lr``, as 0-d tensors on the parameters' device.
    The new moments replace the old ones in ``state``'s dicts leaf by leaf,
    so a step holds one leaf's old and new moments at a time, not two full
    sets (13.3 GB a set on a rank of jamba's 8-layer cut). ``sh``
    and ``specs``: the leaves are this rank's blocks on a mesh
    (``Model.sh``, ``Model.leaf_specs()``); only the norm needs to know."""
    step = state.step + 1
    gnorm = global_norm(grads, sh, specs)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
    for name, p in named_leaves(params).items():
        g = grads[name].float() * clip
        m32, v32 = state.m[name].float(), state.v[name].float()
        m_new = cfg.b1 * m32 + (1 - cfg.b1) * g
        v_new = cfg.b2 * v32 + (1 - cfg.b2) * g * g
        mhat, vhat = m_new / b1c, v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        state.m[name], state.v[name] = m_new.to(cfg.state_dtype), v_new.to(cfg.state_dtype)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
