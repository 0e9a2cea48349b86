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
whole on a group counts once. With ZeRO-1 moments (``zero1_layout``: the
blocks of ``opt_state_specs(..., zero1=True)``, cut further over ``data``)
a rank keeps and updates only its slice of each moment, and of the
parameter beside it, then rebuilds the parameter's block from the data
ranks' slices (``Zero1Slice.join``): the same elementwise arithmetic on
the same values, so the parameters are ``zero1=False``'s bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models.layers import P, Shard, block_shape
from repro_torch.models.transformer import _flat


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


def init_opt_state(params: nn.Module | Mapping[str, torch.Tensor], cfg: AdamWConfig,
                   layout: Mapping[str, "Zero1Slice"] | None = None) -> OptState:
    """Zero moments, one a leaf; ``layout`` (``zero1_layout``): a leaf in it
    takes the shape of this rank's ZeRO-1 slice of its block."""
    leaves = named_leaves(params)
    layout = layout or {}
    device = next(iter(leaves.values())).device
    m = {k: torch.zeros(layout[k].take(p).shape if k in layout else p.shape, dtype=cfg.state_dtype,
                        device=p.device) for k, p in leaves.items()}
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


@dataclasses.dataclass(frozen=True)
class Zero1Slice:
    """This rank's ZeRO-1 slice of one leaf's moments, within its parameter
    block of shape ``block``: elements ``[start, start + length)`` of
    dimension ``dim``. A dimension the reference's ``opt_state_specs(...,
    zero1=True)`` newly cuts over ``data`` takes GSPMD's layout: ``per`` =
    ceil(size / n) a data rank, the last slice short or empty, and the
    ranks' slices are joined by an all-gather padded to ``per`` (gloo and
    NCCL gather equal sizes). A stacked segment's repeat axis so cut gives
    each data rank whole repeats (``owner``: the data index that holds this
    repeat's moments; the others hold an empty slice), joined by a
    broadcast from the owner."""

    block: tuple[int, ...]
    dim: int
    start: int
    length: int
    per: int
    owner: int | None = None

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` (a view), a tensor of the block's shape."""
        return t.narrow(self.dim, self.start, self.length)

    def join(self, t: torch.Tensor, sh: Shard) -> torch.Tensor:
        """The block of which ``t`` is this rank's slice, from the data
        ranks' slices (every rank of the data group must call it)."""
        if self.owner is not None:
            whole = t.contiguous() if self.length else t.new_empty(self.block)
            dist.broadcast(whole, src=dist.get_global_rank(sh.data_group, self.owner), group=sh.data_group)
            return whole
        moved = t.movedim(self.dim, 0)
        padded = moved.new_zeros((self.per, *moved.shape[1:]))
        padded[:self.length] = moved
        out = padded.new_empty((sh.data_count * self.per, *moved.shape[1:]))
        dist.all_gather_into_tensor(out, padded, group=sh.data_group)
        return out[:self.block[self.dim]].movedim(0, self.dim)


def zero1_layout(model) -> dict[str, Zero1Slice]:
    """{parameter name: this rank's ``Zero1Slice``} of a mesh model's ZeRO-1
    moments: the blocks of ``opt_state_specs(model.placed_specs(), ax,
    zero1=True)``, each leaf's ``"data"`` on its first whole dimension (a
    stacked segment's: its repeat axis, repeat r held by data index r //
    ceil(R / n)). A leaf with no whole dimension is not in it (its moments
    are its parameter's block), nor is any without data ranks. A leaf whose
    parameter spec already names ``"data"`` (a FSDP leaf) raises
    ``ValueError``: the reference's spec then names ``"data"`` twice, which
    JAX's ``NamedSharding`` refuses (``DuplicateSpecError``), so ZeRO-1 runs
    with FSDP off (``Model(fsdp=1)``)."""
    sh = model.sh
    if sh is None or sh.data_count == 1:
        return {}
    stacked = _flat(model.placed_specs())
    moments = _flat(opt_state_specs(model.placed_specs(), model.ax, zero1=True).m)
    specs, shapes = model.leaf_specs(), model.leaf_shapes()
    n, me = sh.data_count, sh.data_index
    out = {}
    for name, spec in stacked.items():
        cut = moments[name]
        if sum((e if isinstance(e, tuple) else (e,)).count("data") for e in cut if e is not None) > 1:
            raise ValueError(f"ZeRO-1 moments of {name}: their spec {cut} names 'data' twice, as its FSDP "
                             f"spec {spec} already cuts it over data (JAX's NamedSharding refuses such a spec); "
                             "train ZeRO-1 with FSDP off (Model(fsdp=1))")
        if cut == spec:
            continue
        dim = next(i for i, (a, b) in enumerate(zip(spec, cut)) if a != b)
        if not name.startswith("seg"):
            block = block_shape(shapes[name], specs[name], sh.sizes)
            per = -(-block[dim] // n)
            start = min(me * per, block[dim])
            out[name] = Zero1Slice(block, dim, start, min(per, block[dim] - start), per)
            continue
        si, rest = name.split(".", 1)
        repeat = model.segments[int(si[3:])].repeat
        per = -(-repeat // n)
        for r in range(repeat):
            leaf = f"{si}.{r}.{rest}"
            block = block_shape(shapes[leaf], specs[leaf], sh.sizes)
            owner = r // per
            out[leaf] = Zero1Slice(block, 0, 0, block[0] if owner == me else 0, block[0], owner)
    return out


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
    layout: Mapping[str, Zero1Slice] | None = None,
) -> tuple[nn.Module | Mapping[str, torch.Tensor], OptState, dict[str, torch.Tensor]]:
    """One AdamW step. Writes the new parameters into ``params`` in place and
    returns it, with the new ``OptState`` and the metrics ``grad_norm``
    (before the clip) and ``lr``, as 0-d tensors on the parameters' device.
    The new moments replace the old ones in ``state``'s dicts leaf by leaf,
    so a step holds one leaf's old and new moments at a time, not two full
    sets (13.3 GB a set on a rank of jamba's 8-layer cut). ``sh``
    and ``specs``: the leaves are this rank's blocks on a mesh
    (``Model.sh``, ``Model.leaf_specs()``); only the norm needs to know.
    ``layout`` (``zero1_layout``): the moments of a leaf in it are this
    rank's ZeRO-1 slices; the update runs on the slices of gradient,
    parameter and moments, and the parameter's block is then joined from
    the data ranks' new slices."""
    step = state.step + 1
    gnorm = global_norm(grads, sh, specs)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
    layout = layout or {}
    for name, p in named_leaves(params).items():
        z = layout.get(name)
        g, mine = (grads[name], p) if z is None else (z.take(grads[name]), z.take(p))
        g = g.float() * clip
        m32, v32 = state.m[name].float(), state.v[name].float()
        m_new = cfg.b1 * m32 + (1 - cfg.b1) * g
        v_new = cfg.b2 * v32 + (1 - cfg.b2) * g * g
        mhat, vhat = m_new / b1c, v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * mine.float()
        new = (mine.float() - lr * delta).to(p.dtype)
        p.copy_(new if z is None else z.join(new, sh))
        state.m[name], state.v[name] = m_new.to(cfg.state_dtype), v_new.to(cfg.state_dtype)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
