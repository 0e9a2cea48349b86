"""Shared layers of the LM substrate: initializers, RMSNorm, SwiGLU MLP,
embedding and LM head, and the sharding layer they run under on a mesh.

Parameters live in ``nn.ParameterDict``s (nested in ``nn.ModuleDict``s)
under the reference's names and einsum layouts, so the functions read like
the reference's (``rmsnorm(params["norm1"], x)``) and a reference parameter
tree converts by copying (``repro_torch.convert``). Every parameter is
created with ``requires_grad=False``, as serving wants it; training turns
gradients on for the tree it trains (``train.train_step``).

Sharding. ``Axes`` and the ``*_specs`` functions are the reference's: a
spec (``P``, the port's own tuple type) names, for each dimension of a
leaf, the mesh axis it is cut over or ``None`` (whole). On a ``(data,
model)`` mesh of ranks (``launch.mesh.make_lm_mesh``) each rank holds the
block of every leaf that the specs give it (``Shard.cut``), and the layer
functions take a ``Shard`` (``sh``; ``None`` on one card) and compute on
their blocks with explicit ``torch.distributed`` collectives over the
model group: a contraction over a cut dimension ends in an all-reduce
(``Shard.psum``), a dimension that a later op needs whole is all-gathered
(``Shard.gather``), and a dimension that does not divide the model axis is
whole on every rank. These are the collectives GSPMD would insert for the
reference's ``shard`` constraints, which need no runtime counterpart
beyond them; activations between layers are whole (replicated) on every
rank of a model group, and bit-identical there, since every all-reduce
hands each rank the same sum.

The collectives are ``torch.autograd.Function``s, so a mesh model trains.
Over the model group: ``psum`` (all-reduce; its backward passes the
gradient through, as every rank holds the same downstream), ``enter``
(identity; its backward all-reduces, placed where a replicated activation
enters a block cut over the model axis, whose ranks each hold a partial
gradient of it) and ``gather`` (its backward keeps this rank's slice).
Over the data group: ``gather_data`` (its backward reduce-scatters, summing
the ranks' gradients into each rank's block: the FSDP weight gathers) and
``sum_data`` (all-reduce both ways). A data rank's gradients are thus
``data`` times its rows' share of the batch's, and the train step averages
them over the data group (``train.train_step``). Outside autograd (serving
under ``inference_mode``) each runs its one collective, as before.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


# -----------------------------------------------------------------------------
# sharding: axes, specs, this rank's blocks and the collectives
# -----------------------------------------------------------------------------
class P(tuple):
    """A partition spec: one entry per dimension, each ``None`` (whole), a
    mesh axis name, or a tuple of names. A one-name tuple is stored as the
    name, as ``jax.sharding.PartitionSpec`` stores it, so equal specs are
    equal tuples."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical->physical axis environment for one mesh."""

    batch: tuple[str, ...] = ("data",)  # ('pod','data') on multi-pod; () = replicated
    model: str = "model"
    model_size: int = 16  # devices along the model axis

    @property
    def b(self):
        """Batch spec entry: tuple of axes, or None when the batch cannot
        shard (e.g. long_500k's global_batch=1)."""
        return self.batch if self.batch else None

    def dim_axis(self, size: int) -> str | None:
        """'model' iff the dim shards evenly, else None (replicate)."""
        return self.model if size % self.model_size == 0 else None

    def pick(self, *dims: int) -> int:
        """Index of the first dim that shards evenly; -1 if none."""
        for i, d in enumerate(dims):
            if d % self.model_size == 0:
                return i
        return -1


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place on a ``(data, model)`` mesh, as the layer functions
    use it: the axes its specs were made with and the mesh's two groups
    (``launch.mesh.LMMesh``). A rank holds block ``model_index`` of every
    dimension a spec cuts over the model axis and block ``data_index`` of
    the batch when the batch is cut (``batch_split``)."""

    ax: Axes
    model_group: Any
    model_index: int
    data_group: Any
    data_index: int
    data_count: int

    def split(self, size: int) -> bool:
        """Whether a dimension of ``size`` is cut over the model axis."""
        return self.ax.model_size > 1 and self.ax.dim_axis(size) is not None

    @property
    def batch_split(self) -> bool:
        return bool(self.ax.batch) and self.data_count > 1

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model group (every rank gets the same bits)."""
        return _AllReduce.apply(t, self.model_group, False)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (whole on every rank of the model group) as it enters a block
        cut over the model axis: the identity, whose gradient is summed over
        the group."""
        return _Enter.apply(t, self.model_group) if _records(t) else t

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's blocks of ``t`` joined along ``dim``, in rank order."""
        return _Gather.apply(t, dim, self.model_group, self.ax.model_size, self.model_index, False)

    def gather_data(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data group's blocks of ``t`` joined along ``dim``, in rank order
        (the gradient: the group's gradients summed, this rank's block)."""
        return _Gather.apply(t, dim, self.data_group, self.data_count, self.data_index, True)

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group (the gradient: summed too)."""
        return _AllReduce.apply(t, self.data_group, True)

    def cut_axes(self, spec: P) -> tuple[str, ...]:
        """The mesh axes (``"model"``, ``"data"``) of more than one rank that
        ``spec`` cuts a leaf over."""
        axes = []
        if self.ax.model_size > 1 and self.ax.model in spec:
            axes.append("model")
        if self.data_count > 1 and any(e is not None and e != self.ax.model for e in spec):
            axes.append("data")
        return tuple(axes)

    def group(self, axis: str):
        """The process group of mesh axis ``axis`` (``"model"`` or ``"data"``)."""
        return self.model_group if axis == "model" else self.data_group

    def _index(self, entry) -> tuple[int, int] | None:
        """(this rank's block, blocks) of a dimension whose spec entry is ``entry``."""
        if entry is None:
            return None
        if entry == self.ax.model:
            return self.model_index, self.ax.model_size
        return self.data_index, self.data_count  # the batch axes

    def cut(self, t: torch.Tensor, spec: P) -> torch.Tensor:
        """This rank's block of a whole ``t`` placed by ``spec`` (a view)."""
        for dim, entry in enumerate(spec):
            index = self._index(entry)
            if index is None:
                continue
            i, n = index
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split into {n} blocks ({spec})")
            size = t.shape[dim] // n
            t = t.narrow(dim, i * size, size)
        return t

    def join(self, t: torch.Tensor, spec: P) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block under ``spec``
        (``cut``'s inverse, by all-gathers over the groups)."""
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            group = self.model_group if entry == self.ax.model else self.data_group
            t = _all_gather(t, dim, group, self._index(entry)[1])
        return t


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    if n == 1:
        return t
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _records(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _all_reduce(t: torch.Tensor, group, copy: bool) -> torch.Tensor:
    """``t`` summed over ``group``: in place unless ``copy`` (an input that
    autograd records is never written)."""
    t = t.clone(memory_format=torch.contiguous_format) if copy else t.contiguous()
    dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the backward passes the gradient through, or with
    ``both`` sums it over the group too."""

    @staticmethod
    def forward(ctx, t, group, both: bool):
        ctx.group, ctx.both = group, both
        return _all_reduce(t, group, copy=t.requires_grad)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.group, copy=True) if ctx.both else g), None, None


class _Enter(torch.autograd.Function):
    """The identity; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, copy=True), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` (``n`` ranks, this one
    ``index``). The backward keeps this rank's slice of the gradient, or with
    ``reduce`` sums the ranks' gradients into it (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim: int, group, n: int, index: int, reduce: bool):
        ctx.dim, ctx.group, ctx.n, ctx.index, ctx.reduce = dim % t.dim(), group, n, index, reduce
        if n == 1:
            return t.view_as(t)
        if ctx.dim == 0:
            out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t.contiguous(), group=group)
            return out
        return _all_gather(t, ctx.dim, group, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.n == 1:
            return g, None, None, None, None, None
        size = g.shape[ctx.dim] // ctx.n
        if not ctx.reduce:
            return g.narrow(ctx.dim, ctx.index * size, size), None, None, None, None, None
        whole = g.movedim(ctx.dim, 0).contiguous()
        block = whole.new_empty((size, *whole.shape[1:]))
        dist.reduce_scatter_tensor(block, whole, group=ctx.group)
        return block.movedim(0, ctx.dim), None, None, None, None, None


def split_over(sh: Shard | None, size: int) -> Shard | None:
    """``sh`` when a dimension of ``size`` is cut over its model axis, else
    None: what a layer function that sums over that dimension is handed."""
    return sh if sh is not None and sh.split(size) else None


def frozen(**entries: torch.Tensor | nn.Module) -> nn.ParameterDict:
    """A ParameterDict of inference-only parameters. An entry that is a
    module (a sub-dict of the reference's tree, such as MLA's ``q_norm`` or
    the MoE FFN's ``shared``) is held as a submodule, so parameter names are
    the reference's key paths (``mixer.q_norm.scale``)."""
    return nn.ParameterDict({k: v if isinstance(v, nn.Module) else nn.Parameter(v, requires_grad=False)
                             for k, v in entries.items()})


# -----------------------------------------------------------------------------
# initializers — fan-in scaled normal, drawn in order from one generator
# -----------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: tuple[int, ...], fan_in: int | None = None,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (fan_in**-0.5 * w).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32).to(dtype)


# -----------------------------------------------------------------------------
# RMSNorm
# -----------------------------------------------------------------------------
def rmsnorm_init(d: int, device) -> nn.ParameterDict:
    return frozen(scale=torch.ones((d,), dtype=torch.float32, device=device))


def rmsnorm_specs() -> dict:
    return {"scale": P(None)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


# -----------------------------------------------------------------------------
# SwiGLU MLP
# -----------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32) -> nn.ParameterDict:
    return frozen(
        w_gate=dense_init(gen, (d, d_ff), d, dtype),
        w_up=dense_init(gen, (d, d_ff), d, dtype),
        w_down=dense_init(gen, (d_ff, d), d_ff, dtype),
    )


def mlp_specs(ax: Axes, d: int, d_ff: int, seq_sharded: bool = False) -> dict:
    if seq_sharded:
        # sequence-parallel residual: tokens shard over 'model', weights
        # replicate (the reference's choice for archs whose heads don't
        # divide the model axis; no runtime path here, ROADMAP M5)
        return {"w_gate": P(None, None), "w_up": P(None, None), "w_down": P(None, None)}
    ff = ax.dim_axis(d_ff)
    return {
        "w_gate": P(None, ff),  # column parallel
        "w_up": P(None, ff),
        "w_down": P(ff, None),  # row parallel (psum after)
    }


def mlp(params, x: torch.Tensor, sh: Shard | None = None) -> torch.Tensor:
    """SwiGLU. ``sh``: the hidden dimension is cut over its model axis
    (column- then row-parallel), so the output is summed over the group."""
    if sh is not None:
        x = sh.enter(x)
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    y = h @ params["w_down"]
    return y if sh is None else sh.psum(y)


# -----------------------------------------------------------------------------
# Embedding / LM head
# -----------------------------------------------------------------------------
def embedding_init(gen: torch.Generator, vocab: int, d: int, tie: bool, dtype=torch.float32) -> nn.ParameterDict:
    p = {"table": embed_init(gen, vocab, d, dtype)}
    if not tie:
        p["lm_head"] = dense_init(gen, (d, vocab), d, dtype)
    return frozen(**p)


def embedding_specs(ax: Axes, vocab: int, tie: bool) -> dict:
    v = ax.dim_axis(vocab)
    p = {"table": P(v, None)}
    if not tie:
        p["lm_head"] = P(None, v)
    return p


def embed_tokens(params, tokens: torch.Tensor, sh: Shard | None = None) -> torch.Tensor:
    """The table's rows of ``tokens``. ``sh``: the vocabulary is cut over its
    model axis; each rank looks up the tokens in its block of rows (zeros
    for the others) and the group sums them, so every rank holds the
    whole embedding, bit for bit (one term of each sum is nonzero)."""
    table = params["table"]
    if sh is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - sh.model_index * rows
    hit = (local >= 0) & (local < rows)
    return sh.psum(table[local.clamp(0, rows - 1)] * hit[..., None].to(table.dtype))


def lm_logits(params, x: torch.Tensor, sh: Shard | None = None) -> torch.Tensor:
    """(B, L, d) -> (B, L, V), fp32 logits. ``sh``: the vocabulary is cut
    over its model axis; each rank computes its block of columns and the
    group all-gathers them (the sampler needs the whole vocabulary)."""
    if sh is not None:
        x = sh.enter(x)
    if "lm_head" in params:
        logits = x @ params["lm_head"].to(x.dtype)
    else:
        logits = x @ params["table"].to(x.dtype).T
    logits = logits.float()
    return logits if sh is None else sh.gather(logits, -1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = -1,
                  sh: Shard | None = None) -> torch.Tensor:
    """Mean token NLL; labels == ignore_id are masked. ``sh`` with the batch
    cut over the data axis: the mean over the whole batch's unmasked labels
    (the summed NLL and the label count summed over the data group)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).float()
    total, count = torch.sum(nll * mask), torch.sum(mask)
    if sh is not None and sh.batch_split:
        total, count = sh.sum_data(total), _all_reduce(count, sh.data_group, copy=False)
    return total / torch.clamp(count, min=1.0)
