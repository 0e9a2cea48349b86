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
model)`` or ``(pod, data, model)`` mesh of ranks
(``launch.mesh.make_lm_mesh``) each rank holds the
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
hands each rank the same sum. The one exception is the reference's
sequence-parallel residual (``transformer.seq_sharded_mode``): there a
rank holds its block of the sequence's rows between layers.

The collectives are ``torch.autograd.Function``s, so a mesh model trains.
Over the model group: ``psum`` (all-reduce; its backward passes the
gradient through, as every rank holds the same downstream), ``enter``
(identity; its backward all-reduces, placed where a replicated activation
enters a block cut over the model axis, whose ranks each hold a partial
gradient of it, and on a whole weight that a rank applies to its own rows
only), ``gather`` (its backward keeps this rank's slice, or with ``reduce``
sums the ranks' gradients into it) and ``scatter`` (this rank's block; its
backward all-gathers).
Over the data group: ``gather_data`` (its backward reduce-scatters, summing
the ranks' gradients into each rank's block: the FSDP weight gathers).
Over the ranks the batch is cut over (the data group, or on a pod mesh the
pod × data ranks): ``gather_batch`` and ``sum_batch`` (all-reduce both
ways). A rank's gradients are thus ``dp`` (pod × data) times its rows'
share of the batch's, and the train step averages them over the pod ×
data ranks (``train.train_step``). Outside autograd (serving under
``inference_mode``) each runs its one collective, as before.
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


def _names(entry) -> tuple[str, ...]:
    """The mesh axes a spec entry names (a name, or a tuple of names, pod-major)."""
    return entry if isinstance(entry, tuple) else (entry,)


def block_count(entry, sizes: dict[str, int]) -> int:
    """Blocks a dimension whose spec entry is ``entry`` is cut into on a mesh
    of axis ``sizes`` (1 for ``None``, a missing axis or an axis of one rank)."""
    n = 1
    for name in _names(entry) if entry is not None else ():
        n *= sizes.get(name, 1)
    return n


def block_shape(shape, spec: P, sizes: dict[str, int]) -> tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape`` placed by ``spec``
    on a mesh of axis ``sizes``: each cut dimension divided by its blocks,
    raising where it does not divide (the rule ``Shard.cut`` cuts by)."""
    shape = tuple(shape)
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = block_count(entry, sizes)
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of {shape} does not split into {n} blocks ({spec})")
        out[dim] = shape[dim] // n
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place on a ``(pod, data, model)`` mesh, as the layer
    functions use it: the axes its specs were made with and the mesh's
    groups (``launch.mesh.LMMesh``). A spec entry names the axes a
    dimension is cut over: ``"model"`` (block ``model_index``), ``"data"``
    (the FSDP entry: block ``data_index`` of the data ranks alone) or the
    batch entry ``ax.b``, which on a pod mesh is ``("pod", "data")``: block
    ``pod_index · data_count + data_index`` of the pod × data ranks, pod-major
    as the reference's mesh orders them. ``dp_group`` holds those pod ×
    data ranks (the data group on one pod)."""

    ax: Axes
    model_group: Any
    model_index: int
    data_group: Any
    data_index: int
    data_count: int
    dp_group: Any
    pod_group: Any = None
    pod_index: int = 0
    pod_count: int = 1

    @property
    def sizes(self) -> dict[str, int]:
        return {"pod": self.pod_count, "data": self.data_count, self.ax.model: self.ax.model_size}

    @property
    def dp(self) -> int:
        """The pod × data ranks: copies of the model, each with its rows of the batch."""
        return self.pod_count * self.data_count

    def split(self, size: int) -> bool:
        """Whether a dimension of ``size`` is cut over the model axis."""
        return self.ax.model_size > 1 and self.ax.dim_axis(size) is not None

    @property
    def batch_count(self) -> int:
        return block_count(self.ax.b, self.sizes)

    @property
    def batch_index(self) -> int:
        return self._index(self.ax.b)[0] if self.ax.b is not None else 0

    @property
    def batch_split(self) -> bool:
        return self.batch_count > 1

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model group (every rank gets the same bits)."""
        return _AllReduce.apply(t, self.model_group, False)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (whole on every rank of the model group) as it enters a block
        cut over the model axis: the identity, whose gradient is summed over
        the group."""
        return _Enter.apply(t, self.model_group) if _records(t) else t

    def gather(self, t: torch.Tensor, dim: int, reduce: bool = False) -> torch.Tensor:
        """The model group's blocks of ``t`` joined along ``dim``, in rank order.
        The gradient: this rank's slice, right where everything downstream is
        the same on every rank of the group; with ``reduce``, the group's
        gradients summed into this rank's block (a reduce-scatter), for a
        gathered tensor that feeds different work on each rank (the K/V of a
        sequence-parallel attention, MLA's q latent before its cut heads)."""
        return _Gather.apply(t, dim, self.model_group, self.ax.model_size, self.model_index, reduce)

    def scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of ``t``, whole on every rank of the
        model group (the gradient: the group's blocks joined, as each rank's
        downstream holds only its block)."""
        return _Scatter.apply(t, dim, self.model_group, self.ax.model_size, self.model_index)

    def gather_data(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data group's blocks of ``t`` joined along ``dim``, in rank order
        (the gradient: the group's gradients summed, this rank's block): the
        FSDP weight gathers."""
        return _Gather.apply(t, dim, self.data_group, self.data_count, self.data_index, True)

    def gather_batch(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The batch blocks of ``t`` (one a rank of the batch group) joined along ``dim``."""
        return _Gather.apply(t, dim, self.group(self.ax.b), self.batch_count, self.batch_index, True)

    def sum_batch(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks the batch is cut over (the gradient: summed too)."""
        return _AllReduce.apply(t, self.group(self.ax.b), True)

    def cut_axes(self, spec: P) -> tuple[str, ...]:
        """The mesh axes (``"model"``, ``"data"``, ``"pod"``) of more than one
        rank that ``spec`` cuts a leaf over."""
        named = {name for e in spec if e is not None for name in _names(e)}
        return tuple(name for name in (self.ax.model, "data", "pod") if name in named and self.sizes[name] > 1)

    def group(self, entry):
        """The process group of a spec entry: ``"model"``, ``"data"``, ``"pod"``
        or ``("pod", "data")`` (the pod × data ranks)."""
        names = _names(entry)
        if names == (self.ax.model,):
            return self.model_group
        if names == ("data",):
            return self.data_group
        if names == ("pod",):
            return self.pod_group
        if names == ("pod", "data"):
            return self.dp_group
        raise ValueError(f"no process group for the spec entry {entry!r}")

    def _index(self, entry) -> tuple[int, int] | None:
        """(this rank's block, blocks) of a dimension whose spec entry is ``entry``."""
        if entry is None:
            return None
        coords = {"pod": self.pod_index, "data": self.data_index, self.ax.model: self.model_index}
        i = 0
        for name in _names(entry):
            i = i * self.sizes[name] + coords[name]
        return i, block_count(entry, self.sizes)

    def cut(self, t: torch.Tensor, spec: P) -> torch.Tensor:
        """This rank's block of a whole ``t`` placed by ``spec`` (a view)."""
        block = block_shape(t.shape, spec, self.sizes)
        for dim, entry in enumerate(spec):
            if entry is not None:
                t = t.narrow(dim, self._index(entry)[0] * block[dim], block[dim])
        return t

    def join(self, t: torch.Tensor, spec: P) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's block under ``spec``
        (``cut``'s inverse, by all-gathers over the groups)."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                t = _all_gather(t, dim, self.group(entry), self._index(entry)[1])
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


class _Scatter(torch.autograd.Function):
    """This rank's block of ``t`` along ``dim``; the backward all-gathers the
    blocks' gradients over ``group``."""

    @staticmethod
    def forward(ctx, t, dim: int, group, n: int, index: int):
        ctx.dim, ctx.group, ctx.n = dim % t.dim(), group, n
        size = t.shape[ctx.dim] // n
        return t.narrow(ctx.dim, index * size, size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None, None


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
        # divide the model axis)
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


def vocab_block(vocab: int, sh: Shard) -> tuple[int, int]:
    """(first column, columns) of this rank's block of a ``vocab``-wide row
    cut over the model axis in GSPMD's layout: ceil(V / m) columns a rank,
    the last block short or empty. Where m divides V these are the rows of
    the rank's block of the table (``embedding_specs``)."""
    per = -(-vocab // sh.ax.model_size)
    start = min(sh.model_index * per, vocab)
    return start, min(per, vocab - start)


def lm_logits_block(params, x: torch.Tensor, sh: Shard, vocab: int) -> tuple[torch.Tensor, int]:
    """(this rank's block of the fp32 logits (B, L, columns), its first
    column) of ``vocab_block``: the training loss's logits, which stay cut,
    as the reference's ``shard(logits, P(ax.b, None, ax.model))`` keeps
    them. A table cut over the model axis gives the rank's columns as is;
    a whole table (V does not divide the axis) is narrowed to them, and as
    each rank then uses only its columns, the table's gradient is summed
    over the group (``Shard.enter``), as is ``x``'s."""
    start, n = vocab_block(vocab, sh)
    x = sh.enter(x)
    head = "lm_head" in params
    w = params["lm_head"] if head else params["table"]
    if not sh.split(vocab):
        w = sh.enter(w).narrow(1 if head else 0, start, n)
    logits = x @ (w.to(x.dtype) if head else w.to(x.dtype).T)
    return logits.float(), start


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = -1,
                  sh: Shard | None = None, vocab_start: int | None = None) -> torch.Tensor:
    """Mean token NLL; labels == ignore_id are masked. ``sh`` with the batch
    cut: the mean over the whole batch's unmasked labels (the summed NLL and
    the label count summed over the ranks the batch is cut over).
    ``vocab_start``: ``logits`` are this rank's block of the vocabulary's
    columns from that column on (``lm_logits_block``), and the
    log-sum-exp and the gold logit are summed over the model group
    (``_cut_logz_gold``)."""
    logits = logits.float()
    if vocab_start is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    else:
        logz, gold = _cut_logz_gold(logits, labels, vocab_start, sh)
    nll = logz - gold
    mask = (labels != ignore_id).float()
    total, count = torch.sum(nll * mask), torch.sum(mask)
    if sh is not None and sh.batch_split:
        total, count = sh.sum_batch(total), _all_reduce(count, sh.group(sh.ax.b), copy=False)
    return total / torch.clamp(count, min=1.0)


def _cut_logz_gold(logits: torch.Tensor, labels: torch.Tensor, start: int,
                   sh: Shard) -> tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp, gold logit) of each row, whose columns are cut over the
    model group, ``logits`` this rank's from column ``start``: the row's
    max over the group (detached: it only shifts the exponents), the sum of
    ``exp(logits - max)`` summed over the group, and the gold logit from
    the rank that holds the label's column (the others add 0). Both sums
    are ``Shard.psum``, whose backward passes the gradient through: every
    rank's downstream is the same."""
    n = logits.shape[-1]
    peak = logits.detach().amax(-1) if n else logits.new_full(logits.shape[:-1], float("-inf"))
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=sh.model_group)
    logz = torch.log(sh.psum(torch.sum(torch.exp(logits - peak[..., None]), dim=-1))) + peak
    local = labels.long() - start
    hit = (local >= 0) & (local < n)
    gold = (torch.where(hit, torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0], 0.0) if n
            else torch.zeros_like(peak))
    return logz, sh.psum(gold)
