"""Config-driven decoder stack: uniform, MoE, hybrid (Jamba) and
attention-free (RWKV) architectures.

Layers are grouped into *segments* of identical structure, as in the
reference (``build_segments``). The reference stacks each segment's
parameters on a leading repeat axis and runs ``lax.scan`` over it; here a
segment is an ``nn.ModuleList`` with one entry per repeat, and a Python
loop walks it. Parameters keep the reference's names:
``params["seg{i}"][r]["l{j}"]["mixer"]["wq"]`` is the reference's
``params["seg{i}"]["l{j}"]["mixer"]["wq"][r]``.

Every mixer and FFN of the registry is ported: the attention mixers (GQA,
and DeepSeek-V2's MLA), Mamba and RWKV-6's time mix; the dense SwiGLU FFN,
the MoE FFN and RWKV's channel mix. They run for serving (``backbone``,
``prefill``, ``decode_step``, under ``inference_mode``) and for training
(``loss_fn``: the same layers with autograd on, rematerialized as the
reference's ``remat`` asks, through ``torch.utils.checkpoint``). An MoE
layer's router aux loss is summed over the layers and added to the loss,
as in the reference; prefill and decode route at capacity factor 2.0, the
full-sequence forward at the config's.

On a ``(data, model)`` mesh (``Model(cfg, ax=..., mesh=...)``, the mesh
of ``launch.mesh.make_lm_mesh``) each rank holds its block of every
parameter by ``param_specs`` (``Model.place``; ``init`` draws each layer
whole from the one generator and keeps this rank's blocks, so a mesh model
drawn from a seed holds the one-card model's weights, cut) and its block
of every cache by ``cache_specs``; the layer functions take the mesh's
``layers.Shard`` and end each contraction over a cut dimension in an
all-reduce. A spec tree is the reference's: a segment's specs carry a
leading ``None`` for the repeat axis, so the spec of the port's tensor
``params["seg{i}"][r]…`` is the reference leaf's spec without its first
entry (``leaf_specs``). The batch is cut over the data axis when ``ax``
names it. Every layer kind of the registry has a mesh path; the
combinations no registry config reaches and the port does not take raise
on a model axis of more than one rank (``check_mesh``). Where
``seq_sharded_mode`` holds and the axis divides the sequence, the residual
between layers is the reference's sequence-parallel one: a rank holds its
block of L / m rows from the embedding on (``Shard.scatter``), attention
gathers K and V over the sequence, the whole MLP runs on the rank's rows,
and the final-normed hidden is gathered back over the sequence; every
leaf of such a layer is whole, and as a rank applies it to its own rows
only, its gradient is summed over the model group (``Shard.enter`` on the
leaf, ``_Gathered``).

FSDP: with ``data`` > 1 ranks the specs are widened over the data axis by
the reference's ``apply_fsdp`` (``launch.mesh``), decided on the
reference's stacked shapes (``param_shapes``). Each layer gathers its
widened leaves over the data group just before use (``_use``, a
``_Gathered`` view; the gather's backward reduce-scatters the gradient
into the rank's block), inside the layer's own checkpoint: under remat
``full`` the gathered weights do not outlive their layer's forward and
are gathered again in its backward.
``loss_fn`` trains on a mesh: its collectives are autograd Functions
(``layers``) and its cross entropy is the whole batch's mean, taken on
each rank's block of the vocabulary's columns (``layers.lm_logits_block``).

A Mamba or RWKV layer's prefill takes its decode state from the forward's
own scan; the reference runs the scan a second time for it
(``_mamba_final_state``, ``_rwkv_final_state``, kept here as the plain
versions the tests hold the prefill's states against).
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig
from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from .layers import (
    P,
    Axes,
    Shard,
    cross_entropy,
    embed_tokens,
    frozen,
    embedding_init,
    embedding_specs,
    lm_logits,
    lm_logits_block,
    mlp,
    mlp_init,
    mlp_specs,
    rmsnorm,
    rmsnorm_init,
    rmsnorm_specs,
    split_over,
)

REMAT = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str  # "a" (attention) | "m" (mamba) | "r" (rwkv)
    ffn: str  # "dense" | "moe" | "rwkv"


@dataclasses.dataclass(frozen=True)
class Segment:
    repeat: int
    layers: tuple[LayerDesc, ...]


def seq_sharded_mode(cfg: ArchConfig, ax: Axes) -> bool:
    """The reference's sequence-parallel residual stream, used when attention
    heads do NOT divide the model axis (qwen2 14H, llama3.2 24H over 16):
    tokens shard over 'model', MLP weights replicate (``mlp_specs``), and
    only K/V all-gather. It applies to a sequence whose length the axis
    divides (``Model._seq``); other lengths (decode, odd prompts) run the
    attention whole on every rank."""
    return (
        cfg.attention == "gqa"
        and cfg.num_heads > 0
        and ax.model_size > 1
        and cfg.num_heads % ax.model_size != 0
        and cfg.d_model % ax.model_size == 0
    )


def check_mesh(cfg: ArchConfig, ax: Axes) -> None:
    """Raise ``NotImplementedError`` for a combination that has no path on a
    model axis of ``ax.model_size`` > 1 ranks (ROADMAP M5). No config of the
    registry reaches one at model 2, 4 or 16."""
    m = ax.model_size
    if m == 1:
        return
    kinds = set(cfg.pattern())
    missing = None
    if "a" in kinds and cfg.attention == "mla" and cfg.num_heads % m:
        missing = f"MLA whose {cfg.num_heads} heads do not divide the axis"
    elif "r" in kinds and cfg.d_model % m == 0 and rwkv_mod._dims(cfg)[0] % m:
        missing = f"an RWKV time mix whose d_model divides the axis while its {rwkv_mod._dims(cfg)[0]} heads do not"
    elif seq_sharded_mode(cfg, ax) and (kinds != {"a"} or cfg.moe is not None):
        missing = "a Mamba, RWKV or MoE layer in a model whose residual is sequence-cut (seq_sharded_mode)"
    if missing:
        raise NotImplementedError(f"{cfg.name} on a model axis of {m} ranks: {missing} has no mesh path "
                                  "yet (ROADMAP M5)")


def build_segments(cfg: ArchConfig) -> tuple[Segment, ...]:
    pattern = cfg.pattern()
    moe_mask = cfg.moe_layer_mask()
    descs = []
    for i, kind in enumerate(pattern):
        if kind == "r":
            ffn = "rwkv"
        elif moe_mask[i]:
            ffn = "moe"
        else:
            ffn = "dense"
        descs.append(LayerDesc(kind, ffn))
    n = len(descs)
    segments: list[Segment] = []
    i = 0
    while i < n:
        # pick the period with the most repeats (tie -> smallest period):
        # uniform stacks collapse to one segment; a non-repeating prefix
        # (deepseek's first dense layer) becomes its own segment.
        best = (0, None)
        for period in (1, 2, 4, 8, 16):
            if period > n - i:
                break
            blk = tuple(descs[i : i + period])
            reps = 0
            j = i
            while j + period <= n and tuple(descs[j : j + period]) == blk:
                reps += 1
                j += period
            if reps > best[0]:
                best = (reps, blk)
        reps, blk = best
        segments.append(Segment(reps, blk))
        i += reps * len(blk)
    return tuple(segments)


# -----------------------------------------------------------------------------
# single layer
# -----------------------------------------------------------------------------
def _mixer_init(gen: torch.Generator, cfg: ArchConfig, desc: LayerDesc, dtype) -> nn.ParameterDict:
    if desc.mixer == "a":
        return attn.mla_init(gen, cfg, dtype) if cfg.attention == "mla" else attn.gqa_init(gen, cfg, dtype)
    if desc.mixer == "m":
        return mam.mamba_init(gen, cfg, dtype)
    return rwkv_mod.rwkv_time_mix_init(gen, cfg, dtype)


def _ffn_init(gen: torch.Generator, cfg: ArchConfig, desc: LayerDesc, dtype) -> nn.ParameterDict:
    if desc.ffn == "moe":
        return moe_mod.moe_init(gen, cfg, dtype)
    if desc.ffn == "rwkv":
        return rwkv_mod.rwkv_channel_mix_init(gen, cfg, dtype)
    return mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)


def _mixer_specs(ax: Axes, cfg: ArchConfig, desc: LayerDesc) -> dict:
    if desc.mixer == "a":
        return attn.mla_specs(ax, cfg) if cfg.attention == "mla" else attn.gqa_specs(ax, cfg)
    if desc.mixer == "m":
        return mam.mamba_specs(ax, cfg)
    return rwkv_mod.rwkv_time_mix_specs(ax, cfg)


def _ffn_specs(ax: Axes, cfg: ArchConfig, desc: LayerDesc) -> dict:
    if desc.ffn == "moe":
        return moe_mod.moe_specs(ax, cfg)
    if desc.ffn == "rwkv":
        return rwkv_mod.rwkv_channel_mix_specs(ax, cfg)
    return mlp_specs(ax, cfg.d_model, cfg.d_ff, seq_sharded=seq_sharded_mode(cfg, ax))


def layer_specs(ax: Axes, cfg: ArchConfig, desc: LayerDesc) -> dict:
    return {
        "norm1": rmsnorm_specs(),
        "mixer": _mixer_specs(ax, cfg, desc),
        "norm2": rmsnorm_specs(),
        "ffn": _ffn_specs(ax, cfg, desc),
    }


def layer_init(gen: torch.Generator, cfg: ArchConfig, desc: LayerDesc, dtype=torch.float32) -> nn.ModuleDict:
    return nn.ModuleDict({
        "norm1": rmsnorm_init(cfg.d_model, gen.device),
        "mixer": _mixer_init(gen, cfg, desc, dtype),
        "norm2": rmsnorm_init(cfg.d_model, gen.device),
        "ffn": _ffn_init(gen, cfg, desc, dtype),
    })


def _ffn(params, h: torch.Tensor, cfg: ArchConfig, desc: LayerDesc, capacity_factor: float | None = None,
         sh: Shard | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's FFN on h, and its weighted router aux loss (None without
    an MoE FFN). RWKV's channel mix takes a zero token shift before h. The
    dense MLP is whole (no collective) under ``seq_sharded_mode``'s specs."""
    if desc.ffn == "rwkv":
        return rwkv_mod.rwkv_channel_mix(params, h, cfg=cfg, sh=sh), None
    if desc.ffn != "moe":
        whole = sh is None or seq_sharded_mode(cfg, sh.ax)
        return mlp(params, h, None if whole else split_over(sh, cfg.d_ff)), None
    out, aux = moe_mod.moe_ffn(params, h, cfg, capacity_factor, sh)
    m = cfg.moe
    return out, m.router_aux_weight * aux.load_balance + m.router_z_weight * aux.z_loss


def layer_forward(params, x: torch.Tensor, cfg: ArchConfig, desc: LayerDesc,
                  sh: Shard | None = None, seq: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Full-sequence layer. Returns (x, moe_aux): the router aux loss, None
    without an MoE FFN. ``seq``: x is this rank's block of the rows (the
    sequence-parallel residual), and so is the output."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if desc.mixer == "m":
        x = x + mam.mamba_forward(params["mixer"], h, cfg, sh)
    elif desc.mixer == "r":
        x = x + rwkv_mod.rwkv_time_mix(params["mixer"], h, cfg, sh=sh)
    elif cfg.attention == "mla":
        x = x + attn.mla_forward(params["mixer"], h, cfg, sh=sh)
    else:
        x = x + attn.gqa_forward(params["mixer"], h, cfg, sh, seq)
    out, aux = _ffn(params["ffn"], rmsnorm(params["norm2"], x, cfg.norm_eps), cfg, desc, sh=sh)
    return x + out, aux


# -----------------------------------------------------------------------------
# caches (decode)
# -----------------------------------------------------------------------------
Cache = attn.KVCache | attn.MLACache | mam.MambaState | rwkv_mod.RWKVState


def layer_cache_init(cfg: ArchConfig, desc: LayerDesc, batch: int, seq_len: int, dtype=torch.float32,
                     device=None) -> Cache:
    if desc.mixer == "m":
        return mam.mamba_state_init(cfg, batch, dtype, device)
    if desc.mixer == "r":
        return rwkv_mod.rwkv_state_init(cfg, batch, dtype, device)
    if cfg.attention == "mla":
        return attn.mla_cache_init(cfg, batch, seq_len, dtype, device)
    return attn.gqa_cache_init(cfg, batch, seq_len, dtype, device)


def layer_cache_specs(cfg: ArchConfig, desc: LayerDesc, ax: Axes) -> Cache:
    if desc.mixer == "m":
        return mam.mamba_state_specs(cfg, ax)
    if desc.mixer == "r":
        return rwkv_mod.rwkv_state_specs(cfg, ax)
    if cfg.attention == "mla":
        return attn.mla_cache_specs(cfg, ax)
    return attn.gqa_cache_specs(cfg, ax)


def layer_decode(params, x: torch.Tensor, cache: Cache, pos: int, cfg: ArchConfig,
                 desc: LayerDesc, sh: Shard | None = None) -> tuple[torch.Tensor, Cache]:
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if desc.mixer == "m":
        mix, cache = mam.mamba_decode(params["mixer"], h, cache, cfg, sh)
    elif desc.mixer == "r":
        mix, cache = rwkv_mod.rwkv_decode(params["mixer"], params["ffn"], h, cache, cfg, sh)
    elif cfg.attention == "mla":
        mix, cache = attn.mla_decode(params["mixer"], h, cache, pos, cfg, sh)
    else:
        mix, cache = attn.gqa_decode(params["mixer"], h, cache, pos, cfg, sh)
    x = x + mix
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if desc.ffn == "rwkv":
        # the channel mix shifts in the previous token's input, then this token's becomes it
        out = rwkv_mod.rwkv_channel_mix(params["ffn"], h2, x_prev=cache.x_prev_cm, cfg=cfg, sh=sh)
        cache = cache._replace(x_prev_cm=h2[:, 0])
    else:
        out, _ = _ffn(params["ffn"], h2, cfg, desc, capacity_factor=2.0, sh=sh)
    return x + out, cache


def layer_prefill(params, x: torch.Tensor, cfg: ArchConfig, desc: LayerDesc,
                  cache_len: int | None = None, sh: Shard | None = None,
                  seq: bool = False) -> tuple[torch.Tensor, Cache]:
    """Full-seq forward that also emits the decode cache for this layer.
    A Mamba or RWKV layer's state comes from the forward's own scan; the
    token-shift inputs are copies of the last positions. ``seq``: x is this
    rank's block of the rows (``layer_forward``)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if desc.mixer == "m":
        mix, cache = mam.mamba_forward_with_state(params["mixer"], h, cfg, sh)
    elif desc.mixer == "r":
        mix, s = rwkv_mod.rwkv_time_mix_with_state(params["mixer"], h, cfg, sh=sh)
        cache = rwkv_mod.RWKVState(x_prev_tm=h[:, -1].clone(), x_prev_cm=torch.zeros_like(h[:, -1]), s=s)
    elif cfg.attention == "mla":
        mix, cache = attn.mla_prefill(params["mixer"], h, cfg, cache_len, sh)
    else:
        mix, cache = attn.gqa_prefill(params["mixer"], h, cfg, cache_len, sh, seq)
    x = x + mix
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    out, _ = _ffn(params["ffn"], h2, cfg, desc, capacity_factor=2.0, sh=sh)
    if desc.ffn == "rwkv":
        cache = cache._replace(x_prev_cm=h2[:, -1].clone())
    return x + out, cache


def _mamba_final_state(mixer, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The reference's final SSM state after h: the scan run again, as the
    reference's prefill does. The prefill takes the forward's own state;
    this is the plain version the tests hold it against."""
    x, _, d_in, d_state, dt_rank = mam._project(mixer, h, cfg)
    x = F.silu(mam._conv_causal(x, mixer["conv_w"], mixer["conv_b"]))
    dt, b, c, a = mam._ssm_params(mixer, x, d_state, dt_rank)
    h0 = torch.zeros((h.shape[0], d_in, d_state), dtype=torch.float32, device=h.device)
    return mam._ssm_scan(x.float(), dt, b, c, a, h0)[0]


def _rwkv_final_state(mixer, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The reference's final WKV state after h, computed again with r = 0 (r
    never enters the state update); the plain version the tests hold the
    prefill's state against."""
    b, l, _ = h.shape
    nh, hs, _ = rwkv_mod._dims(cfg)
    x_prev = rwkv_mod._shift(h)
    k = rwkv_mod._mix(h, x_prev, mixer["mix_k"]) @ mixer["wk"]
    v = rwkv_mod._mix(h, x_prev, mixer["mix_v"]) @ mixer["wv"]
    w = rwkv_mod._decay(mixer, rwkv_mod._mix(h, x_prev, mixer["mix_w"]))
    kh = k.reshape(b, l, nh, hs).float()
    vh = v.reshape(b, l, nh, hs).float()
    wh = w.reshape(b, l, nh, hs)
    rh = torch.zeros_like(kh)
    s0 = torch.zeros((b, nh, hs, hs), dtype=torch.float32, device=h.device)
    wkv = rwkv_mod._wkv_chunked if l % rwkv_mod._WKV_CHUNK == 0 else rwkv_mod._wkv_naive
    return wkv(rh, kh, vh, wh, mixer["u"], s0)[0]


# -----------------------------------------------------------------------------
# remat
# -----------------------------------------------------------------------------
def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the outputs of matmuls without batch dims, recompute the rest:
    the counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.
    ``torch.einsum`` runs a contraction without batch dims (the QKV and
    output projections) as ``aten.bmm`` over a batch of 1."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_dots_contexts = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _chain(layers, remat: str):
    """``layers`` ((x, aux) -> (x, aux) each) one after the other, each
    checkpointed as ``remat`` asks."""

    def run(x: torch.Tensor, aux: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for layer in layers:
            x, aux = _remat(layer, remat)(x, aux)
        return x, aux

    return run


def _group_of(repeat: int, remat_group: int) -> int:
    """The reference's rule: the largest divisor of a segment's repeat depth
    that is at most ``remat_group``."""
    return max(d for d in range(1, remat_group + 1) if repeat % d == 0)


def _remat(fn, remat: str):
    """``fn`` ((x, aux) -> (x, aux)) checkpointed as ``remat`` asks:
    ``"full"`` keeps only its inputs and recomputes the rest in the backward,
    ``"dots"`` also keeps its batch-free matmuls (so the MoE router's ``mm``
    is kept and the expert ``bmm``s, batched over E > 1, are recomputed),
    ``"none"`` keeps everything."""
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=_dots_contexts)
    return fn


# -----------------------------------------------------------------------------
# the model
# -----------------------------------------------------------------------------
def _with_repeat_axis(tree):
    """A spec tree with a leading ``None`` on every spec (a stacked segment's repeat axis)."""
    if isinstance(tree, P):
        return P(None, *tree)
    if isinstance(tree, dict):
        return {k: _with_repeat_axis(v) for k, v in tree.items()}
    return type(tree)(*(_with_repeat_axis(v) for v in tree))  # a cache NamedTuple


def _flat(tree, prefix: str = "") -> dict[str, P]:
    """A nested dict of specs as {dotted name: spec}."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _on_meta(node: nn.Module) -> nn.Module:
    """A copy of a parameter tree (nested ``ParameterDict`` / ``ModuleDict``)
    whose every parameter is a ``meta`` tensor of the same shape and dtype."""
    if isinstance(node, nn.ParameterDict):
        return frozen(**{k: _on_meta(v) if isinstance(v, nn.Module) else torch.empty(v.shape, dtype=v.dtype,
                                                                                       device="meta")
                         for k, v in node.items()})
    return nn.ModuleDict({k: _on_meta(v) for k, v in node.items()})


class _Gathered(Mapping):
    """A parameter subtree of a FSDP model as the layer functions read it:
    each FSDP leaf gathered whole over the data group when it is first read,
    just before its use. Its gather node then follows the layer's earlier
    ops in autograd's order, so the backward reduce-scatters the leaf's
    gradient as soon as it is complete, and the layer's whole gradients do
    not pile up. ``enter``: each leaf, whole, is applied by this rank to its
    own rows of the sequence only, so its gradient is summed over the model
    group (``Shard.enter``)."""

    def __init__(self, model: "Model", node: nn.Module, prefix: str, enter: bool = False):
        self._model, self._node, self._prefix, self._enter, self._read = model, node, prefix, enter, {}

    def __getitem__(self, key: str):
        if key not in self._read:
            value, name = self._node[key], f"{self._prefix}{key}"
            dims = self._model.fsdp_dims()
            if isinstance(value, nn.Module):
                value = _Gathered(self._model, value, f"{name}.", self._enter)
            else:
                if name in dims:
                    value = self._model.sh.gather_data(value, dims[name])
                if self._enter:
                    value = self._model.sh.enter(value)
            self._read[key] = value
        return self._read[key]

    def __contains__(self, key) -> bool:
        return key in self._node

    def __iter__(self):
        return iter(self._node.keys())

    def __len__(self) -> int:
        return len(self._node)


class Model(nn.Module):
    """The decoder bound to a config. ``init(generator)`` draws the
    parameters on the generator's device; a converted parameter tree can be
    assigned to ``params`` instead (on a mesh, through ``place``). Every
    method runs on the parameters' device; only ``loss_fn`` records autograd.

    ``remat`` (``"full"``, ``"dots"``, ``"none"``) is the reference's
    policy, with one checkpoint a layer (the reference's: one a repeat of a
    segment, which holds a whole period's recomputed activations, and on a
    FSDP mesh its gathered weights, at once). ``remat_group`` g is the
    reference's too: under ``"full"`` or ``"dots"`` one checkpoint holds
    g' consecutive repeats of a segment (g' layers of a one-layer period;
    g' the largest divisor of the segment's repeat depth that is at most
    g), each of its layers checkpointed again inside it (``"full"``), so the
    backward keeps one input per g' repeats and recomputes one layer at a
    time; a layer's FSDP gathers stay inside both. The full-sequence
    forward takes plain attention on every device: the flash kernel has no
    backward.

    ``ax`` is the reference's axis environment, which sets the specs
    (``param_specs``, ``cache_specs``); without a ``mesh`` nothing is cut.
    ``mesh`` (``launch.mesh.LMMesh``) places the model on a ``(data,
    model)`` or ``(pod, data, model)`` mesh of ranks; ``ax`` then defaults
    to the mesh's (batch over ``data``, or the pod × data ranks), and its
    model size must be the mesh's. ``fsdp`` (default: the
    mesh's data ranks) and ``fsdp_min_elems`` are ``apply_fsdp``'s
    ``fsdp_size`` and ``min_elems``; ``fsdp`` 1 widens nothing."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, remat: str = "full", ax: Axes | None = None,
                 mesh=None, fsdp: int | None = None, fsdp_min_elems: int = 1 << 22, remat_group: int = 1):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.remat_group = max(1, remat_group)
        self.segments = build_segments(cfg)
        assert sum(s.repeat * len(s.layers) for s in self.segments) == cfg.num_layers
        self.params: nn.ModuleDict | None = None
        model_size = mesh.model_count if mesh is not None else 1
        batch = ("pod", "data") if mesh is not None and mesh.pod_count > 1 else ("data",)
        self.ax = ax or Axes(batch=batch, model="model", model_size=model_size)
        self.sh: Shard | None = None
        self.fsdp = 1 if mesh is None else (mesh.data_count if fsdp is None else fsdp)
        self.fsdp_min_elems = fsdp_min_elems
        if self.fsdp > 1 and self.fsdp != mesh.data_count:
            raise ValueError(f"fsdp over {self.fsdp} ranks on a mesh of {mesh.data_count} data ranks")
        self._specs: dict[str, P] | None = None
        self._dims: dict[str, int] | None = None
        if mesh is not None:
            if self.ax.model_size != mesh.model_count:
                raise ValueError(f"axes of model size {self.ax.model_size} on a mesh of {mesh.model_count} model ranks")
            check_mesh(cfg, self.ax)
            self.sh = Shard(self.ax, mesh.model_group, mesh.model_index, mesh.data_group, mesh.data_index,
                            mesh.data_count, mesh.dp_group, mesh.pod_group, mesh.pod_index, mesh.pod_count)

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    # ---- specs ----------------------------------------------------------------
    def param_specs(self) -> dict:
        """The reference's ``Model.param_specs``: the embedding's and final
        norm's specs, and each segment's layer specs with a leading ``None``."""
        cfg, ax = self.cfg, self.ax
        p = {"embed": embedding_specs(ax, cfg.vocab_size, cfg.tie_embeddings), "final_norm": rmsnorm_specs()}
        for si, seg in enumerate(self.segments):
            p[f"seg{si}"] = _with_repeat_axis({f"l{i}": layer_specs(ax, cfg, d) for i, d in enumerate(seg.layers)})
        return p

    def cache_specs(self) -> dict:
        """The reference's ``Model.cache_specs``, by segment and layer."""
        return {f"seg{si}": _with_repeat_axis({f"l{i}": layer_cache_specs(self.cfg, d, self.ax)
                                                for i, d in enumerate(seg.layers)})
                for si, seg in enumerate(self.segments)}

    def param_shapes(self) -> dict:
        """The reference's parameter shapes (``jax.eval_shape(Model.init)``):
        a segment's leaves stacked on a leading repeat axis. One repeat of
        each segment is drawn on fake tensors (no memory)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        cfg, gen = self.cfg, torch.Generator()

        def shapes(node, lead=()):
            return {k: shapes(v, lead) if isinstance(v, nn.Module) else (*lead, *v.shape) for k, v in node.items()}

        with FakeTensorMode():
            tree = {"embed": shapes(embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings, self.dtype)),
                    "final_norm": shapes(rmsnorm_init(cfg.d_model, gen.device))}
            for si, seg in enumerate(self.segments):
                tree[f"seg{si}"] = {f"l{i}": shapes(layer_init(gen, cfg, d, self.dtype), (seg.repeat,))
                                    for i, d in enumerate(seg.layers)}
        return tree

    def placed_specs(self) -> dict:
        """The spec tree this model places its parameters by: ``param_specs``,
        widened over the data axis by ``apply_fsdp`` when ``fsdp`` > 1."""
        from repro_torch.launch.mesh import apply_fsdp  # launch.mesh imports models

        if self.fsdp == 1:
            return self.param_specs()
        return apply_fsdp(self.param_specs(), self.param_shapes(), "data", self.fsdp, self.fsdp_min_elems)

    def _unstacked(self, tree: dict) -> dict:
        """A tree in the reference's stacked layout (a segment's leaves with a
        leading repeat entry: specs or shapes) by the port's parameter names:
        a segment's ``seg{i}.{r}.l{j}.…`` takes the leaf without its repeat
        entry."""
        out = {}
        for name, leaf in _flat(tree).items():
            if not name.startswith("seg"):
                out[name] = leaf
                continue
            si, rest = name.split(".", 1)
            for r in range(self.segments[int(si[3:])].repeat):
                out[f"{si}.{r}.{rest}"] = P(*leaf[1:]) if isinstance(leaf, P) else tuple(leaf[1:])
        return out

    def leaf_specs(self) -> dict[str, P]:
        """Each parameter's spec by the port's parameter name (of
        ``placed_specs``, ``_unstacked``)."""
        if self._specs is None:
            specs = self.placed_specs()
            for name, spec in _flat(specs).items():
                if name.startswith("seg") and spec[0] is not None:
                    raise NotImplementedError(f"{name}: FSDP over a segment's repeat axis ({spec}) has no "
                                              "per-repeat layout (ROADMAP M5)")
            self._specs = self._unstacked(specs)
        return self._specs

    def leaf_shapes(self) -> dict[str, tuple[int, ...]]:
        """Each parameter's whole shape by the port's parameter name (of
        ``param_shapes``, ``_unstacked``)."""
        return self._unstacked(self.param_shapes())

    def fsdp_dims(self) -> dict[str, int]:
        """{parameter name: the dimension cut over the data axis} of the FSDP leaves."""
        if self._dims is None:
            self._dims = {name: dim for name, spec in self.leaf_specs().items() for dim, e in enumerate(spec)
                          if e is not None and e != self.ax.model} if self.fsdp > 1 else {}
        return self._dims

    def _use(self, node: nn.Module, prefix: str, seq: bool = False):
        """``node`` (a subtree of ``params`` at ``prefix``) as the layer
        functions read it: the module itself without FSDP leaves and outside
        the sequence-parallel residual (``seq``), else a ``_Gathered`` view
        of it."""
        return _Gathered(self, node, prefix, seq) if self.fsdp_dims() or seq else node

    def _seq(self, length: int) -> bool:
        """Whether the residual of a ``length``-token sequence is cut over the
        model axis: the reference's sequence-parallel residual
        (``seq_sharded_mode``, where the axis divides the length)."""
        return self.sh is not None and seq_sharded_mode(self.cfg, self.ax) and length % self.ax.model_size == 0

    def _relaid(self, name: str) -> bool:
        """Whether this rank's block of parameter ``name`` is a re-laid Mamba ``in_proj``."""
        return self.sh is not None and name.endswith("mixer.in_proj") and self.sh.split(mam._dims(self.cfg)[0])

    def place(self, params: nn.Module, prefix: str = "") -> nn.Module:
        """Cut every parameter of ``params`` (a whole tree, or the subtree
        at ``prefix``) to this rank's block by its spec, in place: a
        contiguous copy, so the whole tensor can be freed. A Mamba
        ``in_proj``'s block is laid out as [x_r | z_r]
        (``mamba.in_proj_layout``). No-op without a mesh."""
        if self.sh is None:
            return params
        for name, param in params.named_parameters(prefix=prefix.rstrip(".")):
            param.data = self.cut_leaf(name, param.data).clone()
        return params

    def cut_leaf(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block (a view where it can be) of a whole tensor laid
        out as parameter ``name`` (the parameter, its gradient or a moment),
        as ``place`` cuts it; ``whole`` itself without a mesh."""
        if self.sh is None:
            return whole
        if self._relaid(name):
            whole = mam.in_proj_layout(whole, self.ax.model_size)
        return self.sh.cut(whole, self.leaf_specs()[name])

    def join_leaf(self, name: str, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``block`` is this rank's block of
        parameter ``name`` (``cut_leaf``'s inverse; every rank of the mesh
        must call it)."""
        if self.sh is None:
            return block
        whole = self.sh.join(block, self.leaf_specs()[name])
        return mam.in_proj_layout(whole, self.ax.model_size, inverse=True) if self._relaid(name) else whole

    def gather(self, params) -> dict[str, torch.Tensor]:
        """{name: whole tensor} of this rank's blocks ``params`` (a parameter
        tree, or a mapping of parameter name to block, such as gradients),
        joined over the mesh's groups (``place``'s inverse; every rank of the
        mesh must call it)."""
        named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
        return {name: self.join_leaf(name, p.detach()) for name, p in named}

    # ---- init -----------------------------------------------------------------
    def init(self, gen: torch.Generator) -> nn.ModuleDict:
        """Draw every parameter from ``gen``, in order: embedding, then each
        segment's repeats and layers. On a mesh each of these is drawn whole
        and cut to this rank's blocks at once (the transient is one layer)."""
        cfg = self.cfg
        p = {
            "embed": self.place(embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings, self.dtype),
                                "embed"),
            "final_norm": rmsnorm_init(cfg.d_model, gen.device),
        }
        for si, seg in enumerate(self.segments):
            p[f"seg{si}"] = nn.ModuleList(
                nn.ModuleDict({f"l{i}": self.place(layer_init(gen, cfg, d, self.dtype), f"seg{si}.{r}.l{i}")
                               for i, d in enumerate(seg.layers)})
                for r in range(seg.repeat)
            )
        self.params = nn.ModuleDict(p)
        return self.params

    def init_meta(self) -> nn.ModuleDict:
        """``init``'s tree on the ``meta`` device, with no values and no
        memory: the embedding and one repeat of each segment drawn on fake
        tensors (as ``param_shapes`` draws) and placed by the specs, then
        every repeat given ``meta`` blocks of those shapes and dtypes (a
        segment's repeats are placed alike). What the dry run
        (``launch.dryrun``) steps."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        cfg, gen = self.cfg, torch.Generator()
        with FakeTensorMode():
            embed = self.place(embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings, self.dtype),
                               "embed")
            norm = rmsnorm_init(cfg.d_model, gen.device)
            first = [{f"l{i}": self.place(layer_init(gen, cfg, d, self.dtype), f"seg{si}.0.l{i}")
                      for i, d in enumerate(seg.layers)} for si, seg in enumerate(self.segments)]
        p = {"embed": _on_meta(embed), "final_norm": _on_meta(norm)}
        for si, seg in enumerate(self.segments):
            p[f"seg{si}"] = nn.ModuleList(nn.ModuleDict({k: _on_meta(v) for k, v in first[si].items()})
                                          for _ in range(seg.repeat))
        self.params = nn.ModuleDict(p)
        return self.params

    def _layers(self):
        """(layer params, desc, segment index, repeat, layer name) in depth order."""
        for si, seg in enumerate(self.segments):
            for r, rep in enumerate(self.params[f"seg{si}"]):
                for i, d in enumerate(seg.layers):
                    yield rep[f"l{i}"], d, si, r, f"l{i}"

    # ---- forward --------------------------------------------------------------
    def _layer(self, params: nn.ModuleDict, desc: LayerDesc, prefix: str, seq: bool, x: torch.Tensor,
               aux: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One layer, adding its router aux loss (an MoE layer's) to the
        carried ``aux``, as the reference's scan body; its FSDP leaves are
        gathered inside (``_use``)."""
        x, a = layer_forward(self._use(params, prefix, seq), x, self.cfg, desc, self.sh, seq)
        return x, aux if a is None else aux + a

    def hidden(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L, d) -> (final-normed hidden, moe_aux): the weighted router
        aux losses summed over the layers (0 without an MoE layer). Where
        autograd records, each layer is checkpointed as ``remat`` asks,
        with the carried aux its second input and output; elsewhere it runs
        straight. On the sequence-parallel residual (``_seq``) the layers run
        on this rank's block of the rows, and the final-normed hidden is
        gathered back over the sequence."""
        seq = self._seq(x.shape[1])
        if seq:
            x = self.sh.scatter(x, 1)
        remat = self.remat if torch.is_grad_enabled() else "none"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, seg in enumerate(self.segments):
            reps = self.params[f"seg{si}"]
            g = _group_of(seg.repeat, self.remat_group) if remat != "none" else 1
            for r0 in range(0, seg.repeat, g):
                layers = [functools.partial(self._layer, reps[r][f"l{i}"], d, f"seg{si}.{r}.l{i}.", seq)
                          for r in range(r0, r0 + g) for i, d in enumerate(seg.layers)]
                run = _chain(layers, remat) if g == 1 else _remat(_chain(layers, "full"), remat)
                x, aux = run(x, aux)
        h = rmsnorm(self._use(self.params["final_norm"], "final_norm.", seq), x, self.cfg.norm_eps)
        return (self.sh.gather(h, 1) if seq else h), aux

    @torch.inference_mode()
    def backbone(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L, d) -> (hidden, moe_aux), for serving."""
        return self.hidden(x)

    def loss_fn(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token NLL of ``batch`` (``tokens``, ``labels``, and
        ``embeds`` for an embeddings arch) plus the MoE aux loss; autograd
        records it wherever grad mode is on. On a mesh ``batch`` holds this
        rank's rows, and the loss is the whole batch's, the same on every rank;
        on a model axis of more than one rank the logits stay cut over the
        vocabulary (``lm_logits_block``): no rank holds a whole row."""
        h, aux = self.hidden(self.embed_input(batch))
        if self.sh is None or self.ax.model_size == 1:
            return cross_entropy(self.logits(h), batch["labels"], sh=self.sh) + aux
        logits, start = lm_logits_block(self._use(self.params["embed"], "embed."), h, self.sh, self.cfg.vocab_size)
        return cross_entropy(logits, batch["labels"], sh=self.sh, vocab_start=start) + aux

    def embed_input(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        if self.cfg.input_mode == "embeddings" and "embeds" in batch:
            return batch["embeds"].to(self.dtype)
        return embed_tokens(self._use(self.params["embed"], "embed."), batch["tokens"],
                            split_over(self.sh, self.cfg.vocab_size))

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """fp32 logits over the whole vocabulary (gathered on a mesh)."""
        return lm_logits(self._use(self.params["embed"], "embed."), h, split_over(self.sh, self.cfg.vocab_size))

    # ---- prefill / decode -----------------------------------------------------
    def cache_init(self, batch: int, seq_len: int) -> dict[str, list[dict[str, Cache]]]:
        """Zero caches for ``batch`` rows (on a mesh: the whole batch's, of
        which this rank keeps its blocks by ``cache_specs``)."""
        caches: dict[str, list] = {}
        specs = self.cache_specs()
        for si, seg in enumerate(self.segments):
            caches[f"seg{si}"] = []
            for _ in range(seg.repeat):
                rep = {}
                for i, d in enumerate(seg.layers):
                    cache = layer_cache_init(self.cfg, d, batch, seq_len, self.dtype, self.device)
                    if self.sh is not None:
                        spec = specs[f"seg{si}"][f"l{i}"]
                        cache = type(cache)(*(self.sh.cut(t, P(*sp[1:])).clone() for t, sp in zip(cache, spec)))
                    rep[f"l{i}"] = cache
                caches[f"seg{si}"].append(rep)
        return caches

    @torch.inference_mode()
    def prefill(self, batch: dict[str, torch.Tensor], cache_len: int | None = None):
        """Returns (last-token logits (B, 1, V), caches with ``cache_len`` decode capacity).
        On a mesh ``batch`` holds this rank's rows (its data block of the
        batch when ``ax`` cuts it), and so do the logits and caches."""
        x = self.embed_input(batch)
        seq = self._seq(x.shape[1])
        if seq:  # this rank's block of the rows; the last row is the last rank's
            x = self.sh.scatter(x, 1)
        caches = {f"seg{si}": [{} for _ in range(seg.repeat)] for si, seg in enumerate(self.segments)}
        for params, d, si, r, name in self._layers():
            x, caches[f"seg{si}"][r][name] = layer_prefill(self._use(params, f"seg{si}.{r}.{name}."), x, self.cfg, d,
                                                           cache_len, self.sh, seq)
        h = rmsnorm(self._use(self.params["final_norm"], "final_norm."), x[:, -1:], self.cfg.norm_eps)
        return self.logits(self.sh.gather(h, 1)[:, -1:] if seq else h), caches

    @torch.inference_mode()
    def decode_step(self, caches, tokens: torch.Tensor, pos: int):
        """tokens: (B, 1) int; pos: absolute position. Returns (logits (B, 1, V), caches);
        the caches are updated in place."""
        x = embed_tokens(self._use(self.params["embed"], "embed."), tokens, split_over(self.sh, self.cfg.vocab_size))
        for params, d, si, r, name in self._layers():
            seg_cache = caches[f"seg{si}"][r]
            x, seg_cache[name] = layer_decode(self._use(params, f"seg{si}.{r}.{name}."), x, seg_cache[name], pos,
                                              self.cfg, d, self.sh)
        h = rmsnorm(self._use(self.params["final_norm"], "final_norm."), x, self.cfg.norm_eps)
        return self.logits(h), caches
