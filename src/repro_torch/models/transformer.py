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

A Mamba or RWKV layer's prefill takes its decode state from the forward's
own scan; the reference runs the scan a second time for it
(``_mamba_final_state``, ``_rwkv_final_state``, kept here as the plain
versions the tests hold the prefill's states against).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig
from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from .layers import cross_entropy, embed_tokens, embedding_init, lm_logits, mlp, mlp_init, rmsnorm, rmsnorm_init

REMAT = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str  # "a" (attention) | "m" (mamba) | "r" (rwkv)
    ffn: str  # "dense" | "moe" | "rwkv"


@dataclasses.dataclass(frozen=True)
class Segment:
    repeat: int
    layers: tuple[LayerDesc, ...]


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


def layer_init(gen: torch.Generator, cfg: ArchConfig, desc: LayerDesc, dtype=torch.float32) -> nn.ModuleDict:
    return nn.ModuleDict({
        "norm1": rmsnorm_init(cfg.d_model, gen.device),
        "mixer": _mixer_init(gen, cfg, desc, dtype),
        "norm2": rmsnorm_init(cfg.d_model, gen.device),
        "ffn": _ffn_init(gen, cfg, desc, dtype),
    })


def _ffn(params, h: torch.Tensor, cfg: ArchConfig, desc: LayerDesc,
         capacity_factor: float | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's FFN on h, and its weighted router aux loss (None without
    an MoE FFN). RWKV's channel mix takes a zero token shift before h."""
    if desc.ffn == "rwkv":
        return rwkv_mod.rwkv_channel_mix(params, h), None
    if desc.ffn != "moe":
        return mlp(params, h), None
    out, aux = moe_mod.moe_ffn(params, h, cfg, capacity_factor)
    m = cfg.moe
    return out, m.router_aux_weight * aux.load_balance + m.router_z_weight * aux.z_loss


def layer_forward(params, x: torch.Tensor, cfg: ArchConfig,
                  desc: LayerDesc) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Full-sequence layer. Returns (x, moe_aux): the router aux loss, None without an MoE FFN."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if desc.mixer == "m":
        x = x + mam.mamba_forward(params["mixer"], h, cfg)
    elif desc.mixer == "r":
        x = x + rwkv_mod.rwkv_time_mix(params["mixer"], h, cfg)
    elif cfg.attention == "mla":
        x = x + attn.mla_forward(params["mixer"], h, cfg)
    else:
        x = x + attn.gqa_forward(params["mixer"], h, cfg)
    out, aux = _ffn(params["ffn"], rmsnorm(params["norm2"], x, cfg.norm_eps), cfg, desc)
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


def layer_decode(params, x: torch.Tensor, cache: Cache, pos: int, cfg: ArchConfig,
                 desc: LayerDesc) -> tuple[torch.Tensor, Cache]:
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if desc.mixer == "m":
        mix, cache = mam.mamba_decode(params["mixer"], h, cache, cfg)
    elif desc.mixer == "r":
        mix, cache = rwkv_mod.rwkv_decode(params["mixer"], params["ffn"], h, cache, cfg)
    elif cfg.attention == "mla":
        mix, cache = attn.mla_decode(params["mixer"], h, cache, pos, cfg)
    else:
        mix, cache = attn.gqa_decode(params["mixer"], h, cache, pos, cfg)
    x = x + mix
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if desc.ffn == "rwkv":
        # the channel mix shifts in the previous token's input, then this token's becomes it
        out = rwkv_mod.rwkv_channel_mix(params["ffn"], h2, x_prev=cache.x_prev_cm)
        cache = cache._replace(x_prev_cm=h2[:, 0])
    else:
        out, _ = _ffn(params["ffn"], h2, cfg, desc, capacity_factor=2.0)
    return x + out, cache


def layer_prefill(params, x: torch.Tensor, cfg: ArchConfig, desc: LayerDesc,
                  cache_len: int | None = None) -> tuple[torch.Tensor, Cache]:
    """Full-seq forward that also emits the decode cache for this layer.
    A Mamba or RWKV layer's state comes from the forward's own scan; the
    token-shift inputs are copies of the last positions."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if desc.mixer == "m":
        mix, cache = mam.mamba_forward_with_state(params["mixer"], h, cfg)
    elif desc.mixer == "r":
        mix, s = rwkv_mod.rwkv_time_mix_with_state(params["mixer"], h, cfg)
        cache = rwkv_mod.RWKVState(x_prev_tm=h[:, -1].clone(), x_prev_cm=torch.zeros_like(h[:, -1]), s=s)
    elif cfg.attention == "mla":
        mix, cache = attn.mla_prefill(params["mixer"], h, cfg, cache_len)
    else:
        mix, cache = attn.gqa_prefill(params["mixer"], h, cfg, cache_len)
    x = x + mix
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    out, _ = _ffn(params["ffn"], h2, cfg, desc, capacity_factor=2.0)
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
class Model(nn.Module):
    """The decoder bound to a config. ``init(generator)`` draws the
    parameters on the generator's device; a converted parameter tree can be
    assigned to ``params`` instead. Every method runs on the parameters'
    device; only ``loss_fn`` records autograd.

    ``remat`` (``"full"``, ``"dots"``, ``"none"``) is the reference's, one
    checkpoint per repeat of a segment. The full-sequence forward takes
    plain attention on every device: the flash kernel has no backward."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, remat: str = "full"):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.segments = build_segments(cfg)
        assert sum(s.repeat * len(s.layers) for s in self.segments) == cfg.num_layers
        self.params: nn.ModuleDict | None = None

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    # ---- init -----------------------------------------------------------------
    def init(self, gen: torch.Generator) -> nn.ModuleDict:
        """Draw every parameter from ``gen``, in order: embedding, then each
        segment's repeats and layers."""
        cfg = self.cfg
        p = {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings, self.dtype),
            "final_norm": rmsnorm_init(cfg.d_model, gen.device),
        }
        for si, seg in enumerate(self.segments):
            p[f"seg{si}"] = nn.ModuleList(
                nn.ModuleDict({f"l{i}": layer_init(gen, cfg, d, self.dtype) for i, d in enumerate(seg.layers)})
                for _ in range(seg.repeat)
            )
        self.params = nn.ModuleDict(p)
        return self.params

    def _layers(self):
        """(layer params, desc, segment index, repeat, layer name) in depth order."""
        for si, seg in enumerate(self.segments):
            for r, rep in enumerate(self.params[f"seg{si}"]):
                for i, d in enumerate(seg.layers):
                    yield rep[f"l{i}"], d, si, r, f"l{i}"

    # ---- forward --------------------------------------------------------------
    def _repeat(self, seg: Segment, rep: nn.ModuleDict, x: torch.Tensor,
                aux: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One repeat of a segment: its layers in order, each adding its
        router aux loss (an MoE layer's) to the carried ``aux``, as the
        reference's scan body."""
        for i, d in enumerate(seg.layers):
            x, a = layer_forward(rep[f"l{i}"], x, self.cfg, d)
            if a is not None:
                aux = aux + a
        return x, aux

    def hidden(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L, d) -> (final-normed hidden, moe_aux): the weighted router
        aux losses summed over the layers (0 without an MoE layer). Where
        autograd records, each repeat is checkpointed as ``remat`` asks,
        with the carried aux its second input and output; elsewhere it runs
        straight."""
        remat = self.remat if torch.is_grad_enabled() else "none"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, seg in enumerate(self.segments):
            for rep in self.params[f"seg{si}"]:
                x, aux = _remat(functools.partial(self._repeat, seg, rep), remat)(x, aux)
        return rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps), aux

    @torch.inference_mode()
    def backbone(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L, d) -> (hidden, moe_aux), for serving."""
        return self.hidden(x)

    def loss_fn(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token NLL of ``batch`` (``tokens``, ``labels``, and
        ``embeds`` for an embeddings arch) plus the MoE aux loss; autograd
        records it wherever grad mode is on."""
        h, aux = self.hidden(self.embed_input(batch))
        return cross_entropy(self.logits(h), batch["labels"]) + aux

    def embed_input(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        if self.cfg.input_mode == "embeddings" and "embeds" in batch:
            return batch["embeds"].to(self.dtype)
        return embed_tokens(self.params["embed"], batch["tokens"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return lm_logits(self.params["embed"], h)

    # ---- prefill / decode -----------------------------------------------------
    def cache_init(self, batch: int, seq_len: int) -> dict[str, list[dict[str, Cache]]]:
        caches: dict[str, list] = {}
        for si, seg in enumerate(self.segments):
            caches[f"seg{si}"] = [
                {f"l{i}": layer_cache_init(self.cfg, d, batch, seq_len, self.dtype, self.device)
                 for i, d in enumerate(seg.layers)}
                for _ in range(seg.repeat)
            ]
        return caches

    @torch.inference_mode()
    def prefill(self, batch: dict[str, torch.Tensor], cache_len: int | None = None):
        """Returns (last-token logits (B, 1, V), caches with ``cache_len`` decode capacity)."""
        x = self.embed_input(batch)
        caches = {f"seg{si}": [{} for _ in range(seg.repeat)] for si, seg in enumerate(self.segments)}
        for params, d, si, r, name in self._layers():
            x, caches[f"seg{si}"][r][name] = layer_prefill(params, x, self.cfg, d, cache_len)
        h = rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)
        return self.logits(h[:, -1:]), caches

    @torch.inference_mode()
    def decode_step(self, caches, tokens: torch.Tensor, pos: int):
        """tokens: (B, 1) int; pos: absolute position. Returns (logits (B, 1, V), caches);
        the caches are updated in place."""
        x = embed_tokens(self.params["embed"], tokens)
        for params, d, si, r, name in self._layers():
            seg_cache = caches[f"seg{si}"][r]
            x, seg_cache[name] = layer_decode(params, x, seg_cache[name], pos, self.cfg, d)
        h = rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)
        return self.logits(h), caches
