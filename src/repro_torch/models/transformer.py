"""Config-driven decoder stack: the dense GQA transformer.

Layers are grouped into *segments* of identical structure, as in the
reference (``build_segments``). The reference stacks each segment's
parameters on a leading repeat axis and runs ``lax.scan`` over it; here a
segment is an ``nn.ModuleList`` with one entry per repeat, and a Python
loop walks it. Parameters keep the reference's names:
``params["seg{i}"][r]["l{j}"]["mixer"]["wq"]`` is the reference's
``params["seg{i}"]["l{j}"]["mixer"]["wq"][r]``.

Ported: the attention mixer (GQA) and the dense SwiGLU FFN. MLA, Mamba,
RWKV and MoE raise ``NotImplementedError`` (ROADMAP Queue 1 item 15), and
so does nothing else silently run in their place. Training (``loss_fn``,
``cross_entropy``, remat) is not ported yet either.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from . import attention as attn
from .layers import embed_tokens, embedding_init, lm_logits, mlp, mlp_init, rmsnorm, rmsnorm_init

_UNPORTED = "is not ported yet (ROADMAP Queue 1 item 15)"


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


def check_ported(cfg: ArchConfig, desc: LayerDesc) -> None:
    """Raise for a mixer or FFN kind the port does not have."""
    if desc.mixer == "a" and cfg.attention == "mla":
        raise NotImplementedError(f"{cfg.name}: the MLA attention mixer {_UNPORTED}")
    if desc.mixer == "m":
        raise NotImplementedError(f"{cfg.name}: the Mamba mixer {_UNPORTED}")
    if desc.mixer == "r" or desc.ffn == "rwkv":
        raise NotImplementedError(f"{cfg.name}: the RWKV time and channel mix {_UNPORTED}")
    if desc.ffn == "moe":
        raise NotImplementedError(f"{cfg.name}: the MoE FFN {_UNPORTED}")
    if desc.mixer != "a" or desc.ffn != "dense":
        raise NotImplementedError(f"{cfg.name}: layer {desc} {_UNPORTED}")


# -----------------------------------------------------------------------------
# single layer
# -----------------------------------------------------------------------------
def layer_init(gen: torch.Generator, cfg: ArchConfig, desc: LayerDesc, dtype=torch.float32) -> nn.ModuleDict:
    check_ported(cfg, desc)
    return nn.ModuleDict({
        "norm1": rmsnorm_init(cfg.d_model, gen.device),
        "mixer": attn.gqa_init(gen, cfg, dtype),
        "norm2": rmsnorm_init(cfg.d_model, gen.device),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
    })


def layer_forward(params, x: torch.Tensor, cfg: ArchConfig, desc: LayerDesc) -> torch.Tensor:
    """Full-sequence layer."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(params["mixer"], h, cfg)
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h2)


# -----------------------------------------------------------------------------
# caches (decode)
# -----------------------------------------------------------------------------
def layer_cache_init(cfg: ArchConfig, desc: LayerDesc, batch: int, seq_len: int, dtype=torch.float32,
                     device=None) -> attn.KVCache:
    return attn.gqa_cache_init(cfg, batch, seq_len, dtype, device)


def layer_decode(params, x: torch.Tensor, cache: attn.KVCache, pos: int, cfg: ArchConfig,
                 desc: LayerDesc) -> tuple[torch.Tensor, attn.KVCache]:
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    mix, cache = attn.gqa_decode(params["mixer"], h, cache, pos, cfg)
    x = x + mix
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h2), cache


def layer_prefill(params, x: torch.Tensor, cfg: ArchConfig, desc: LayerDesc,
                  cache_len: int | None = None) -> tuple[torch.Tensor, attn.KVCache]:
    """Full-seq forward that also emits the decode cache for this layer."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    mix, cache = attn.gqa_prefill(params["mixer"], h, cfg, cache_len)
    x = x + mix
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp(params["ffn"], h2), cache


# -----------------------------------------------------------------------------
# the model
# -----------------------------------------------------------------------------
class Model(nn.Module):
    """The decoder bound to a config. ``init(generator)`` draws the
    parameters on the generator's device; a converted parameter tree can be
    assigned to ``params`` instead. Every method runs on the parameters'
    device, without autograd."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.segments = build_segments(cfg)
        assert sum(s.repeat * len(s.layers) for s in self.segments) == cfg.num_layers
        for seg in self.segments:
            for desc in seg.layers:
                check_ported(cfg, desc)
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
    @torch.inference_mode()
    def backbone(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L, d) -> (hidden, moe_aux); aux is 0 (no MoE layer is ported)."""
        for params, d, *_ in self._layers():
            x = layer_forward(params, x, self.cfg, d)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps), aux

    def embed_input(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        if self.cfg.input_mode == "embeddings" and "embeds" in batch:
            return batch["embeds"].to(self.dtype)
        return embed_tokens(self.params["embed"], batch["tokens"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return lm_logits(self.params["embed"], h)

    # ---- prefill / decode -----------------------------------------------------
    def cache_init(self, batch: int, seq_len: int) -> dict[str, list[dict[str, attn.KVCache]]]:
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
