"""Architecture & shape configuration schema for the LM substrate.

Every assigned architecture is a frozen ``ArchConfig``; input shapes are
``ShapeConfig`` rows. ``registry()`` maps --arch ids to configs.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # expert FFN hidden dim
    num_shared: int = 0  # always-on shared experts (DeepSeek-style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    router_z_weight: float = 0.0001
    # which layers are MoE: "all", "every_2" (odd layers), or "after_first"
    layer_rule: str = "all"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba block dims (Jamba mixer)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64  # rank of the data-dependent decay projection
    token_shift: bool = True


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "vlm", "hybrid", "ssm", "audio"]
    num_layers: int
    d_model: int
    num_heads: int  # query heads (0 for attention-free archs)
    num_kv_heads: int
    d_ff: int  # dense-FFN hidden (for MoE archs: the dense layers' width)
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    attention: Literal["gqa", "mla", "none"] = "gqa"
    window: int | None = None  # sliding-window attention width
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    # hybrid layer pattern, repeated to num_layers: e.g. Jamba period-8
    # ("m","m","m","a","m","m","m","m") — "a"=attention, "m"=mamba
    layer_pattern: tuple[str, ...] | None = None
    # modality frontend: "tokens" or "embeddings" (vlm/audio stub supplies
    # precomputed patch/frame embeddings for train/prefill)
    input_mode: Literal["tokens", "embeddings"] = "tokens"
    # which shapes need sub-quadratic attention support (long_500k)
    subquadratic: bool = False
    notes: str = ""

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def pattern(self) -> tuple[str, ...]:
        """Per-layer mixer types, length num_layers."""
        if self.layer_pattern is None:
            base = ("a",) if self.attention != "none" else ("r",)
            return base * self.num_layers
        reps = -(-self.num_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.num_layers]

    def moe_layer_mask(self) -> tuple[bool, ...]:
        """True where the FFN is MoE."""
        if self.moe is None:
            return (False,) * self.num_layers
        rule = self.moe.layer_rule
        if rule == "all":
            return (True,) * self.num_layers
        if rule == "every_2":
            return tuple(i % 2 == 1 for i in range(self.num_layers))
        if rule == "after_first":
            return tuple(i >= 1 for i in range(self.num_layers))
        raise ValueError(rule)

    def param_count(self) -> int:
        """Total parameters (embedding + per-layer), for roofline MODEL_FLOPS."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim()
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm_head
        moe_mask = self.moe_layer_mask()
        for i, kind in enumerate(self.pattern()):
            total += 2 * d  # norms
            if kind == "a":
                if self.attention == "mla" and self.mla is not None:
                    m = self.mla
                    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_head
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    total += self.num_heads * m.v_head_dim * d
                else:
                    total += d * self.num_heads * hd  # q
                    total += 2 * d * self.num_kv_heads * hd  # k, v
                    total += self.num_heads * hd * d  # o
            elif kind == "m":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                dt_rank = s.dt_rank or -(-d // 16)
                total += d * 2 * d_in  # in_proj
                total += d_in * s.d_conv  # conv
                total += d_in * (dt_rank + 2 * s.d_state)  # x_proj
                total += dt_rank * d_in + d_in  # dt_proj
                total += d_in * (s.d_state + 2)  # A_log, D
                total += d_in * d  # out_proj
            elif kind == "r":
                r = self.rwkv or RWKVConfig()
                total += 4 * d * d  # r, k, v, output
                total += d * d  # gate
                total += 2 * d * r.decay_lora  # data-dependent decay lora
                total += 6 * d  # mixes, u, etc (approx)
            if moe_mask[i] and self.moe is not None:
                e = self.moe
                total += d * e.num_experts  # router
                total += (e.num_experts + e.num_shared) * 3 * d * e.d_expert
            else:
                total += 3 * d * self.d_ff  # SwiGLU
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e = self.moe
        n_moe = sum(self.moe_layer_mask())
        all_experts = n_moe * (e.num_experts + e.num_shared) * 3 * self.d_model * e.d_expert
        active = n_moe * (e.top_k + e.num_shared) * 3 * self.d_model * e.d_expert
        return full - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]
    microbatch: int = 0  # 0 -> auto (train only)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason) — long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "SKIP(full-attention: 500k KV/prefill needs sub-quadratic mechanism)"
    return True, ""
