"""Architecture registry: --arch <id> -> ArchConfig, plus reduced smoke
configs (same family/structure, tiny dims) for CPU tests.

The port's own copy of the reference's ``repro.configs`` (pure data, no
JAX), so that ``get_config`` resolves every ``--arch`` the reference knows
without importing the reference package."""
from __future__ import annotations

import dataclasses

from .base import SHAPES, ArchConfig, MLAConfig, MoEConfig, RWKVConfig, ShapeConfig, SSMConfig, shape_applicable  # noqa: F401


def registry() -> dict[str, ArchConfig]:
    from . import (
        deepseek_v2_236b,
        granite_moe_1b_a400m,
        h2o_danube_1_8b,
        internvl2_1b,
        jamba_v0_1_52b,
        llama3_2_3b,
        llama3_405b,
        musicgen_large,
        qwen2_0_5b,
        rwkv6_1_6b,
    )

    mods = [
        deepseek_v2_236b,
        granite_moe_1b_a400m,
        h2o_danube_1_8b,
        llama3_2_3b,
        qwen2_0_5b,
        llama3_405b,
        internvl2_1b,
        jamba_v0_1_52b,
        rwkv6_1_6b,
        musicgen_large,
    ]
    return {m.CONFIG.name: m.CONFIG for m in mods}


def get_config(name: str) -> ArchConfig:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")
    return reg[name]


def reduced_config(cfg: ArchConfig, vocab: int = 512) -> ArchConfig:
    """Structure-preserving tiny config for CPU smoke tests.

    Keeps: family, mixer kinds, layer pattern period, MoE routing shape
    (fewer experts), MLA structure (smaller ranks), GQA ratios.
    Shrinks: width, depth (>= one full pattern period), vocab.
    """
    period = len(cfg.layer_pattern) if cfg.layer_pattern else 2
    layers = max(period, 2)
    heads = max(2, min(cfg.num_heads, 4)) if cfg.num_heads else 0
    kvh = max(1, min(cfg.num_kv_heads, heads)) if cfg.num_kv_heads else 0
    if heads and cfg.num_kv_heads and cfg.num_heads % cfg.num_kv_heads == 0:
        kvh = max(1, heads // max(1, cfg.num_heads // cfg.num_kv_heads))
    d_model = 64
    changes: dict = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kvh,
        head_dim=16 if heads else 0,
        d_ff=128,
        vocab_size=vocab,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(2, cfg.moe.top_k), d_expert=32
        )
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(
            kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, d_conv=4, expand=2)
    if cfg.rwkv is not None:
        changes["rwkv"] = RWKVConfig(head_size=16, decay_lora=8)
    if cfg.window is not None:
        changes["window"] = 16
    return dataclasses.replace(cfg, **changes)


def cut_config(cfg: ArchConfig, layers: int | None = None, experts: int | None = None) -> ArchConfig:
    """``cfg`` cut in depth to its first ``layers`` layers (a whole number of
    its layer pattern's periods) and to ``experts`` routed experts an MoE
    layer (the top-k, shared experts and widths kept): ``launch.train``'s
    ``--layers`` and ``--experts``."""
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if experts:
        if cfg.moe is None:
            raise ValueError(f"--experts: {cfg.name} has no MoE layer")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg
