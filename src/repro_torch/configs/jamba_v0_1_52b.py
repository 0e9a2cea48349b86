"""Jamba v0.1 52B [arXiv:2403.19887] — Mamba+attention 1:7 interleave
(attn_layer_period=8, offset=4), MoE 16 experts top-2 on every other layer
(expert period 2, offset 1). 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536. Hybrid => runs long_500k (SSM state + 4 attention layers)."""
from .base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    layer_pattern=("m", "m", "m", "m", "a", "m", "m", "m"),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14_336, layer_rule="every_2"),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=10_000.0,
    subquadratic=True,
)
