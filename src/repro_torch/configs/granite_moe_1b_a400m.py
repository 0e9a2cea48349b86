"""IBM Granite 3.0 1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) MoE 32 experts top-8, expert width 512,
vocab 49155. All layers MoE, no shared experts.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512, layer_rule="all"),
    rope_theta=10_000.0,
)
