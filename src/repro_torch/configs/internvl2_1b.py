"""InternVL2-1B [arXiv:2404.16821] — InternViT-300M frontend + Qwen2-0.5B
backbone (vocab extended to 151655). The ViT frontend is a STUB:
input_specs() supplies precomputed patch embeddings (B, L, d_model); only
the LM backbone is modeled, per the assignment."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    input_mode="embeddings",
    notes="ViT frontend stubbed: train/prefill consume precomputed patch embeddings",
)
