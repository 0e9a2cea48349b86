"""Qwen2 0.5B [arXiv:2407.10671]. 24L d_model=896 14H (GQA kv=2)
d_ff=4864 vocab=151936, QKV bias, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
