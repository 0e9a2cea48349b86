"""Llama 3.2 3B [hf:meta-llama/Llama-3.2-3B; unverified tier].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, rope theta 500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128_256,
    rope_theta=500_000.0,
)
