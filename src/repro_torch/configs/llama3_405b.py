"""Llama 3 405B [arXiv:2407.21783]. 126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256. The pure-distributed payload: one k-evaluation of
this arch occupies a full pod (the paper's 'distributed' mode)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
)
