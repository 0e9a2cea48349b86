"""H2O-Danube 1.8B [arXiv:2401.16818] — llama+mistral mix with sliding
window attention. 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
Window 4096 (mistral-style) => sub-quadratic; runs long_500k decode with an
O(window) ring KV cache.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    window=4096,
    rope_theta=10_000.0,
    subquadratic=True,
)
