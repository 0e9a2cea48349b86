"""MusicGen-large [arXiv:2306.05284] — decoder-only transformer over
EnCodec tokens. 48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.
The EnCodec frontend + 4-codebook interleaving is a STUB: input_specs()
supplies precomputed frame embeddings; one 2048-way lm_head models the
per-codebook output (DESIGN §4)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    input_mode="embeddings",
    rope_theta=10_000.0,
    notes="EnCodec frontend stubbed; backbone faithful",
)
