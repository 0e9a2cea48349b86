"""RWKV-6 (Finch) 1.6B [arXiv:2404.05892]. 24L d_model=2048, attention-free
(wkv6 time-mix with data-dependent decay), channel-mix d_ff=7168,
vocab=65536. O(1)-state decode => runs long_500k."""
from .base import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65_536,
    attention="none",
    rwkv=RWKVConfig(head_size=64, decay_lora=64),
    subquadratic=True,
    notes="attention-free: Binary Bleed applies only at meta level (DESIGN §Arch-applicability)",
)
