"""DeepSeek-V2 236B [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2].

60L d_model=5120 128H, MLA (kv_lora_rank=512, q_lora_rank=1536,
qk_nope=128, qk_rope=64, v=128), dense FFN 12288 on layer 0
(first_k_dense_replace=1), MoE elsewhere: 160 routed experts top-6 +
2 shared, expert width 1536. vocab 102400.
"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,  # dense layers (layer 0)
    vocab_size=102_400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536, num_shared=2,
                  layer_rule="after_first"),
    rope_theta=10_000.0,
    notes="MLA latent-KV decode (absorbed matmuls); 2 shared + 160 routed experts",
)
