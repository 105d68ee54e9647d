"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408
vocab=102400, MoE 64e top-6 — MLA kv_lora=512 (+64 rope dims),
2 shared + 64 routed top-6, dense first layer (d_ff 10944)
[arXiv:2405.04434; hf]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    attn_impl="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    moe_num_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_num_shared=2,
    first_dense=1,
    first_dense_d_ff=10944,
    rope_theta=1e4,
)
