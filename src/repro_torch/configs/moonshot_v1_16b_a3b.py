"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight [hf:moonshotai/Moonlight-16B-A3B; hf].

Assigned spec followed literally: uniform MoE layers (the shipped
Moonlight additionally has a dense first layer; see DESIGN.md §6)."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    moe_num_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    rope_theta=5e4,
)
