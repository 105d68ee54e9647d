"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
every 2nd layer [arXiv:2403.19887; hf]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    ssm_kind="mamba",
    attn_every=8,  # 1 attention : 7 mamba
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_every=2,
    d_state=16,
    d_conv=4,
    expand=2,
    optimizer="adafactor",  # 398B
    param_dtype="float32",
)
