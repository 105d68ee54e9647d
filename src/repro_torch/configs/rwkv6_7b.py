"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; hf]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,  # d_model / 64 wkv heads
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attn_impl="none",
    ssm_kind="rwkv6",
)
