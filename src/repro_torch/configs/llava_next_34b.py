"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling happens in the stubbed frontend; input_specs
supplies patch embeddings [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    embed_inputs=True,  # train/prefill consume embeddings; decode uses tokens
    rope_theta=1e6,
    # 56 heads don't divide the 16-way model axis: queries are padded per kv
    # group (7 -> 8, masked out of wo) so attention shards instead of
    # replicating (a measured 6x whole-model FLOP inflation otherwise)
    tp_pad_multiple=16,
)
