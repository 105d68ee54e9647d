"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (GQA kv=16)
d_ff=4096 vocab=256206 — enc-dec backbone; modality frontend is a stub
(input_specs supplies precomputed frame embeddings) [arXiv:2308.11596; hf]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,  # decoder layers
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    is_encoder_decoder=True,
    embed_inputs=True,
    # 256206 % 16 != 0: pad the embedding/head to 256256 so the vocab dim
    # shards (otherwise a replicated 67 GB logits+one-hot chain appears);
    # padded logit columns are masked to -1e9
    vocab_pad_multiple=256,
)
