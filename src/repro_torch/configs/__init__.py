"""Architecture registry: one module per assigned architecture.

``get_config(name)`` -> full ModelConfig (exact published dims);
``get_reduced(name)`` -> structure-preserving small config for CPU smoke
tests; ``get_plan(name, shape)`` -> RunPlan (grad accumulation etc.).

Answers to ``repro/configs/__init__.py``; every arch module is a copy of
the reference's, so each value is the same.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..config import ModelConfig, RunPlan, ShapeSpec, SHAPES

ARCH_NAMES = [
    "mistral_large_123b",
    "deepseek_67b",
    "qwen3_8b",
    "tinyllama_1_1b",
    "rwkv6_7b",
    "jamba_1_5_large_398b",
    "seamless_m4t_medium",
    "llava_next_34b",
    "moonshot_v1_16b_a3b",
    "deepseek_v2_lite_16b",
]

# public ids (--arch flag) -> module name
ARCH_IDS = {
    "mistral-large-123b": "mistral_large_123b",
    "deepseek-67b": "deepseek_67b",
    "qwen3-8b": "qwen3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llava-next-34b": "llava_next_34b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}


def get_config(name: str) -> ModelConfig:
    mod = ARCH_IDS.get(name, name.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def supports_long_context(cfg: ModelConfig) -> bool:
    """Sub-quadratic (SSM/hybrid) archs run long_500k; pure attention skips."""
    return cfg.ssm_kind in ("mamba", "rwkv6")


def supports_decode(cfg: ModelConfig) -> bool:
    return True  # all assigned archs have decoders (enc-dec included)


def runnable_cells(name: str) -> list[str]:
    cfg = get_config(name)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if supports_long_context(cfg):
        cells.append("long_500k")
    return cells


def get_reduced(name: str) -> ModelConfig:
    """Structure-preserving reduced config for CPU smoke tests."""
    cfg = get_config(name)
    pat = max(cfg.attn_every, cfg.moe_every, 1)
    layers = cfg.first_dense + 2 * pat  # two scan blocks
    kw = dict(
        num_layers=layers,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_chunk=64,
        ssm_chunk=16,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
    if cfg.ssm_kind == "rwkv6":
        kw.update(d_model=128, d_ff=256)  # heads = 128/64 = 2
    if cfg.attn_impl == "mla":
        kw.update(kv_lora_rank=32, qk_rope_dim=16, head_dim=32)
    if cfg.moe_num_experts:
        kw.update(moe_num_experts=8, moe_top_k=2, moe_d_ff=64, moe_group_size=64)
        if cfg.first_dense:
            kw.update(first_dense=1, first_dense_d_ff=256)
    if cfg.is_encoder_decoder:
        kw.update(enc_layers=2, num_layers=2)
    return cfg.replace(**kw)


# per-(arch, shape) execution plans: grad-accum bounds activation memory
_ACCUM = {
    "mistral-large-123b": 4,
    "jamba-1.5-large-398b": 4,
    "deepseek-67b": 2,
    "llava-next-34b": 2,
}


def get_plan(name: str, shape: str) -> RunPlan:
    if shape == "train_4k":
        return RunPlan(grad_accum=_ACCUM.get(name, 1))
    return RunPlan(grad_accum=1)
