"""Framework configuration: model configs, shape specs, run plans.

Answers to ``repro/config.py``: the same fields, defaults and values.
``_DTYPES`` maps the dtype names to torch dtypes; ``adtype`` (the
activation dtype) answers to the reference's ``jdtype``, and ``pdtype``
keeps its name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    attn_impl: str = "gqa"  # gqa | mla | none
    tp_pad_multiple: int = 1  # pad query heads per kv group to shard evenly
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int | None = None  # sliding-window attention (beyond-paper long-ctx option)
    attn_chunk: int = 512  # flash-chunk size

    # MLA
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_num_shared: int = 0
    moe_every: int = 1  # every k-th layer within a pattern block is MoE
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    first_dense: int = 0  # leading dense (non-MoE) layers
    first_dense_d_ff: int = 0

    # hybrid / ssm
    attn_every: int = 1  # 1 attention layer per `attn_every` layers (jamba: 8)
    ssm_kind: str = ""  # '' | 'mamba' | 'rwkv6'
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    ssm_chunk: int = 64

    # enc-dec
    is_encoder_decoder: bool = False
    enc_layers: int = 0

    # io
    embed_inputs: bool = False  # frontend stub supplies embeddings
    tie_embeddings: bool = False

    # numerics / memory
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | save_mixer_ffn (keep sublayer
    # outputs: backward skips re-running attention/FFN forward, removing one
    # of three TP-collective passes at ~2 sharded tensors/layer of memory)
    optimizer: str = "adamw"  # adamw | adafactor | sgd
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    moe_aux_weight: float = 0.01

    # FL (Totoro+) integration
    fl_local_steps: int = 1  # FedAvg local steps per round
    fedprox_mu: float = 0.0  # FedProx proximal coefficient (0 = FedAvg)

    vocab_pad_multiple: int = 1  # pad vocab so embed/head shard evenly

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class RunPlan:
    """Per-(arch, shape) execution plan (memory/comm knobs)."""

    grad_accum: int = 1  # microbatches per FL local step
    aggregation: str = "totoro_tree"  # xla_auto | totoro_tree | totoro_tree_q8
