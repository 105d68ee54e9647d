"""The serving steps: prefill and greedy decode.

Answers to the serving half of ``repro/fl/steps.py``
(``build_prefill_step``, ``build_decode_step``).  Each step returns the
next greedy token per row, ``argmax`` of the last position's logits (the
first index on ties) as int32.  Encoder-decoder configs raise until
``models/encdec.py`` is ported; the training half (``build_train_step``,
``q8_mean_over_pods``, ``init_train_state``) is ROADMAP §1 item 6.
"""
from __future__ import annotations

import torch

from ..models import lm


def _decoder_only(cfg) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder serving needs models/encdec.py (ROADMAP §1 item 4)"
        )


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def build_prefill_step(cfg):
    _decoder_only(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache, _ = lm.forward(
            params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"), mode="prefill",
        )
        return cache, _greedy(logits)

    return prefill_step


def build_decode_step(cfg):
    """The step writes the token's key and value into ``cache`` in place."""
    _decoder_only(cfg)

    @torch.no_grad()
    def decode_step(params, cache, token, cache_index):
        logits, new_cache, _ = lm.forward(
            params, cfg, tokens=token, mode="decode", cache=cache, cache_index=cache_index,
        )
        return new_cache, _greedy(logits)

    return decode_step
