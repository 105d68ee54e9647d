"""Serving entry point: batched prefill + greedy decode with a KV cache.

Answers to ``repro/launch/serve.py``, with the same flags and ``--device``
(default ``cuda``; with no card present it raises, and the CPU runs only
when asked for):

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --reduced \
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Parameters come from ``lm.init_params`` (``encdec.init_params`` for an
encoder-decoder config) with a seeded CPU generator (seed 0) and the prompt
from another (seed 1); an encoder-decoder prompt is source frame
embeddings and target tokens of the prompt's length.  The prefill's cache,
of the prompt's length, is written into a zeroed cache of ``prompt + gen``
positions (and, enc-dec, the source's cross keys and values), which each
decode step then fills in place.  Times are taken
on the host clock after ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_reduced
from ..fl import steps as steps_mod
from ..fl.rounds import resolve_device
from ..models import encdec, lm
from ..pytree import tree_map


def make_batch(cfg, batch: int, prompt_len: int, gen: torch.Generator, device) -> dict:
    """Random prompt tokens, or prompt embeddings for an embeds-input config;
    both for an encoder-decoder config (source frames, target tokens)."""
    out = {}
    if cfg.embed_inputs:
        e = torch.randn((batch, prompt_len, cfg.d_model), generator=gen) * 0.3
        out["embeds"] = e.to(device)
    if cfg.is_encoder_decoder or not cfg.embed_inputs:
        t = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                          dtype=torch.int32)
        out["tokens"] = t.to(device)
    return out


def _prompt(batch: dict) -> torch.Tensor:
    """The input whose (B, P) the decoder's prompt has: the tokens, if any."""
    return batch["tokens"] if "tokens" in batch else batch["embeds"]


def full_cache(cfg, batch: dict, gen_len: int):
    """A zeroed cache for ``batch``'s prompt and ``gen_len`` more positions:
    ``lm.init_cache``, or ``encdec.init_cache`` with the source's length."""
    first = _prompt(batch)
    B, P = first.shape[:2]
    if cfg.is_encoder_decoder:
        return encdec.init_cache(cfg, B, P + gen_len, batch["embeds"].shape[1],
                                 device=first.device)
    return lm.init_cache(cfg, B, P + gen_len, device=first.device)


def merge_cache(full, pre):
    """Write the prefill cache into the leading slots of ``full`` (in place):
    a KV cache's first positions; a recurrent layer's leaves (RWKV's token
    shifts and wkv state, Mamba's conv history and SSM state), which have
    no sequence axis, whole."""
    def put(a, b):
        a[tuple(slice(0, n) for n in b.shape)] = b.to(a.dtype)
        return a

    return tree_map(put, full, pre)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start(params, cfg, batch: dict, full):
    """The prompt's prefill, its cache written into ``full`` (a zeroed cache
    of ``full_cache``).  Returns the cache and the first greedy token."""
    pcache, tok = steps_mod.build_prefill_step(cfg)(params, batch)
    return merge_cache(full, pcache), tok


def decode(params, cfg, cache, tok, index: int, n: int):
    """``n`` greedy decode steps from ``tok`` at cache position ``index``,
    each synchronised.  Returns the cache, the new tokens and each step's
    time (ms, host clock after a synchronize)."""
    step = steps_mod.build_decode_step(cfg)
    out, ms = [], []
    for i in range(n):
        t0 = time.perf_counter()
        cache, tok = step(params, cache, tok[:, None], index + i)
        _sync(tok.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    return cache, out, ms


def generate(params, cfg, batch: dict, gen_len: int) -> dict:
    """One prefill, then ``gen_len - 1`` greedy decode steps.

    Returns the tokens (B, gen_len) int32, the prefill time and each
    decode step's time (ms, host clock after a synchronize).
    """
    full = full_cache(cfg, batch, gen_len)
    prompt = _prompt(batch)
    device, P = prompt.device, prompt.shape[1]
    _sync(device)
    t0 = time.perf_counter()
    cache, tok = start(params, cfg, batch, full)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    _, toks, decode_ms = decode(params, cfg, cache, tok, P, gen_len - 1)
    return {"tokens": torch.stack([tok, *toks], dim=1), "prefill_ms": prefill_ms,
            "decode_ms": decode_ms}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = encdec if cfg.is_encoder_decoder else lm
    params = model.init_params(torch.Generator().manual_seed(0), cfg, device=device)
    batch = make_batch(cfg, args.batch, args.prompt_len, torch.Generator().manual_seed(1), device)
    res = generate(params, cfg, batch, args.gen)
    steady = res["decode_ms"][1:] or res["decode_ms"]
    print(f"prefill {args.prompt_len} tokens x{args.batch}: {res['prefill_ms']:.2f} ms; "
          f"decode {args.gen} tokens: {sum(steady) / max(len(steady), 1):.2f} ms/token "
          f"(steps 2-{len(res['decode_ms'])}) on {device}")
    print("generated token ids (first row):", res["tokens"][0].tolist())


if __name__ == "__main__":
    main()
