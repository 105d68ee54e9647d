#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase is caught, nothing falls back to
the CPU):

1. device: the card's name, the device count, and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: every CUDA kernel of the port, from ``src/repro_torch/kernels/csrc``,
   one nvcc per source, all started together;
3. kernels against their plain versions on the card: the tree aggregation
   at ragged shapes, C=1, G=1 and the kernel bench's C=16, L=131072 in
   bf16 and f32, bit-equal to its fmaf chain (``ref.
   tree_aggregate_groups_chain``) and within TOL of the plain sum; QSGD
   quantize without and with the EF residual (levels 127, 3, 7; a row that
   reaches 128 and a zero row; the residual instance on a misaligned view
   too, and its q and s equal to the other instance's), dequantize (C = 256,
   300 and 7, a misaligned view) and the broadcast chain apply (D = 1..5,
   D-deep = D single steps, misaligned views at D = 1 and 5) bit-equal at
   R = 1, 27, 4096; the int8 aggregation
   bit-equal to its chain and to the f32 path on the widened input; the fused
   FedProx update bit-equal at L = 1, 1000, 2^17 (bf16 and f32) and 2^24,
   at (mu, wd) = (0, 0), (0.01, 0), (0.1, 0.01), in place and on a
   misaligned view, and its multi-leaf launch bit-equal on every leaf of a
   table with one-element, zero-length and misaligned leaves and of one
   past a launch's parameter table (launch counts as the table implies);
   the policy update bit-equal, with the same rho and pi~ on every node,
   at N = 1 ... 1,000,000 and K = 2, 8, 16, 36, on candidate sets with
   ties (candidate_policy_set) and without, on partial, all-ones (the
   planners') and mixed masks, at M up to 300 candidates, with all-zero
   reward rows and policies at the 1e-12 floor;
4. the main paths at full width, each with every launch counter set to 0
   just before and read just after:
   a. slice A: the README quickstart (400-node overlay, 16 workers, 4,000
      samples, MLP 32-64-8, 8 rounds, kill the master, 1 more round) and
      2 rounds of a CNN app (16x16x1, channels 16/32); the aggregation
      kernel bit-equal to its chain at every tree-level (G, C, L) the path
      ran; the same seeds on the CPU, compared with the card's run;
   b. slice B: the quickstart app through ``run_async`` (12 applies,
      K = 4, staleness alpha 0.5, heterogeneous compute, churn) with
      QSGD-int8 commits under error feedback and delta-QSGD broadcasts
      (levels 3, chain cap 3), then the same without compression, then 3
      compressed applies with a ``downlink="qsgd-int8"`` broadcast (whose
      dequantize is the only ``qsgd_dequantize`` call site a run reaches:
      EF commits take their residual from the quantize launch); every
      kernel call of the compressed card runs is recorded and re-run
      through the plain versions on the CPU (bit-equal; the aggregation
      to its chain); the same seeds
      on the CPU: identical event and churn traces, fp-tight losses and
      parameters uncompressed, first-apply commit lattices within +-1 and
      losses within ASYNC_LOSS_ATOL compressed, beside how far the losses
      move on the CPU when the start weights are perturbed by PERTURB;
   Every local SGD step of a and b is one multi-leaf fused-update launch
   per dtype present: the count must equal local steps x launches per
   step's leaf table over the training dispatches, and the kernel is
   checked against its plain version at every leaf shape and on every
   leaf table (in f32 and bf16) the paths gave it.
   c. slice C: the path-planning demo's game (128 nodes, 8 hops of 20-100
      Mbps, 2 Mbit packets, 40 episodes of tau = 16) for Totoro+ (Alg. 1),
      the bandit and OPT; Alg. 1 at Fig 15's N = 10,000, K = 16, tau = 8
      for 20 episodes; Alg. 2 (multicast, subsets of up to 2 of 8 hops)
      at N = 128 for 20 episodes.  Every policy update of the card runs is
      replayed on the CPU through the plain version (PLANNER_TOL, same rho
      and pi~ indices), the same seeds run on the CPU give the same series
      (PLANNER_TOL), and Totoro+'s cumulative latency is below the
      bandit's.  Then the async quickstart with a live PlacementEngine:
      event, churn and replan logs identical to the CPU run's.  Then the
      aggregation bit-equal to its chain at every (G, C, L, dtype) that the
      async and placement runs gave it;
   d. FedAvg, DP and LM serving.  The quickstart MLP's per-worker deltas
      (one round's local training): ``fl/aggregation``'s fedavg and
      pairwise_accumulate within TOL of ``ops.tree_aggregate_pytree`` (one
      launch of the kernel's G = 1 entry ``tree_aggregate``, made by this
      check: fedavg itself is plain tensor ops, as in the reference),
      fedavg on the
      card bit-equal to the CPU's, ``fl/dp.dp_sanitize`` on the card within
      TOL of the CPU's under the same injected draws.  Then
      ``launch/serve``'s functions (``make_batch``, ``generate``: one
      prefill and LM_GEN - 1 greedy decodes at batch 4, prompt 32) on
      tinyllama-1.1b at full width and depth (22 layers, bf16) and on
      qwen3-8b at full width cut to 4 layers, weights from
      ``lm.init_params`` with a seeded CPU generator, each truncated
      normal drawn on the card (``drawn_on_card``): every decode's
      logits within LM_BF16_REL of the largest logit magnitude of the
      train-mode forward over the same positions, the tokens their argmax;
      then the same tinyllama run with each of DECODE_FAULTS planted in the
      decode step, each of which must read above that bound;
      tinyllama at full width and 2 layers in f32 (TF32 off), card against
      CPU: prefill logits within LM_F32_REL of the largest logit, the first
      4 greedy tokens identical while the CPU's top-2 margin exceeds that
      bound.  Prefill ms, decode ms/token (host clock after synchronize),
      the decode bound (weight bytes over HBM's rate), a decode step's idle
      share, device ops and top five ops under torch.profiler, and the
      chunked attention core beside ``scaled_dot_product_attention`` at
      the prefill shape (a yardstick only).  The serving path launches
      none of the seven kernels: its counters must read 0;
   e. LM training, with bf16 GEMMs accumulating in f32 (restored after):
      a. tinyllama-1.1b at full width and 2 layers in f32 (remat on, TF32
         off), B = 2, S = 128, through ``lm_f32_card_vs_cpu`` (phases 4f a
         and 4g a call it too): the train forward's logits and the
         gradients on the card against the CPU (logits within LM_F32_REL of
         the largest, loss within TRAIN_LOSS_RTOL, every gradient leaf
         within TRAIN_GRAD_REL of the leaf's largest magnitude), and
         ``build_train_step``'s AdamW update from the same weights and
         gradients on both (every leaf within TRAIN_ADAM_REL);
      b. the flash backward at FLASH_SHAPE (B 8, S 1024, 32 heads of 64
         after the repeat, causal, two chunks of 512 each way): ``_Flash``
         in bf16 and in f32 against autograd through the plain chunked
         forward in f32 (FLASH_BF16_REL, FLASH_F32_REL of each gradient's
         largest magnitude), and each of FLASH_FAULTS planted in the
         backward at run time must read above FLASH_BF16_REL; fwd + bwd
         beside ``scaled_dot_product_attention``'s (a yardstick only);
      c. tinyllama-1.1b at full width and depth, bf16, AdamW (lr 3e-4),
         remat on, 6 steps of B 8, S 1024 of ``data.learnable_lm_batch``
         through ``launch/train.train``: every loss finite and the last
         below the first; ms/step (steps 2-6, host clock after
         synchronize), tokens/s, MFU (6 N T with N without the embedding
         table, plus 6 L H hd S T, over 989 TFLOP/s), peak memory, one
         step's idle share, device ops and top five under
         torch.profiler; the seven kernels' counters must read 0.
         Phases 4e, 4f and 4g each run with the script's own heap frozen
         (``frozen_heap``), the garbage collections of c's and d's loops
         timed;
      d. the podded ``totoro_tree_q8`` step, 2 pods, the same model and
         batch, 3 steps through ``launch/train.train``: exactly one
         ``qsgd_quantize`` and one ``qsgd_dequantize`` launch per leaf a
         step (12 + 12), the aggregate of the next batch's gradients
         within one quantization step (max |g| / 127) of the plain pod
         mean, and on every leaf's rows (8,594,128 of 256) both kernels
         bit-equal to ``ref.quantize_ref`` and ``ref.dequantize_ref``, a
         gate that each of HOP_FAULTS, planted in a kernel's output on the
         smallest leaf, must fail; the hop's kernel time a step
         (profiler) beside its byte bound, with and without the uniforms'
         bytes, both kernels timed at the largest leaf's rows, and the
         step's peak memory;
      e. tinyllama-1.1b at full width, 2 layers, bf16: 2 steps,
         ``ckpt.save`` of 2 replicas into a temporary directory (removed
         after), replica 0 truncated, ``ckpt.restore`` onto the card:
         every leaf bit-equal, and the next step's loss from the restored
         state equal to the uninterrupted one's; bytes a replica and the
         save and restore seconds;
   f. the MoE family: deepseek-v2-lite-16b at full width (d 2048, 16
      heads, MLA kv_lora 512 + rope 64, 64 routed experts top-6 with d_ff
      1408 and 2 shared, a leading dense layer of d_ff 10944, vocab
      102,400), with bf16 GEMMs accumulating in f32:
      a. f32 at 2 layers (the dense layer and one MoE block; remat on, TF32
         off), B = 2, S = 128, the same weights and batch on the card and
         on the CPU: train-forward logits within LM_F32_REL of the largest,
         the loss and aux loss within TRAIN_LOSS_RTOL, every gradient leaf
         (the router's included) within TRAIN_GRAD_REL of its largest,
         AdamW's update from the same inputs within TRAIN_ADAM_REL, and
         every top-k expert index of the forward and of the backward's
         recompute equal on both sides;
      b. decode against the train forward through ``launch/serve``'s
         functions (batch 4, prompt 32, 16 generated), both dropless
         (capacity factor 64), the token routings that differ between the
         two paths counted; each of MOE_DECODE_FAULTS is planted in the
         decode step and read under the flips it makes itself, and must
         fail where the sound run passes.  The strict gate: f32 at 2
         layers, no routing flip and every logits entry within
         MOE_F32_DECODE_REL of the largest logit.  Then bf16 serving at 5
         layers (dense + 4 MoE blocks), where a near-tie resolved the
         other way is legitimate: every entry no flip reaches within
         LM_BF16_REL, at most MOE_BF16_MAX_FLIPS flips and at least
         MOE_BF16_MIN_CLEAN decode entries left to compare; then, at
         the config's capacity, prefill ms, decode ms/token beside two
         weight-read bounds (all 64 experts of each layer, which the dense
         dispatch reads; the experts the batch's tokens were routed to), a
         decode step's idle share and top five ops;
      c. bf16 training at 3 layers (dense + 2 MoE blocks), AdamW, remat
         "nothing", B 8, S 1024, 6 steps through ``launch/train.train``:
         losses finite and falling, aux losses finite and positive,
         ms/step, tokens/s, MFU on the active parameters (a token's 6 of
         64 experts; MLA's q/k head dim 192, v 128), peak memory, one
         step's idle share and top ops; then remat on against off at 2
         layers on the card: the recompute's routing equal to the
         forward's, every gradient leaf bit-equal but the embedding's
         (within REMAT_EMBED_REL of its largest); then one MoE FFN's
         forward and backward at the training shape, whole and its
         routing (``moe.route``: the one-hot dispatch and combine) alone;
      d. the podded ``totoro_tree_q8`` step at 2 layers (the largest depth
         whose two pods of weights, AdamW state and f32 gradients fit), 2
         pods, 3 steps: one quantize and one dequantize launch per leaf a
         step (29 + 29), the aggregate within a quantization step of the
         pod mean, both hop kernels bit-equal to ``ref`` on every leaf's
         rows (the gate failing on HOP_FAULTS), timed on the largest expert
         stack's (1,441,792 of 256), and the hop's kernel time a step
         beside its byte bound;
   g. the recurrent families, with bf16 GEMMs accumulating in f32: rwkv6-7b
      (RWKV-6, d 4096, 64 wkv heads of 64, d_ff 14336, vocab 65,536) and
      jamba-1.5-large-398b's Mamba layer (d 8192, d_inner 16384, d_state
      16, dt_rank 512, f32 weights); every gate is also run once with a
      fault planted in the port at run time, which must fail it:
      a. f32, TF32 off, card against the CPU on the same weights and
         inputs: rwkv6-7b at 2 layers, B = 2, S = 128 (two wkv chunks of
         64), through ``lm_f32_card_vs_cpu`` under phase 4e a's bounds;
         jamba's ("mamba", "dense") layer alone through
         ``lm.apply_layer`` in train mode, its output and the gradients of
         every parameter and of the input under the same bounds; jamba's
         reduced model (16 layers) through ``launch/serve``'s functions,
         the prefill's and every decode step's logits and the prefill's
         cache within LM_F32_REL, the tokens identical.  Planted (card side
         only): each of RECURRENT_F32_FAULTS;
      b. rwkv6-7b at full width and depth (32 layers) through
         ``launch/serve``'s functions (batch 4, prompt 32, 16 generated),
         the weights from one seeded init (``drawn_on_card``) with every
         constant-at-init leaf
         (mix_*, decay_0, bonus_u, ln_*) redrawn from RWKV_LEAF_SEED:
         decode against the train forward in f32 within
         RWKV_F32_DECODE_REL of the largest logit, each of
         RWKV_DECODE_FAULTS planted in the wkv state update above it; the
         same readings in bf16 (15.07 GB) recorded, not gated, and the
         forward's own spread between two sequence lengths in each dtype;
         prefill ms, decode ms/token beside the weight-read
         bound, the init time, a decode step's idle share, device ops and
         top ops;
      c. rwkv6-7b training at full width and 7 layers, bf16,
         AdamW, remat, 6 steps of B 8, S 1024 through
         ``launch/train.train`` (ms/step, tokens/s, MFU on 6 N T without the
         wkv core's FLOPs, peak memory, one step's idle share and top ops);
         then remat on against off at 2 layers on the card
         (``remat_agreement``, as phase 4f c), every gradient leaf
         bit-equal but the embedding's (within REMAT_EMBED_REL);
      d. the podded ``totoro_tree_q8`` step at 2 layers, 2 pods, 3 steps:
         one quantize and one dequantize launch per leaf a step (26 + 26),
         both hop kernels bit-equal to ``ref`` on every leaf's rows
         (7,611,232 of 256), the gate failing on each of HOP_FAULTS, timed
         on the largest leaf's (the embedding's, 2,097,152 of 256 for two
         pods); the hop's kernel time a step beside its bound;
      e. jamba's Mamba sublayer at full width in its own dtypes, B 4, S
         1024: forward plus backward ms, the share of the chunk loop
         (``ssm.selective_scan``), peak memory; a lead, not a gate;
   h. the encoder-decoder family: seamless-m4t-medium (12 encoder and 12
      decoder layers, d 1024, 16 heads of 64, d_ff 4096, vocab 256,206
      padded to 256,256), with bf16 GEMMs accumulating in f32; every gate
      is also run under faults planted at run time, each of which must fail
      it:
      a. f32, TF32 off, card against the CPU at 2 + 2 layers, B 2, 128
         source frames and 64 target tokens, every norm leaf redrawn from a
         seed on both sides: ``encdec.forward``'s logits (the padded columns,
         -1e9, included) within LM_F32_REL of the largest, the loss within
         TRAIN_LOSS_RTOL, every gradient leaf within TRAIN_GRAD_REL; planted
         (card side): each of ENCDEC_F32_FAULTS;
      b. full width and depth through ``launch/serve``'s functions (batch
         4, 32 source frames, prompt 32, 16 generated): decode against the
         train forward in f32 within SEAMLESS_F32_DECODE_REL, then in bf16
         within LM_BF16_REL, each of ENCDEC_DECODE_FAULTS above the bound in
         both dtypes; prefill ms, decode ms/token beside the bound of the
         bytes a decode step reads (the decoder, the head, the self and
         cross caches), a decode step's idle share and device ops;
      c. bf16 training at full width and depth, AdamW, remat, B 4 (cut from
         8 by the card's memory), S_src = S_tgt = 1024, 6 steps through
         ``launch/train.train`` (ms/step, target tokens/s, MFU on
         ``model_flops``' enc-dec count, peak memory, one step's idle share
         and top ops); remat on against off at 2 + 2 layers
         (``remat_agreement``);
      d. the podded ``totoro_tree_q8`` step at full depth, B 4, 2 pods, 3
         steps: one quantize and one dequantize launch per leaf a step (27
         + 27), both hop kernels bit-equal to ``ref`` on every leaf's rows,
         the gate failing on each of HOP_FAULTS, timed on the largest
         leaf's (``embed``: 2,050,048 of 256 for two pods); the hop's kernel
         time a step beside its bound;
   i. the podded ``totoro_tree_q8`` step with one pod per rank: RANK_PODS
      ranks spawned by ``torch.multiprocessing`` (a ``file://`` store in a
      temporary directory), a gloo ``pod`` process group, both ranks on the
      one card; tinyllama-1.1b at full width and RANK_LAYERS layers through
      ``launch/train.train(mesh=...)``, each rank with its pod's unpodded
      state and its half of phase 4e d's batches, POD_STEPS steps: one
      quantize and one dequantize launch per leaf a step on each rank (12 +
      12); gate 1, after every leaf's hop, the gathered lattice and scales
      and the hop's output bit-equal to ``steps.q8_mean_over_pods`` of the
      ranks' gradients stacked, every leaf by digest and the largest leaf
      whole (``PodRankGates``); gate 2, after every step,
      the ranks' states equal (every leaf's digest, the largest leaf
      whole); gate 3, each rank's losses 4e d's (bit-equal if the card's
      gradients are deterministic, which the phase measures, else within
      TRAIN_LOSS_RTOL); each of RANK_FAULTS, planted in the hop's
      all_gather, and RANK_KERNEL_FAULT, planted in the quantize kernel's
      output, must fail gate 1 where the sound run passes; ms a step a
      rank and the hop split into quantize, all_gather and
      dequantize-and-mean, labelled as two ranks sharing one card;
   j. the dense family's step sharded over (data 2, model 2): four gloo
      ranks on the one card (the constants' comment, SHARD_*), the
      collectives a step by op and mesh axis, the bytes the placed state
      and batch take on each rank, the peak memory a rank;
   k. the dry-run (``repro_torch.launch.dryrun``, two subprocesses that
      never touch the card) of 4j
      b's own cell on a fake process group, held to what 4j measured
      (DRYRUN_*); and the dry-run of
      tinyllama-1.1b's train_4k cell at DRYRUN_PROD_LAYERS layers on the
      256-rank production mesh, its record printed;
5. times: each kernel's device time (a CUDA graph of calls between CUDA
   events) beside its bound, its plain version and one PyTorch call
   computing the same function where there is one (timed in turns, a b b
   a, with the fused update and with every f32 aggregation level: einsum),
   at the main paths' shapes and at the kernel bench's (the QSGD kernels
   and the chain apply also at 65,536 rows, past L2); the fused update
   on one local step's leaf table; the policy update on all-ones and
   partial masks; the round and apply times on the
   host clock; the host time of a planner episode at N = 128 and 10,000;
   and the device's busy share of a steady round, of steady applies and
   of planner episodes under torch.profiler.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, and
prints no result, without a CUDA card or without the repository's
``src/`` beside it.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import astuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

TOL = {"rtol": 1e-5, "atol": 1e-5}  # the JAX package's own kernel tolerance
# card vs CPU after 36 SGD steps: matmul and conv reduction orders differ
PATH_TOL = {"rtol": 1e-4, "atol": 1e-5}
# compressed async, card vs CPU: a ~1e-7 training difference can move
# x/scale + u across an integer and flip a lattice point by one step (a
# third of the row max at downlink levels 3), and the flip spreads to later
# workers.  Phase 4b measures how far per-apply losses move when the CPU
# run's start weights are perturbed by PERTURB relative (ten times and more
# the card-vs-CPU weight drift of slice A); the tolerance sits well above it.
ASYNC_LOSS_ATOL = 5e-3
PERTURB = 1e-5
ASYNC_APPLIES = 12
QSGD_DOWNLINK_APPLIES = 3
# planner, card vs CPU.  Both runs draw the same uniforms (a CPU generator)
# and every step of the game is an IEEE-exact f32 operation or an f64 sum of
# few f32 terms, except the logs of line 5, which only pick the argmin among
# candidates whose determinants differ far above an ulp (or tie exactly).
# So policies agree bit for bit unless an index flips; 1e-6 is 17 f32 ulps
# at 1 and far below any flipped index's effect (>= 1e-3 on a policy).
PLANNER_TOL = 1e-6
FUSED_HYPER = ((0.2, 0.0, 0.0), (0.2, 0.01, 0.0), (0.05, 0.1, 0.01))  # (lr, mu, wd)
# LM serving (phase 4d): batch, prompt and generated tokens of launch/serve
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16
# bf16 decode logits against the train forward over the same positions, as a
# share of the largest logit magnitude (the bf16 counterpart of the f32
# 5e-4 of tests/test_models_smoke.py).  Set at 2^-4 before the first card
# run; the sound runs read 2^-6.0 (tinyllama) and 2^-6.9 (qwen3-8b, 4
# layers), bit for bit in every run, and two of DECODE_FAULTS 2^-3.6, under
# 2x above 2^-4, so the bound sits at 2^-5: 2x over the sound reading and
# 2.6x under the faults'
LM_BF16_REL = 2.0**-5
# Decode faults planted (by patching attention at run time) in the bf16
# tinyllama run, each of which the bound must reject: the cache written and
# read at cache_index - 1, the step's k/v write lost to later steps (written
# to a copy), and the step's own position masked out of its attention
DECODE_FAULTS = ("cache_index - 1", "k/v write dropped", "own position masked")
# f32 at 2 layers, card (TF32 off) against the CPU: share of the largest logit
LM_F32_REL = 1e-4
LM_F32_TOKENS = 4
QWEN_LAYERS = 4  # qwen3-8b's depth, cut from 36 (PERF.md §4)
# LM training (phase 4e).  a: tinyllama's width at 2 layers in f32 (TF32
# off), one train step on the card against the CPU; each bound a share of
# the leaf's (or loss's) largest magnitude
TRAIN_F32_LAYERS, TRAIN_F32_BATCH, TRAIN_F32_SEQ = 2, 2, 128
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-4
TRAIN_ADAM_REL = 1e-5
# b: the flash backward at tinyllama's attention shape, causal: _Flash in
# bf16 (and in f32) against autograd through the plain chunked forward in
# f32, each gradient within its bound of that gradient's largest magnitude.
# Set before the first card run from a CPU run at (1, 1024, 4 heads, 64):
# bf16 read 2^-8.5, f32 2.6e-7, the two faults 0.99 and above
FLASH_SHAPE = (8, 1024, 32, 64)  # B, S, heads after the repeat, head_dim
FLASH_BF16_REL = 2.0**-6
FLASH_F32_REL = 1e-5
FLASH_FAULTS = ("delta dropped", "dk/dv of the last query chunk only")
# c, d, e: tinyllama-1.1b in bf16 through launch/train's loop
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, POD_STEPS, PODS = 8, 1024, 6, 3, 2
# d (and 4f d, 4g d): faults planted in a hop kernel's output, each of
# which the hop's bit-equality gate must catch on one leaf's rows
HOP_FAULTS = ("a lattice point a step off", "a dequantized value an ulp off")
CKPT_LAYERS, CKPT_STEPS, CKPT_REPLICAS = 2, 2, 2
BF16_FLOPS = 989e12  # H100 SXM dense bf16 peak (NVIDIA data sheet, 700 W)
# The MoE family (phase 4f): deepseek-v2-lite-16b at full width (MLA, 64
# routed experts top-6 and 2 shared, one leading dense layer).  a: f32 at 2
# layers (the dense layer 0 and one MoE block), card (TF32 off) against the
# CPU under phase 4e a's bounds, the logits within LM_F32_REL of the largest
# and every top-k expert index equal
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_F32_LAYERS = 2
# b: decode against the train forward, both dropless (capacity factor 64,
# as tests/test_models_smoke.py), read by moe_decode_gate under each run's
# own routing flips; the sound run must pass and each of MOE_DECODE_FAULTS,
# planted in the decode step, must fail.  The strict gate is f32 (TF32 off)
# at MOE_F32_LAYERS layers: no token routed differently and every logits
# entry within MOE_F32_DECODE_REL of the largest logit (set before its
# first card run to LM_F32_REL, the f32 bound of 4d and 4e a).
MOE_F32_DECODE_REL = LM_F32_REL
MOE_DECODE_FAULTS = ("shared experts dropped", "rope scores left out")
# Then bf16 serving at 5 of 27 layers (the port draws every leaf on the host
# in f32: the expert stack alone is 19 GB at full depth).  There a bf16
# rounding that differs between the two paths may resolve a near-tie in the
# top 6 of 64 the other way, a legitimate difference that reaches its row's
# logits from its step on (by the cache), so the bound holds on the entries
# no flip reaches.  LM_BF16_REL, 2^-5, was set from the first card runs:
# 2^-6.7 there (9 of 752 routings flipped, 42 of 60 decode entries left)
# and 2^-2.5 and 2^-0.7 for the faults on the sound run's entries.  So that
# a wrong decode cannot pass by flipping away what is compared, a run fails
# past MOE_BF16_MAX_FLIPS flips (3x the sound run's) or with fewer than
# MOE_BF16_MIN_CLEAN decode entries (half of them) left
MOE_SERVE_LAYERS = 5
MOE_BF16_MAX_FLIPS = 27
MOE_BF16_MIN_CLEAN = LM_BATCH * (LM_GEN - 1) // 2
# c: bf16 training at 3 layers (dense + 2 MoE blocks, 1.67e9 parameters);
# remat on against off at 2 layers: every gradient leaf bit-equal (the
# recompute routes the same tokens) but the embedding table's, whose
# backward adds repeated tokens' rows, within REMAT_EMBED_REL of its
# largest (``remat_agreement``, which phase 4g c calls too)
MOE_TRAIN_LAYERS, MOE_REMAT_LAYERS = 3, 2
REMAT_EMBED_REL = 2.0**-8
# d: the podded q8 step at 2 layers, reckoned at ~55 GB (2 pods x 1.085e9
# parameters x 14 B of bf16 weights and AdamW state, the pods' f32
# gradients, one pod's B 4 activations); 3 layers would need ~76 GB
MOE_POD_LAYERS = 2
# The recurrent families (phase 4g): rwkv6-7b (RWKV-6: 32 layers of d 4096,
# 64 wkv heads of 64, d_ff 14336, vocab 65,536; 7.53e9 parameters) and
# jamba-1.5-large-398b's Mamba layer (d 8192, d_inner 16384, d_state 16,
# dt_rank 512, f32 weights).  a: f32 (TF32 off) card against the CPU under
# phase 4e a's bounds, each gate failed by one of RECURRENT_F32_FAULTS,
# planted on the card's side: rwkv6-7b at 2 layers, jamba's ("mamba",
# "dense") layer alone, jamba's reduced model through prefill and decode
RWKV_ARCH, JAMBA_ARCH = "rwkv6-7b", "jamba-1.5-large-398b"
RWKV_F32_LAYERS = 2
RECURRENT_F32_FAULTS = ("wkv state not carried across chunks",
                        "scan state not carried across chunks", "ssm state not carried in decode")
# b: serving at full depth, the weights from one seeded init with every
# leaf that is a constant at init (mix_*, decay_0, bonus_u, ln_*) redrawn
# from RWKV_LEAF_SEED: at init decay_0 = -6 holds every decay at 0.9975 and
# bonus_u = 0 drops the bonus term, which hides faults there.  Decode
# against the train forward, as a share of the largest logit, within
# RWKV_F32_DECODE_REL; each of RWKV_DECODE_FAULTS, planted in the decode
# step's wkv state update, must read above it.  The gate is f32 (TF32
# off): on these weights the model carries rounding far (a head's
# output at position 0 is one vector times the scalar r_0 . (u k_0), which
# the group norm's eps 1e-5 amplifies where it nears zero).  The first
# card run on them read f32 decode 3.57e-3 of the largest logit, the
# faults 0.55 to 1.05 and the forward's own length spread 0.12; bf16
# decode 0.144, its spread 0.51 and the decay fault 0.59, so bf16 cannot
# be gated and is recorded.  RWKV_F32_DECODE_REL, set from that run: 2^-6,
# 4.4x over the sound reading and 35x under the least fault
RWKV_SERVE_LAYERS = 32
RWKV_LEAF_SEED = 37
RWKV_DECODE_FAULTS = ("k and v swapped in the state update",
                      "the token's kv left out of the state",
                      "the decay left out of the state update")
RWKV_F32_DECODE_REL = 2.0**-6
# c: bf16 training, AdamW, remat, at the deepest that peaks under ~70 GB:
# reckoned from phase 4f c's 53.5 GB at 1.67e9 parameters as 6 layers (1.85e9),
# which peaked at 59.2 GB on the card, about 6.2 GB a layer over 22 GB for
# the embedding, the head and the logits, so 7 layers (2.07e9) at ~65 GB;
# then remat on against off at 2 layers: every gradient leaf bit-equal but
# the embedding table's, within REMAT_EMBED_REL of its largest
RWKV_TRAIN_LAYERS, RWKV_REMAT_LAYERS = 7, 2
# d: the podded q8 step at 2 layers (0.974e9 parameters a pod)
RWKV_POD_LAYERS = 2
# e: jamba's Mamba sublayer at full width, bf16 activations, f32 weights
MAMBA_BATCH = 4
# The encoder-decoder family (phase 4h): seamless-m4t-medium (12 encoder and
# 12 decoder layers of d 1024, 16 heads of 64 with 16 kv heads, d_ff 4096,
# vocab 256,206 padded to 256,256; 977,860,608 parameters, 1.96 GB in
# bf16).  a: f32 (TF32 off) card against the CPU at 2 + 2 layers, B =
# TRAIN_F32_BATCH, SEAMLESS_SRC source frames and SEAMLESS_TGT target tokens
# (different lengths, so that a swap shows), every norm leaf (zeros at
# init, which would hide a swapped norm) redrawn from SEAMLESS_NORM_SEED on
# both sides, under phase 4e a's bounds (the logits, the padded columns
# included, within LM_F32_REL of the largest); each of ENCDEC_F32_FAULTS,
# planted on the card's side, must fail that gate
SEAMLESS_ARCH = "seamless-m4t-medium"
SEAMLESS_F32_LAYERS, SEAMLESS_SRC, SEAMLESS_TGT = 2, 128, 64
SEAMLESS_NORM_SEED = 41
ENCDEC_NORMS = ("norm1", "norm2", "norm_x", "enc_norm", "final_norm")
ENCDEC_F32_FAULTS = ("cross keys from the decoder's states", "causal encoder",
                     "norm_x and norm2 swapped", "pad mask skipped")
# b: serving at full width and depth through launch/serve's functions (B =
# LM_BATCH, LM_PROMPT source frames and prompt tokens, LM_GEN generated):
# decode against the train forward in f32 (TF32 off) within
# SEAMLESS_F32_DECODE_REL of the largest logit, set before the first card
# run to LM_F32_REL, then in bf16 within LM_BF16_REL (phase 4d's bound);
# each of ENCDEC_DECODE_FAULTS must read above the bound in both dtypes.
# The first card run read the sound f32 run 1.59e-6 and bf16 2^-6.6, the
# faults in bf16 0.88, 1.09 and, the self-cache index, 0.037: 1.18x over
# LM_BF16_REL (the same bits in every run), so the faults are gated in f32
# too, where the margin is wide
SEAMLESS_F32_DECODE_REL = LM_F32_REL
ENCDEC_DECODE_FAULTS = ("cross cache left zero after prefill",
                        "cross cache read from the wrong layer", "self-cache index off by one")
# c: bf16 training at full width and depth, AdamW, remat, B =
# SEAMLESS_BATCH, S_src = S_tgt = TRAIN_SEQ; remat on against off at 2 + 2
# layers.  B is cut from TRAIN_BATCH's 8 to 4: at 8 the first step ran out
# of the card's memory in the backward of the 256,256-column loss (31 GB
# allocated, 32.6 GB reserved but free, 15.6 GiB more asked for), whose f32
# copies of the (8, 1024, 256,256) logits are 8.4 GB each.  d: the podded
# q8 step at full depth and the same B (2 pods of weights and AdamW state,
# 27.4 GB, the pods' f32 gradients 7.8 GB, one pod's B 2 activations), 27 +
# 27 hop launches a step.  The checkpoint at 2 + 2 layers (8.4 GB a
# replica, most of it the 256,256-row embedding and head with their AdamW
# state; about 90 s of the phase) is left out: with it the whole script
# took 941.4 s on an H100 80GB HBM3 at 700 W, past the 900 s at which a
# phase is cut, and 4e e runs the same ckpt.py path on the card
SEAMLESS_BATCH, SEAMLESS_REMAT_LAYERS, SEAMLESS_POD_LAYERS = 4, 2, 12
# The podded step with one pod per rank (phase 4i): tinyllama-1.1b at full
# width, RANK_LAYERS layers, RANK_PODS ranks of a gloo ``pod`` group (the
# one card holds both: NCCL takes one rank a device), each with its pod's
# unpodded state and its share of phase 4e d's batches (B TRAIN_BATCH / 2,
# S TRAIN_SEQ), POD_STEPS steps.  Each of RANK_FAULTS, planted in the hop's
# all_gather, and RANK_KERNEL_FAULT, planted in the quantize kernel's output
# (one of HOP_FAULTS), must fail gate 1; the ranks are killed after
# RANK_TIMEOUT_S
RANK_ARCH, RANK_PODS, RANK_LAYERS = "tinyllama-1.1b", 2, 22
RANK_FAULTS = ("the gathered pods swapped", "each rank's own scales for both pods")
RANK_KERNEL_FAULT = HOP_FAULTS[0]
RANK_TIMEOUT_S = 600
# The dense family's step sharded inside a pod (phase 4j): tinyllama-1.1b at
# full width on SHARD_RANKS gloo ranks sharing the one card, a SHARD_MESH
# ("data", "model") mesh, totoro_tree, the parameters and the batch DTensors
# placed by launch/specs, every collective staged through pinned host
# buffers (launch/mesh.stage_through_host).  a: SHARD_F32_LAYERS layers in
# f32 (TF32 off), B SHARD_F32_BATCH, S SHARD_F32_SEQ, one sharded step
# against the same step in one process on the card: the loss within
# TRAIN_LOSS_RTOL, every state leaf within TRAIN_GRAD_REL of its largest;
# AdamW's first update moves a weight by lr g / (|g| + 1e-8), which turns a
# gradient's last bits into up to 2 lr where |g| is ~1e-8, so the weights
# are held to the single-process weights moved by lr times the difference
# of the two runs' AdamW directions (each from its own m and v), the
# gradients through m and v; each of SHARD_FAULTS, planted at run time in
# every rank, must fail the gate.  b: SHARD_LAYERS
# layers in bf16, B TRAIN_BATCH, S TRAIN_SEQ, SHARD_STEPS steps of
# launch/train.train(mesh=...); the losses within SHARD_BF16_LOSS_RTOL of the
# same steps in one process: the card read 1.15e-5 at these 4 layers (two
# runs, 5.59e-6 at 12), so 1e-4 is about 9x that; then SHARD_B_FAULT planted
# for SHARD_B_FAULT_STEPS steps of the same run must read above the bound
# (the gradient fault shows from the second step's loss on); the ranks are
# killed after SHARD_TIMEOUT_S
SHARD_ARCH, SHARD_RANKS, SHARD_MESH, SHARD_AXES = "tinyllama-1.1b", 4, (2, 2), ("data", "model")
SHARD_F32_LAYERS, SHARD_F32_BATCH, SHARD_F32_SEQ = 2, 4, 128
SHARD_LAYERS, SHARD_STEPS = 4, 3
SHARD_BF16_LOSS_RTOL = 1e-4
SHARD_FAULTS = ("wo's model reduction dropped", "the data gradient reduction skipped",
                "one data shard a copy of the other")
SHARD_B_FAULT, SHARD_B_FAULT_STEPS = SHARD_FAULTS[1], 2
SHARD_TIMEOUT_S = 600
# The dry-run (phase 4k): ``python -m repro_torch.launch.dryrun`` on 4j b's
# own cell, on a fake process group of SHARD_RANKS ranks, in a subprocess
# that never touches the card.  Gates: a, its collective calls of one step
# (op, mesh axis, bytes, in order), repeated for each of 4j b's steps, equal
# to 4j b's calls on rank 0, exactly; b, its
# argument bytes a device within DRYRUN_ARG_REL of what the placed state and
# batch take on each 4j rank (torch.cuda.memory_allocated before and after
# placing them, which the caching allocator's block rounding put 7.2e-4
# above on the H100; the allocator's requested bytes, which it does not
# round, equal to the byte); c, its peak a device within DRYRUN_PEAK_REL of 4j b's
# max_memory_allocated on each rank.  Printed, not gated: d, its FLOPs a
# device times the ranks against ``model_flops`` of that step.  Each of
# DRYRUN_FAULTS, planted in the dry-run's record, must fail its gate.  Then
# the dry-run of the production 16x16 mesh (256 fake ranks) at
# DRYRUN_PROD_LAYERS layers.  Both run after phase 4j, not beside it:
# beside it, even at the lowest CPU priority, they slowed 4j's steps from
# 2.9 to 4.2 s a rank on the H100's host; they are killed after
# DRYRUN_TIMEOUT_S
DRYRUN_ARG_REL, DRYRUN_PEAK_REL = 1e-3, 0.25
DRYRUN_FAULTS = ("a collective dropped from the log", "the largest state leaf counted twice")
DRYRUN_PROD_LAYERS, DRYRUN_TIMEOUT_S = 2, 300

KERNELS = [
    {
        "name": "tree_aggregate_groups",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_aggregate.cu",
        "replaces": "src/repro/kernels/tree_aggregate.py:119",
    },
    {
        "name": "tree_aggregate",  # the G = 1 case of the kernel above
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tree_aggregate.cu",
        "replaces": "src/repro/kernels/tree_aggregate.py:61",
    },
    {
        "name": "qsgd_quantize",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:40",
    },
    {
        "name": "qsgd_dequantize",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:70",
    },
    {
        "name": "apply_quantized_broadcast",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/broadcast.cu",
        "replaces": "src/repro/kernels/broadcast.py:36",
    },
    {
        "name": "fused_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_update.cu",
        "replaces": "src/repro/kernels/fused_update.py:29",
    },
    {
        "name": "policy_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_update.cu",
        "replaces": "src/repro/kernels/policy_update.py:60",
    },
]
COUNTED = ("tree_aggregate_groups", "qsgd_quantize", "qsgd_quantize_residual",
           "qsgd_dequantize", "apply_quantized_broadcast", "fused_update", "policy_update")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def check_tree_aggregate(torch, ta, ref, shapes) -> float:
    """Kernel vs plain versions at every (G, C, L, dtype): bit-equal to the
    fmaf chain, within TOL of the plain sum.  Ragged groups get zero rows
    with zero weights in their padding slots; int8 rows the compressed
    apply's small weights."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for G, C, L, dtype in shapes:
        if dtype == torch.int8:
            x = torch.randint(-128, 128, (G, C, L), device="cuda", generator=gen, dtype=dtype)
            w = torch.rand(G, C, device="cuda", generator=gen) * 1e-2
        else:
            x = torch.randn(G, C, L, device="cuda", generator=gen).to(dtype)
            w = torch.rand(G, C, device="cuda", generator=gen)
        if C > 1:  # ragged: group g keeps C - (g % C) real children
            for g in range(G):
                real = C - (g % C)
                x[g, real:] = 0
                w[g, real:] = 0
        out = ta.tree_aggregate_groups(x, w)
        torch.cuda.synchronize()
        want = ref.tree_aggregate_groups_ref(x, w)
        err = (out - want).abs()
        chain = torch.equal(out, ref.tree_aggregate_groups_chain(x, w))
        ok = chain and bool((err <= TOL["atol"] + TOL["rtol"] * want.abs()).all())
        worst = max(worst, float(err.max()))
        log(f"  tree_aggregate_groups G={G} C={C} L={L} {str(dtype)[6:]}: bit-equal to the "
            f"chain: {chain}; max_abs_err={float(err.max()):.3e} (rtol={TOL['rtol']}, "
            f"atol={TOL['atol']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("tree_aggregate_groups disagrees with its plain version")
    return worst


def counts() -> dict:
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels import broadcast as bc
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import policy_update as pu
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import tree_aggregate as ta

    return {"tree_aggregate_groups": ta.launches, **qz.launches,
            "apply_quantized_broadcast": bc.launches, "fused_update": fu.launches,
            "policy_update": pu.launches}


def set_counts(c: dict) -> None:
    from repro_torch.kernels import broadcast as bc
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import policy_update as pu
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import tree_aggregate as ta

    ta.launches = c["tree_aggregate_groups"]
    for name in qz.launches:
        qz.launches[name] = c[name]
    bc.launches = c["apply_quantized_broadcast"]
    fu.launches = c["fused_update"]
    pu.launches = c["policy_update"]


@contextmanager
def uncounted():
    """Launches made to check or time a kernel are not main-path launches."""
    saved = counts()
    try:
        yield
    finally:
        set_counts(saved)


def qsgd_rows(torch, R: int, seed: int):
    """(R, 256) rows at mixed magnitudes and their uniforms; row 0 is built
    so that floor(x/scale + u) reaches 128 at levels 127, the last row is
    all zeros."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(R, 256, device="cuda", generator=gen)
    x *= torch.rand(R, 1, device="cuda", generator=gen) * 10 + 1e-4
    u = torch.rand(R, 256, device="cuda", generator=gen)
    x[0] = torch.linspace(-0.1, 0.1, 256, device="cuda")
    x[0, 0] = 0.16625983
    u[0, 0] = 1.0 - 2.0**-24
    if R > 1:
        x[-1] = 0.0
    return x, u


def offset_view(torch, t, shift: int):
    """A copy of ``t`` as a view ``shift`` elements into a larger buffer."""
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    view = buf[shift:].view(t.shape)
    view.copy_(t)
    return view


def check_compression_kernels(torch, qz, bc, ta, ref) -> dict:
    """QSGD quantize (both instances), dequantize and the chain apply
    bit-equal to their plain versions, vector and scalar paths; the int8
    aggregation bit-equal to the f32 path on q.float() and within TOL of
    its plain version.  Returns max |err| per kernel."""
    errs = {"qsgd_quantize": 0.0, "qsgd_quantize_residual": 0.0, "qsgd_dequantize": 0.0,
            "apply_quantized_broadcast": 0.0, "tree_aggregate_groups_int8": 0.0}

    def note(name, ok, err, what):
        errs[name] = max(errs[name], err)
        log(f"  {name} {what}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} disagrees with its plain version at {what}")

    def diff(a, b) -> float:
        return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0

    gen = torch.Generator(device="cuda").manual_seed(3)
    for R in (1, 27, 4096):
        for levels in (127, 3, 7):
            x, u = qsgd_rows(torch, R, seed=R * 131 + levels)
            q, s = qz.qsgd_quantize(x, u, levels=levels)
            torch.cuda.synchronize()
            rq, rs, rr = ref.quantize_residual_ref(x, u, levels=levels)
            err = max(diff(q, rq), diff(s, rs))
            raw = float(torch.floor(x[0, 0] / s[0, 0] + u[0, 0]))
            ok = torch.equal(q, rq) and torch.equal(s, rs)
            if levels == 127:  # the row that overflows a wrapping cast saturates
                ok = ok and raw == 128.0 and int(q[0, 0]) == 127
            note("qsgd_quantize", ok, err,
                 f"R={R} levels={levels} bit-equal (row 0: floor={raw:.0f} -> q={int(q[0, 0])}; "
                 f"last row scale={float(s[-1, 0]):.3e})")
            for shift in (0, 1):  # 1: a 4-byte offset, the scalar kernel
                xv, uv = (offset_view(torch, t, shift) if shift else t for t in (x, u))
                q2, s2, r2 = qz.qsgd_quantize_residual(xv, uv, levels=levels)
                torch.cuda.synchronize()
                ok = (torch.equal(q2, rq) and torch.equal(s2, rs) and torch.equal(r2, rr)
                      and torch.equal(q2, q) and torch.equal(s2, s))
                if R > 1:  # the zero row: no lattice point, no residual
                    ok = ok and not q2[-1].any() and not r2[-1].any()
                note("qsgd_quantize_residual", ok, max(diff(r2, rr), diff(q2, rq)),
                     f"R={R} levels={levels} offset={shift} q, s, residual bit-equal; q and s "
                     f"= the no-residual instance's")
        for C, shift in ((256, 0), (256, 1), (300, 0), (7, 0)):  # 1: a 1-byte offset
            q = torch.randint(-128, 128, (R, C), device="cuda", generator=gen, dtype=torch.int8)
            s = torch.rand(R, 1, device="cuda", generator=gen) * 0.1
            qv = offset_view(torch, q, shift) if shift else q
            out = qz.qsgd_dequantize(qv, s)
            torch.cuda.synchronize()
            want = ref.dequantize_ref(q, s)
            note("qsgd_dequantize", torch.equal(out, want), diff(out, want),
                 f"R={R} C={C} offset={shift} bit-equal")
        for D in (1, 2, 3, 4, 5):
            for shift in ((0, 0), (1, 3)) if D in (1, 5) else ((0, 0),):  # w, q offsets
                w = torch.randn(R, 256, device="cuda", generator=gen)
                qc = torch.randint(-127, 128, (D, R, 256), device="cuda", generator=gen,
                                   dtype=torch.int8)
                sc = torch.rand(D, R, 1, device="cuda", generator=gen) * 0.05
                wv = offset_view(torch, w, shift[0]) if shift[0] else w
                qv = offset_view(torch, qc, shift[1]) if shift[1] else qc
                out = bc.apply_quantized_broadcast(wv, qv, sc)
                step = wv
                for d in range(D):
                    step = bc.apply_quantized_broadcast(step, qv[d : d + 1], sc[d : d + 1])
                torch.cuda.synchronize()
                want = ref.apply_quantized_ref(w, qc, sc)
                note("apply_quantized_broadcast", torch.equal(out, want) and torch.equal(out, step),
                     diff(out, want), f"R={R} D={D} offsets={shift} bit-equal, = {D} single steps")
    for G, C, L in ((27, 4, 256), (27, 3, 256), (29, 3, 256), (4096, 4, 256), (3, 5, 333),
                    (1, 16, 131072)):
        q = torch.randint(-128, 128, (G, C, L), device="cuda", generator=gen, dtype=torch.int8)
        w = torch.rand(G, C, device="cuda", generator=gen) * 1e-2
        out = ta.tree_aggregate_groups(q, w)
        f32 = ta.tree_aggregate_groups(q.float(), w)
        torch.cuda.synchronize()
        want = ref.tree_aggregate_groups_ref(q, w)
        err = (out - want).abs()
        ok = (torch.equal(out, f32) and torch.equal(out, ref.tree_aggregate_groups_chain(q, w))
              and bool((err <= TOL["atol"] + TOL["rtol"] * want.abs()).all()))
        note("tree_aggregate_groups_int8", ok, float(err.max()),
             f"G={G} C={C} L={L} = f32 path on q.float() = chain, plain within {TOL}")
    return errs


def check_fused_update(torch, fu, ops, ref, cases) -> float:
    """The fused update bit-equal to its plain version at every (L, dtype)
    and (lr, mu, wd); in place through ``ops.fused_update(donate=True)``
    and on a misaligned view too.  Returns max |err| (0 when bit-equal)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    for L, dtype in cases:
        w, g, w0 = (torch.randn(L, device="cuda", generator=gen).to(dtype) for _ in range(3))
        for lr, mu, wd in FUSED_HYPER:
            out = fu.fused_update(w, g, w0, lr=lr, mu=mu, wd=wd)
            torch.cuda.synchronize()
            want = ref.fused_update_ref(w, g, w0, lr, mu, wd)
            buf = w.clone()
            ops.fused_update(buf, g, w0, lr=lr, mu=mu, wd=wd, donate=True)
            base = torch.empty(L + 1, device="cuda", dtype=dtype)
            base[1:] = w
            shifted = fu.fused_update(base[1:], g, w0, lr=lr, mu=mu, wd=wd)  # misaligned w
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            worst = max(worst, err)
            if not (torch.equal(out, want) and torch.equal(buf, want) and torch.equal(shifted, want)):
                raise SystemExit(f"fused_update differs from its plain version at L={L} "
                                 f"{str(dtype)[6:]} (lr, mu, wd)={(lr, mu, wd)}: max |err| {err:.3e}")
        log(f"  fused_update L={L} {str(dtype)[6:]}: bit-equal at (lr, mu, wd) in {FUSED_HYPER}, "
            f"in place and misaligned ok")
    return worst


def leaf_table(torch, lengths, dtypes, seed, misaligned=()):
    """(w, g, w0) leaves on the card of the given lengths, dtypes cycled
    over the leaves; those at the indices in ``misaligned`` start one
    element past a 16-byte boundary."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = []
    for j, L in enumerate(lengths):
        shift = 1 if j in misaligned else 0
        dtype = dtypes[j % len(dtypes)]
        table.append(tuple(torch.randn(L + shift, device="cuda", generator=gen).to(dtype)[shift:]
                           for _ in range(3)))
    return [list(t) for t in zip(*table)]


def table_launches(fu, leaves) -> int:
    """Launches one ``fused_update_many`` call makes: per dtype present,
    one per ``max_leaves()`` leaves that hold an element.  ``leaves``:
    (numel, dtype) pairs."""
    per = {}
    for n, dtype in leaves:
        if n:
            per[dtype] = per.get(dtype, 0) + 1
    return sum(-(-c // fu.max_leaves()) for c in per.values())


def check_fused_tables(torch, fu, ops, ref, tables) -> float:
    """The multi-leaf update bit-equal to the plain version on every leaf
    of every (lengths, dtypes, misaligned) table, at every (lr, mu, wd),
    out of place and in place, with the launches the table implies."""
    worst = 0.0
    for t, (name, lengths, dtypes, misaligned) in enumerate(tables):
        ws, gs, w0s = leaf_table(torch, lengths, dtypes, seed=t, misaligned=misaligned)
        want_launches = table_launches(fu, [(int(w.numel()), w.dtype) for w in ws])
        for lr, mu, wd in FUSED_HYPER:
            with uncounted():
                before = fu.launches
                outs = fu.fused_update_many(ws, gs, w0s, lr=lr, mu=mu, wd=wd)
                bufs = [w.clone() for w in ws]
                ops.fused_update_leaves(bufs, gs, w0s, lr=lr, mu=mu, wd=wd, donate=True)
                torch.cuda.synchronize()
                made = fu.launches - before
            for j, (w, g, w0, out, buf) in enumerate(zip(ws, gs, w0s, outs, bufs)):
                want = ref.fused_update_ref(w, g, w0, lr, mu, wd)
                if w.numel():
                    worst = max(worst, float((out.float() - want.float()).abs().max()))
                if not (torch.equal(out, want) and torch.equal(buf, want)):
                    raise SystemExit(f"fused_update_many differs from its plain version on leaf {j} "
                                     f"of table {name} at (lr, mu, wd)={(lr, mu, wd)}")
            if made != 2 * want_launches:
                raise SystemExit(f"fused_update_many: table {name} made {made} launches, "
                                 f"expected 2 x {want_launches}")
        log(f"  fused_update_many table {name} ({len(lengths)} leaves, "
            f"{'/'.join(str(d)[6:] for d in dtypes)}, {len(misaligned)} misaligned): bit-equal per "
            f"leaf at (lr, mu, wd) in {FUSED_HYPER}, in place too; {want_launches} launch(es) a call")
    return worst


def policy_case(torch, pathplan, N: int, K: int, kind: str, seed: int, masks: str = "partial",
                M: int | None = None):
    """(pi, mask, cand, reward_sums) on the card.  ``kind``:
    ``candidate_policy_set`` (permuted corners that tie exactly, M = K + 9)
    or M Dirichlet rows without ties (default M = K + 9).  ``masks``:
    "partial" (random rows, a quarter of them full), "ones" (the planners'
    masks) or "mixed" (one shared partial row for most nodes, every third
    node its own, every fifth all ones: blocks whose first row is shared,
    distinct or full).  All-zero reward rows and policies at the 1e-12
    floor in every case."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "corners":
        cand = pathplan.candidate_policy_set(K, seed=0).cuda()
    else:
        e = -torch.log(torch.rand(K + 9 if M is None else M, K, device="cuda", generator=gen))
        cand = e / e.sum(-1, keepdim=True)
    mask = torch.rand(N, K, device="cuda", generator=gen) < 0.75
    mask[:, 0] = True
    if masks == "ones":
        mask[:] = True
    elif masks == "mixed":
        keep = torch.arange(N, device="cuda") % 3 == 0
        mask = torch.where(keep[:, None], mask, mask[0][None])
        mask[::5] = True
    else:
        mask[: max(1, N // 4)] = True
    pi = torch.rand(N, K, device="cuda", generator=gen) * mask
    pi[1::7] = torch.where(mask[1::7], 1e-12, 0.0)
    pi[1::7, 0] = 1.0
    pi = pi / pi.sum(-1, keepdim=True)
    rs = torch.rand(N, K, device="cuda", generator=gen) * 3.0
    rs = rs * (torch.rand(N, K, device="cuda", generator=gen) < 0.5) * mask
    rs[::5] = 0.0
    return pi.contiguous(), mask.contiguous(), cand.float().contiguous(), rs.contiguous()


POLICY_CASES = (  # (N, K, M or None, candidate kinds, mask kinds)
    [(N, K, None, ("corners", "dirichlet"), ("partial",))
     for N in (1, 128, 4096, 10_000, 1_000_000) for K in (2, 8, 16, 36)]
    + [(N, K, None, ("corners", "dirichlet"), ("ones", "mixed"))
       for N, K in ((1, 8), (128, 8), (128, 36), (4096, 16), (10_000, 16), (1_000_000, 16))]
    + [(N, K, M, ("dirichlet",), ("partial", "ones", "mixed"))
       for N, K, M in ((4096, 16, 70), (1000, 8, 100), (300, 64, 73), (77, 2, 300))]
)


def check_policy_update(torch, pu, ref, pathplan) -> float:
    """The policy update bit-equal to its plain version (within PLANNER_TOL
    at worst), and its rho and pi~ the plain version's on every node: line
    8 returns rho itself at alpha = 0 and pi~ at alpha = beta = 1, and
    those outputs too must equal the plain version's bit for bit (two
    candidates can only swap without changing them where they normalise
    to the same bits).  Partial, all-ones and mixed masks; M up to 300
    candidates (lanes own several).  The plain version runs in chunks of
    nodes."""
    tau, alpha, beta = 16, 0.98, 0.5
    worst, chunk = 0.0, 1 << 15
    for N, K, M, kinds, mask_kinds in POLICY_CASES:
        for kind in kinds:
            for masks in mask_kinds:
                pi, mask, cand, rs = policy_case(torch, pathplan, N, K, kind, seed=N + K,
                                                 masks=masks, M=M)
                outs = {hyper: pu.policy_update(pi, mask, cand, rs, tau=tau, alpha=hyper[0], beta=hyper[1])
                        for hyper in ((alpha, beta), (0.0, beta), (1.0, 1.0))}
                torch.cuda.synchronize()
                equal, err = {h: True for h in outs}, 0.0
                for a in range(0, N, chunk):
                    sl = slice(a, min(N, a + chunk))
                    for h, out in outs.items():
                        want = ref.policy_update_ref(pi[sl], mask[sl], cand, rs[sl], tau, *h)
                        equal[h] &= torch.equal(out[sl], want)
                        err = max(err, float((out[sl] - want).abs().max()))
                worst = max(worst, err)
                same_idx = equal[(0.0, beta)] and equal[(1.0, 1.0)]
                log(f"  policy_update N={N} K={K} M={cand.shape[0]} {kind} {masks} masks: "
                    f"{'bit-equal' if equal[(alpha, beta)] else f'max_abs_err={err:.3e}'}; "
                    f"rho (alpha=0) and pi~ (alpha=beta=1) bit-equal on every node: {same_idx}")
                if not same_idx or err > PLANNER_TOL:
                    raise SystemExit(f"policy_update differs from its plain version at N={N} K={K} "
                                     f"M={cand.shape[0]} {kind} {masks} masks")
    return worst


# ---------------------------------------------------------------------------
# phase 4: the main paths


def quickstart(device: str):
    """The README quickstart's system and MLP app on ``device``.  Returns
    (system, app, nodes, rng, x, y); ``rng``'s later draws pick the CNN
    app's workers."""
    from repro_torch import data
    from repro_torch.core.api import TotoroSystem
    from repro_torch.fl import rounds

    system = TotoroSystem(zone_bits=2, suffix_bits=24, seed=0)
    rng = np.random.default_rng(0)
    nodes = [
        system.Join("10.0.0.1", 9000 + i, site=i % 4, coord=rng.uniform(0, 100, 2))
        for i in range(400)
    ]
    x, y = data.synthetic_classification(4000, dim=32, num_classes=8, seed=0)
    parts = data.dirichlet_partition(y, num_clients=16, alpha=0.5, seed=1)
    workers = [int(w) for w in rng.choice(nodes, size=16, replace=False)]
    app = rounds.make_app(
        system, "quickstart-classifier", workers=workers,
        data_by_worker={w: (x[parts[i]], y[parts[i]]) for i, w in enumerate(workers)},
        dim=32, num_classes=8, local_steps=4, lr=0.2, mu=0.01, device=device,
    )
    return system, app, nodes, rng, x, y


class TrainingTally:
    """For one run: the fused-update launches its training dispatches imply
    (local steps x the launches one step's leaf table needs: one per dtype
    present, a table being at most ``max_leaves()`` leaves, in every
    ``megabatched_local_train`` call) and the leaf table, (numel, dtype) per
    leaf, of every ``ops.fused_update_leaves`` call."""

    def __enter__(self):
        from repro_torch.fl import engine
        from repro_torch.kernels import fused_update as fu
        from repro_torch.kernels import ops

        self.implied, self.tables = 0, set()
        self._mods = (engine, ops)
        self._orig = (engine.megabatched_local_train, ops.fused_update_leaves)
        train, update = self._orig

        def counted_train(params_stack, *a, steps, **kw):
            leaves = [(int(v.numel()), v.dtype) for v in params_stack.values()]
            self.implied += steps * table_launches(fu, leaves)
            return train(params_stack, *a, steps=steps, **kw)

        def recorded_update(ws, *a, **kw):
            self.tables.add(tuple((int(w.numel()), w.dtype) for w in ws))
            return update(ws, *a, **kw)

        engine.megabatched_local_train, ops.fused_update_leaves = counted_train, recorded_update
        return self

    def __exit__(self, *exc):
        engine, ops = self._mods
        engine.megabatched_local_train, ops.fused_update_leaves = self._orig


class AggShapes:
    """For one run: every (G, C, L, dtype) the aggregation wrapper was given."""

    def __enter__(self):
        from repro_torch.kernels import tree_aggregate as ta

        self.shapes, self._ta, self._orig = set(), ta, ta.tree_aggregate_groups
        orig = self._orig

        def recorded(grads, weights):
            self.shapes.add((*(int(n) for n in grads.shape), grads.dtype))
            return orig(grads, weights)

        ta.tree_aggregate_groups = recorded
        return self

    def __exit__(self, *exc):
        self._ta.tree_aggregate_groups = self._orig


def drive_main_path(device: str) -> dict:
    """The README quickstart, then 2 rounds of a CNN app, on ``device``."""
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rec = {"losses": [], "cnn_losses": [], "levels": [], "round_ms": [], "accs": []}
    with TrainingTally() as tally, AggShapes() as agg:
        _sync_rounds(device, rec, sync)
    rec["fused_implied"], rec["leaf_tables"] = tally.implied, tally.tables
    rec["agg_shapes"] = agg.shapes
    return rec


def _sync_rounds(device, rec, sync) -> None:
    from repro_torch import data
    from repro_torch.convert import params_to_numpy
    from repro_torch.fl import rounds

    system, app, nodes, rng, x, y = quickstart(device)

    def one_round(a, key):
        sync()
        t0 = time.perf_counter()
        m = rounds.run_round(system, a)
        sync()
        rec["round_ms"].append((time.perf_counter() - t0) * 1e3)
        rec[key].append(m["loss"])
        L = sum(int(v.numel()) for v in a.params.values())
        rec["levels"] += [
            (lv["groups"], lv["children"], L, lv["bytes"], lv["time_ms"])
            for lv in m["agg_levels"]
        ]
        return m

    for _ in range(8):
        one_round(app, "losses")
        rec["accs"].append(rounds.evaluate(app, x[:500], y[:500]))
    old = app.handle.tree.root
    report = system.fail_nodes(app.handle.app_id, [old])
    rec["new_master"] = report.new_master
    one_round(app, "losses")
    rec["params"] = params_to_numpy(app.params)

    xc, yc = data.synthetic_classification(4000, dim=256, num_classes=8, seed=2)
    xc = xc.reshape(-1, 16, 16, 1)
    parts_c = data.dirichlet_partition(yc, num_clients=16, alpha=0.5, seed=3)
    workers_c = [int(w) for w in rng.choice(nodes, size=16, replace=False)]
    cnn = rounds.make_app(
        system, "quickstart-cnn", workers=workers_c, model="cnn",
        data_by_worker={w: (xc[parts_c[i]], yc[parts_c[i]]) for i, w in enumerate(workers_c)},
        num_classes=8, local_steps=4, lr=0.1, seed=1, device=device,
    )
    for _ in range(2):
        one_round(cnn, "cnn_losses")
    rec["cnn_params"] = params_to_numpy(cnn.params)
    rec["live"] = (system, app)  # for the profiled rounds after the comparison
    rec["sizes"] = {
        "mlp": sum(int(v.numel()) for v in app.params.values()),
        "cnn": sum(int(v.numel()) for v in cnn.params.values()),
    }


def compare(name, a, b, tol) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.abs(a - b).max())
    if not np.allclose(a, b, **tol):
        raise SystemExit(f"{name}: card and CPU runs disagree (max abs {err:.3e}, {tol})")
    return err


def _host(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_host(x) for x in v)
    return v


class Recorder:
    """Wraps the kernel wrappers of ``repro_torch.kernels.ops`` for one run:
    every call's inputs and outputs, copied to the host, in call order."""

    NAMES = ("qsgd_quantize", "qsgd_quantize_residual", "qsgd_dequantize",
             "apply_quantized_broadcast", "tree_aggregate_groups")

    def __init__(self):
        self.calls = {n: [] for n in self.NAMES}

    def __enter__(self):
        from repro_torch.kernels import ops

        self._ops, self._orig = ops, {n: getattr(ops, n) for n in self.NAMES}
        for n, fn in self._orig.items():
            setattr(ops, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self._ops, n, fn)

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls[name].append((_host(args), dict(kw), _host(out)))
            return out

        return wrapped


def drive_async(device: str, compressed: bool, *, record: bool = False,
                perturb: float = 0.0, placement=None, downlink: str = "delta-qsgd",
                applies: int = ASYNC_APPLIES) -> dict:
    """Slice B: the quickstart app through ``run_async`` on ``device``;
    ``perturb`` scales each start weight by (1 + perturb * N(0, 1));
    ``placement`` is passed on (slice C's live re-placement); ``downlink``
    is the compressed policy's broadcast kind."""
    import torch

    from repro_torch.convert import params_to_numpy
    from repro_torch.core.sim import ChurnModel
    from repro_torch.fl import async_engine
    from repro_torch.fl.compression import CompressionPolicy

    system, app, *_ = quickstart(device)
    if perturb:
        gen = torch.Generator().manual_seed(123)
        for v in app.params.values():
            v.mul_(1 + perturb * torch.randn(v.shape, generator=gen).to(v.device))
    L = sum(int(v.numel()) for v in app.params.values())
    policy = None
    if compressed:  # bench_fairness.downlink_compare's policy, with EF on
        policy = CompressionPolicy(kind="qsgd-int8", error_feedback=True, downlink=downlink,
                                   downlink_levels=3, chain_cap=3)
    recorder = Recorder()
    with recorder if record else nullcontext(), TrainingTally() as tally, AggShapes() as agg:
        res = async_engine.run_async(
            system, [app], applies=applies, buffer_k=4, staleness_alpha=0.5,
            model_bytes=4.0 * L,
            compute_ms=async_engine.worker_compute_fn(base_ms=40, spread=6, seed=0),
            churn=ChurnModel(period_ms=500, downtime_ms=1500, seed=0, max_fail_events=2),
            compression=policy, placement=placement,
        )
        if device == "cuda":
            torch.cuda.synchronize()
    hist = res["history"]
    return {
        "events": [astuple(e) for e in res["events"]],
        "churn": [astuple(c) for c in res["churn"]],
        "downlink_log": list(res["scheduler"].downlink_log),
        "losses": [h["loss"] for h in hist],
        "arrivals": [h["arrivals"] for h in hist],
        "params": params_to_numpy(app.params),
        "L": L,
        "calls": recorder.calls if record else None,
        "replans": [astuple(r) for r in res["scheduler"].replan_log],
        "fused_implied": tally.implied, "leaf_tables": tally.tables, "agg_shapes": agg.shapes,
    }


def replay_on_cpu(torch, ref, calls) -> dict:
    """Every recorded kernel call of a card run, re-run through its plain
    version on the CPU: quantize (both instances: the EF residual too),
    dequantize and chain apply bit-equal, the int8 aggregation bit-equal to
    its fmaf chain and within TOL of the plain sum.  Returns the number of
    calls of each."""
    for (x, u), kw, (q, s) in calls["qsgd_quantize"]:
        rq, rs = ref.quantize_ref(x, u, levels=kw["levels"])
        if not (torch.equal(q, rq) and torch.equal(s, rs)):
            raise SystemExit(f"replay: qsgd_quantize (levels {kw['levels']}) differs from the card")
    for (x, u), kw, out in calls["qsgd_quantize_residual"]:
        if not all(map(torch.equal, out, ref.quantize_residual_ref(x, u, levels=kw["levels"]))):
            raise SystemExit(f"replay: qsgd_quantize_residual (levels {kw['levels']}) differs "
                             f"from the card")
    for (q, s), _, out in calls["qsgd_dequantize"]:
        if not torch.equal(out, ref.dequantize_ref(q, s)):
            raise SystemExit("replay: qsgd_dequantize differs from the card")
    for (w, q, s), _, out in calls["apply_quantized_broadcast"]:
        if not torch.equal(out, ref.apply_quantized_ref(w, q, s)):
            raise SystemExit("replay: apply_quantized_broadcast differs from the card")
    for (g, w), _, out in calls["tree_aggregate_groups"]:
        w = torch.as_tensor(w, dtype=torch.float32)
        want = ref.tree_aggregate_groups_ref(g, w)
        if not (torch.equal(out, ref.tree_aggregate_groups_chain(g, w))
                and bool(((out - want).abs() <= TOL["atol"] + TOL["rtol"] * want.abs()).all())):
            raise SystemExit("replay: int8 tree_aggregate_groups differs from the card")
    return {k: len(v) for k, v in calls.items()}


def async_launches_expected(run: dict, compressed: bool, downlink: str = "delta-qsgd") -> dict:
    """The launches a run's commits and applies imply: per apply, one
    aggregation; compressed, one quantize per commit (the residual instance:
    it writes the EF residual, so no dequantize follows) plus one for the
    broadcast, and per apply one chain apply (delta-qsgd: the broadcast
    state) or one dequantize (qsgd-int8: the dequantized broadcast)."""
    commits, applies = sum(run["arrivals"]), len(run["arrivals"])
    train = {"fused_update": run["fused_implied"], "policy_update": 0}
    if not compressed:
        return {"tree_aggregate_groups": applies, "qsgd_quantize": 0, "qsgd_quantize_residual": 0,
                "qsgd_dequantize": 0, "apply_quantized_broadcast": 0, **train}
    delta = downlink == "delta-qsgd"
    return {"tree_aggregate_groups": applies, "qsgd_quantize": commits + applies,
            "qsgd_quantize_residual": commits, "qsgd_dequantize": 0 if delta else applies,
            "apply_quantized_broadcast": applies if delta else 0, **train}


def demo_env(congestion, hops: int = 8, bw=(20.0, 100.0)):
    """The path-planning demo's hop set (``examples/path_planning_demo.py``):
    ``make_env(hops, seed=7, bw_range=bw)`` with 2 Mbit packets."""
    env = congestion.make_env(hops, seed=7, bw_range=bw)
    return congestion.CongestionEnv(capacity=env.capacity, theta=env.theta, packet_mbit=2.0)


class EpisodeRecorder:
    """Wraps one planner's ``update``: every episode's (pi before, actions,
    rewards, pi after), copied to the host, and what a replay needs."""

    def __init__(self, planner):
        self.episodes = []
        self.args = (planner.mask.cpu(), planner.cand.cpu(), planner.tau, planner.alpha, planner.beta)
        orig = planner.update

        def update(actions, rewards):
            before = planner.pi.cpu().clone()
            orig(actions, rewards)
            self.episodes.append((before, actions.cpu().clone(), rewards.cpu().clone(),
                                  planner.pi.cpu().clone()))

        planner.update = update


def drive_planners(device: str, *, record: bool = False) -> dict:
    """Slice C on ``device``: the demo's game (Totoro+, bandit, OPT; 128
    nodes, 8 hops, 40 episodes of tau = 16), Alg. 1 at Fig 15's N = 10,000,
    K = 16, tau = 8 (hop capacities scaled with the nodes per hop) for 20
    episodes, and Alg. 2 at N = 128 over subsets of up to 2 of 8 hops for
    20 episodes.  Returns each run's series and, with ``record``, every
    Alg.-1 episode of the policy-update runs."""
    import torch

    from repro_torch.core import congestion, multicast, pathplan

    env = demo_env(congestion)
    runs = {
        "totoro_plus": (pathplan.GameTheoreticPlanner(128, 8, tau=16, alpha=0.98, beta=0.5, seed=0,
                                                      device=device), env, 40),
        "bandit": (pathplan.BanditPlanner(128, 8, tau=16, device=device), env, 40),
        "opt": (pathplan.OptPlanner(env, 128, tau=16, device=device), env, 40),
        "fig15_n10000": (pathplan.GameTheoreticPlanner(10_000, 16, tau=8, alpha=0.9, beta=0.5, seed=0,
                                                       device=device),
                         demo_env(congestion, 16, (800.0, 4000.0)), 20),
    }
    out = {"series": {}, "episodes": {}, "episode_ms": {}}
    for name, (planner, e, episodes) in runs.items():
        rec = EpisodeRecorder(planner) if record and hasattr(planner, "cand") else None
        t0 = time.perf_counter()
        out["series"][name] = pathplan.run_planner(planner, e, episodes)
        out["episode_ms"][name] = (time.perf_counter() - t0) * 1e3 / episodes
        if rec is not None:
            out["episodes"][name] = rec
    mc = multicast.MulticastPlanner(128, 8, max_subset=2, tau=8, seed=0, device=device)
    rec = EpisodeRecorder(mc) if record else None
    gen, rewards = torch.Generator().manual_seed(0), []
    for _ in range(20):
        actions = mc.sample_actions(gen)
        r = mc.rewards(env, actions, pathplan.uniforms(gen, (mc.tau, 128, 8), device))
        mc.update(actions, r)
        rewards.append(float(r.double().mean()))
    out["series"]["multicast"] = {"mean_reward": rewards, "subset_usage": mc.subset_usage().tolist()}
    if rec is not None:
        out["episodes"]["multicast"] = rec
    return out


def reward_sums(torch, actions, rewards, K):
    """The per-hop reward sums ``algorithm1_episode`` forms."""
    rs = torch.zeros((actions.shape[0], K), dtype=torch.float64, device=actions.device)
    return rs.scatter_add_(1, actions.long(), rewards.double()).float()


def replay_planners(torch, ref, pathplan, card: dict) -> dict:
    """Every recorded Alg.-1 episode of the card run, re-run on the CPU
    through the plain version: the policies agree within PLANNER_TOL and
    rho and pi~ (the plain version's picks, on the card's inputs on the
    card and on the CPU) are the same on every node."""
    out = {}
    for name, rec in card["episodes"].items():
        mask, cand, tau, alpha, beta = rec.args
        worst = 0.0
        for pi_b, actions, rewards, pi_a in rec.episodes:
            got = pathplan.algorithm1_episode(pi_b, mask, cand, actions, rewards,
                                              tau=tau, alpha=alpha, beta=beta)
            worst = max(worst, float((got - pi_a).abs().max()))
            rs = reward_sums(torch, actions, rewards, pi_b.shape[1])
            on_cpu = ref.policy_choices(pi_b, mask, cand, rs, tau)[1:]
            on_card = ref.policy_choices(*(t.cuda() for t in (pi_b, mask, cand, rs)), tau)[1:]
            if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)):
                raise SystemExit(f"planner {name}: rho or pi~ differ between the card and the CPU")
        if worst > PLANNER_TOL:
            raise SystemExit(f"planner {name}: the CPU replay differs from the card by {worst:.3e}")
        out[name] = {"episodes": len(rec.episodes), "max_abs_err": worst}
    return out


def compare_planner_series(card: dict, cpu: dict) -> dict:
    """The card and CPU runs of the same seeds: every series within
    PLANNER_TOL (relative for cumulative latency)."""
    errs = {}
    for name, s in card["series"].items():
        for key, val in s.items():
            a, b = np.asarray(val, np.float64), np.asarray(cpu["series"][name][key], np.float64)
            scale = np.maximum(np.abs(b), 1.0) if key == "cum_latency_ms" else 1.0
            err = float(np.max(np.abs(a - b) / scale))
            errs[f"{name}.{key}"] = err
            if err > PLANNER_TOL:
                raise SystemExit(f"planner {name} {key}: card and CPU runs differ by {err:.3e}")
    return errs


# ---------------------------------------------------------------------------
# phase 5: times


def device_ms(torch, fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events.  The graph takes the
    host's per-call cost out, so this is the kernels' own time (inputs
    that fit stay in L2, as a tree level's freshly stacked rows do)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def eager_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Time of one call as the main path makes it, host cost included:
    CUDA events around ``iters`` back-to-back eager calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_tree_aggregate(torch, ta, ref, G, C, L, dtype) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(G, C, L, device="cuda", generator=gen).to(dtype)
    w = torch.rand(G, C, device="cuda", generator=gen)
    nbytes = G * C * L * x.element_size() + G * C * 4 + G * L * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2 * G * C * L / F32_FLOPS * 1e3
    kernel = lambda: ta.tree_aggregate_groups(x, w)
    einsum = lambda: torch.einsum("gc,gcl->gl", w, x)  # a batched GEMV via bmm
    lib_ms = None
    with uncounted():  # timing launches are not main-path launches
        if dtype == torch.float32:  # in turns with its one library call
            ms, lib_ms = abba_ms(torch, kernel, einsum)
        else:
            ms = device_ms(torch, kernel)
        call_ms = eager_ms(torch, kernel)
    row = {
        "shape": [G, C, L], "dtype": str(dtype)[6:], "ms": ms,
        "plain_ms": device_ms(torch, lambda: ref.tree_aggregate_groups_ref(x, w)),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": lib_ms, "eager_call_ms": call_ms, "bytes": nbytes,
        "GBps": nbytes / (ms * 1e-3) / 1e9, "bound_share": max(bound_bytes_ms, bound_ops_ms) / ms,
    }
    if lib_ms is not None:
        row["kernel_over_library"] = ms / lib_ms
    else:  # einsum needs one dtype: the bf16 input is widened first (two calls)
        row["einsum_of_widened_ms"] = device_ms(
            torch, lambda: torch.einsum("gc,gcl->gl", w, x.float())
        )
    return row


def profile_rounds(torch, system, app, n: int = 3) -> dict:
    """Steady quickstart rounds under torch.profiler: the device's busy
    and idle share of the round and its costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl import rounds

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            rounds.run_round(system, app)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / n
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "round_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_device": [
            (e.key[:60], e.count // n, e.self_device_time_total / 1e3 / n) for e in top
        ],
        "tree_aggregate_device_ms": sum(
            e.self_device_time_total for e in dev if "group_sum" in e.key
        ) / 1e3 / n,
        "fused_update_device_ms": sum(
            e.self_device_time_total for e in dev if "fused_update_kernel" in e.key
        ) / 1e3 / n,
    }


def _bits_equal(torch, a, b) -> bool:
    """Same shape, dtype and bits (so -0.0 differs from 0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return bool(torch.equal(a, b))


def _time_row(torch, fn, plain, nbytes: float, ops: float, library=None, *, calls: int = 50,
              replays: int = 20, **extra) -> dict:
    reps = dict(calls=calls, replays=replays)
    ms = device_ms(torch, fn, **reps)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    row = {
        "ms": ms, "plain_ms": device_ms(torch, plain, **reps), "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None if library is None else device_ms(torch, library, **reps),
        "eager_call_ms": eager_ms(torch, fn, iters=min(200, 4 * calls), warmup=min(20, calls)),
        "bytes": nbytes, "ops": ops, "GBps": nbytes / (ms * 1e-3) / 1e9,
    }
    row.update(extra)
    return row


def time_compression_kernels(torch, qz, bc, ta, ref, R: int, K: int = 4) -> dict:
    """The slice-B kernels at R rows of 256 (the path's R = 27, the kernel
    bench's 4096, or 65,536 rows whose 84-151 MB do not fit the 50 MB L2):
    quantize at levels 127 without and with the EF residual, dequantize, a
    chain apply of depth 1, and the int8 aggregation of K commits."""
    x, u = qsgd_rows(torch, R, seed=7)
    q, s = qz.qsgd_quantize(x, u)
    w = torch.randn(R, 256, device="cuda")
    q1, s1 = q[None], s[None]
    gq = torch.randint(-128, 128, (R, K, 256), device="cuda", dtype=torch.int8)
    gw = torch.rand(R, K, device="cuda") * 1e-2
    n = R * 256
    reps = dict(calls=10, replays=5) if R > 4096 else {}
    with uncounted():
        return {
            "qsgd_quantize": _time_row(  # abs, max, div, add, floor, 2 clamps
                torch, lambda: qz.qsgd_quantize(x, u), lambda: ref.quantize_ref(x, u),
                9 * n + 4 * R, 7 * n, shape=[R, 256], **reps),
            "qsgd_quantize_residual": _time_row(  # and a multiply and a subtraction
                torch, lambda: qz.qsgd_quantize_residual(x, u),
                lambda: ref.quantize_residual_ref(x, u), 13 * n + 4 * R, 9 * n, shape=[R, 256],
                **reps),
            "qsgd_dequantize": _time_row(
                torch, lambda: qz.qsgd_dequantize(q, s), lambda: ref.dequantize_ref(q, s),
                5 * n + 4 * R, n, library=lambda: torch.mul(q, s), shape=[R, 256], **reps),
            "apply_quantized_broadcast": _time_row(  # D = 1: one addcmul computes it
                torch, lambda: bc.apply_quantized_broadcast(w, q1, s1),
                lambda: ref.apply_quantized_ref(w, q1, s1), 8 * n + (n + 4 * R), 2 * n,
                library=lambda: torch.addcmul(w, q, s), shape=[1, R, 256], **reps),
            "tree_aggregate_groups_int8": _time_row(
                torch, lambda: ta.tree_aggregate_groups(gq, gw),
                lambda: ref.tree_aggregate_groups_ref(gq, gw),
                R * K * 256 + 4 * R * K + 4 * R * 256, 2 * R * K * 256, shape=[R, K, 256],
                einsum_of_widened_ms=device_ms(
                    torch, lambda: torch.einsum("gc,gcl->gl", gw, gq.float()), **reps), **reps),
        }


def abba_ms(torch, a, b, rounds: int = 2, **reps) -> tuple:
    """Device times of two functions measured in turns, a b b a, ``rounds``
    times over: the mean of each function's times."""
    ta, tb = [], []
    for _ in range(rounds):
        a1, b1, b2, a2 = (device_ms(torch, f, **reps) for f in (a, b, b, a))
        ta += [a1, a2]
        tb += [b1, b2]
    return float(np.mean(ta)), float(np.mean(tb))


def fused_row(torch, kernel, plain, nbytes: float, ops: float, library=None, **extra) -> dict:
    """A fused-update time row; with a library call, kernel and library are
    timed in turns (abba_ms) in this run."""
    if library is None:
        return _time_row(torch, kernel, plain, nbytes, ops, **extra)
    ms, lib_ms = abba_ms(torch, kernel, library)
    row = _time_row(torch, kernel, plain, nbytes, ops, **extra)
    row.update(ms=ms, library_ms=lib_ms, GBps=nbytes / (ms * 1e-3) / 1e9,
               kernel_over_library=ms / lib_ms)
    return row


def time_fused_update(torch, fu, ref, L: int, dtype, lr: float = 0.2, mu: float = 0.01) -> dict:
    """The fused update at L elements and (lr, mu), wd = 0 (the sync path's
    (0.2, 0.01) by default).  At mu = wd = 0 it reads no anchor (12 bytes an
    f32 element, not 16), and one PyTorch call computes it, ``torch.add(w,
    g, alpha=-lr)``, timed in turns with the kernel as ``library_ms``."""
    gen = torch.Generator(device="cuda").manual_seed(L)
    w, g, w0 = (torch.randn(L, device="cuda", generator=gen).to(dtype) for _ in range(3))
    s = w.element_size()
    prox = mu != 0.0
    with uncounted():
        return fused_row(  # sub + 3 fused multiply-adds per element, or 1 at mu = wd = 0
            torch, lambda: fu.fused_update(w, g, w0, lr=lr, mu=mu),
            lambda: ref.fused_update_ref(w, g, w0, lr, mu, 0.0),
            (4 if prox else 3) * s * L, (7 if prox else 2) * L,
            None if prox else (lambda: torch.add(w, g, alpha=-lr)),
            shape=[L], dtype=str(dtype)[6:], mu=mu)


def time_fused_table(torch, fu, ref, name: str, lengths, lr: float, mu: float) -> dict:
    """One local step's update of a whole f32 leaf table (one launch), and,
    for comparison, the same leaves as one single-leaf call each.  At mu =
    wd = 0 one PyTorch call computes the step: ``torch._foreach_add(ws,
    gs, alpha=-lr)``, timed in turns with the kernel as ``library_ms``."""
    ws, gs, w0s = leaf_table(torch, lengths, [torch.float32], seed=len(lengths))
    L = sum(lengths)
    prox = mu != 0.0
    with uncounted():
        row = fused_row(
            torch, lambda: fu.fused_update_many(ws, gs, w0s, lr=lr, mu=mu),
            lambda: [ref.fused_update_ref(w, g, w0, lr, mu, 0.0) for w, g, w0 in zip(ws, gs, w0s)],
            (16 if prox else 12) * L, (7 if prox else 2) * L,
            None if prox else (lambda: torch._foreach_add(ws, gs, alpha=-lr)),
            shape=[len(lengths), L], table=name, leaves=list(lengths), mu=mu)

        def per_leaf():
            for w, g, w0 in zip(ws, gs, w0s):
                fu.fused_update(w, g, w0, lr=lr, mu=mu)

        row["one_call_per_leaf_ms"] = device_ms(torch, per_leaf)
        row["one_call_per_leaf_eager_ms"] = eager_ms(torch, per_leaf)
    return row


def time_policy_update(torch, pu, ref, pathplan, N: int, K: int, masks: str) -> dict:
    """The policy update at N nodes over K hops with candidate_policy_set
    (M = K + 9), as the planners call it, on "ones" masks (the planners')
    or "partial" ones (every node computes its own line 5).  Bound: the
    larger of the bytes (pi, mask, rsum read, pi' written, cand once) and
    N*M*K logs plus 3*N*M*K fused multiply-adds at the f32 rate."""
    pi, mask, cand, rs = policy_case(torch, pathplan, N, K, "corners", seed=N, masks=masks)
    M = cand.shape[0]
    reps = dict(calls=3, replays=3) if N >= 100_000 else {}
    with uncounted():
        return _time_row(
            torch, lambda: pu.policy_update(pi, mask, cand, rs, tau=8, alpha=0.9, beta=0.5),
            lambda: ref.policy_update_ref(pi, mask, cand, rs, 8, 0.9, 0.5),
            N * K * 13 + 4 * M * K, 7 * N * M * K, shape=[N, K, M], masks=masks, **reps)


def time_planner(torch, N: int) -> dict:
    """Host time of each Alg.-1 episode of ``run_planner`` (sampling, tau
    packets' rewards and latencies, the policy update, the Nash-regret
    evaluation) at the demo's N = 128 or Fig 15's N = 10,000, then 5
    episodes under torch.profiler for the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import congestion, pathplan

    if N == 128:
        env, K, tau, alpha = demo_env(congestion), 8, 16, 0.98
    else:
        env, K, tau, alpha = demo_env(congestion, 16, (800.0, 4000.0)), 16, 8, 0.9
    p = pathplan.GameTheoreticPlanner(N, K, tau=tau, alpha=alpha, beta=0.5, seed=0, device="cuda")
    stamps, orig = [], p.sample_actions

    def stamped(gen):  # an episode starts with its draw (the last call: selection_freq's)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return orig(gen)

    p.sample_actions = stamped
    with uncounted():
        pathplan.run_planner(p, env, 10)
        host = list(np.diff(stamps) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pathplan.run_planner(p, env, 5)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "N": N, "K": K, "tau": tau, "episode_ms": host,
        "episode_ms_steady_mean": float(np.mean(host[1:])), "profiled_ms_5_episodes": wall_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "policy_update_device_ms": sum(e.self_device_time_total for e in dev
                                       if "policy_update_kernel" in e.key) / 1e3,
        "top_device": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    }


def time_async(torch) -> dict:
    """The compressed slice-B run on the card twice more: once with each
    apply timed on the host clock (synchronised before and after), once
    under torch.profiler for the device's busy share of the applies."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.async_engine import AsyncTrainer

    orig, apply_ms = AsyncTrainer.apply, []

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        torch.cuda.synchronize()
        apply_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    AsyncTrainer.apply = timed
    try:
        with uncounted():
            t0 = time.perf_counter()
            drive_async("cuda", True)
            run_ms = (time.perf_counter() - t0) * 1e3
            host_ms, apply_ms[:] = list(apply_ms), []
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                drive_async("cuda", True)
                torch.cuda.synchronize()
            prof_ms = list(apply_ms)
    finally:
        AsyncTrainer.apply = orig
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]

    def kernel_ms(tag):
        return sum(e.self_device_time_total for e in dev if tag in e.key) / 1e3

    return {
        "apply_ms": host_ms, "apply_ms_first": host_ms[0],
        "apply_ms_steady_mean": float(np.mean(host_ms[1:])), "run_ms": run_ms,
        "profiled_applies_ms": float(np.sum(prof_ms)), "device_busy_ms": busy_ms,
        "device_idle_share_of_applies": 1.0 - busy_ms / float(np.sum(prof_ms)),
        "top_device": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
        "kernel_device_ms": {
            "qsgd_quantize": kernel_ms("::quantize_rows"),  # both instances
            "qsgd_dequantize": kernel_ms("::dequantize_rows"),
            "apply_quantized_broadcast": kernel_ms("apply_chain"),
            "tree_aggregate_groups": kernel_ms("group_sum"),
            "fused_update": kernel_ms("fused_update_kernel"),
        },
    }


# ---------------------------------------------------------------------------
# phase 4d: FedAvg / DP on the card, then the LM serving path


def drive_fl_modules(torch, ops, system, app) -> dict:
    """``fl/aggregation`` and ``fl/dp`` on the quickstart MLP's per-worker
    deltas (one round's local training, made outside the counted run):
    fedavg and pairwise_accumulate against the aggregation kernel's G = 1
    entry (``ops.tree_aggregate_pytree``; its launch, read as the change in
    the aggregation kernel's count around that call, is the check's), and
    dp_sanitize on the card against the CPU under the same injected draws."""
    from repro_torch.fl import aggregation as agg
    from repro_torch.fl import dp, engine
    from repro_torch.kernels import tree_aggregate as ta
    from repro_torch.pytree import leaves

    workers = [w for w in sorted(app.handle.tree.members) if w in app.data]
    with uncounted():
        deltas, weights, _ = engine.local_training(app, workers)
        torch.cuda.synchronize()
    wn = (torch.tensor(weights) / sum(weights)).tolist()
    gen = torch.Generator().manual_seed(7)
    draws = [torch.randn(tuple(t.shape), generator=gen) for t in leaves(deltas[0])]
    set_counts(dict.fromkeys(COUNTED, 0))
    avg = agg.fedavg(deltas, weights)
    acc = None
    for d, w in zip(deltas, wn):
        acc = agg.pairwise_accumulate(acc, d, w)
    before = ta.launches
    kernel = ops.tree_aggregate_pytree(deltas, wn)
    g1_launches = ta.launches - before
    noised = dp.dp_sanitize(deltas[0], draws, clip=1.0, sigma=0.1)
    torch.cuda.synchronize()
    got = counts()
    cpu = [{k: v.cpu() for k, v in d.items()} for d in deltas]
    avg_cpu = agg.fedavg(cpu, weights)
    noised_cpu = dp.dp_sanitize(cpu[0], draws, clip=1.0, sigma=0.1)

    def worst(a, b, tol):
        errs = []
        for x, y in zip(leaves(a), leaves(b)):
            torch.testing.assert_close(x.cpu(), y.cpu(), **tol)
            errs.append(float((x.cpu() - y.cpu()).abs().max()))
        return max(errs)

    return {
        "workers": len(deltas), "L": sum(int(t.numel()) for t in leaves(deltas[0])),
        "launches": got, "tree_aggregate_launches": g1_launches,
        "fedavg_vs_kernel": worst(avg, kernel, TOL),
        "pairwise_vs_kernel": worst(acc, kernel, TOL),
        "fedavg_card_vs_cpu": worst(avg, avg_cpu, dict(rtol=0, atol=0)),
        "dp_card_vs_cpu": worst(noised, noised_cpu, TOL),
        "dp_global_norm": float(dp.global_norm(noised)),
    }


class LogitsRecorder:
    """Keeps the last position's logits of every prefill and decode forward
    that the serving steps make (``lm.forward``, ``encdec.prefill`` and
    ``encdec.decode_step`` wrapped for one run)."""

    def __enter__(self):
        from repro_torch.models import encdec, lm

        self.logits = []
        self._saved = [(lm, "forward", lm.forward), (encdec, "prefill", encdec.prefill),
                       (encdec, "decode_step", encdec.decode_step)]

        def lm_recorded(*args, **kw):
            out = self._saved[0][2](*args, **kw)
            if kw.get("mode") in ("prefill", "decode"):
                self.logits.append(out[0][:, -1].float())
            return out

        def encdec_recorded(fn):
            def recorded(*args, **kw):
                out = fn(*args, **kw)  # (cache, logits)
                self.logits.append(out[1][:, -1].float())
                return out
            return recorded

        lm.forward = lm_recorded
        encdec.prefill = encdec_recorded(encdec.prefill)
        encdec.decode_step = encdec_recorded(encdec.decode_step)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def serve_on_card(torch, cfg, *, seed: int = 0) -> dict:
    """One model through ``launch/serve``'s functions on the card: weights
    from ``lm.init_params`` (seeded CPU generator, ``drawn_on_card``), a
    random prompt, one
    prefill and LM_GEN - 1 greedy decodes; the decode logits held against
    the train-mode forward over the same LM_PROMPT + LM_GEN - 1 positions
    within LM_BF16_REL of its largest logit magnitude."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.pytree import leaves

    t0 = time.perf_counter()
    with drawn_on_card():
        params = lm.init_params(torch.Generator().manual_seed(seed), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = serve.make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator().manual_seed(seed + 1), "cuda")
    res, diffs, scale = decode_vs_forward(torch, params, cfg, batch)
    err = float(diffs.max())
    toks = res["tokens"]
    if err >= LM_BF16_REL * scale:
        raise SystemExit(f"{cfg.name}: decode logits differ from the train forward by {err:.4g} "
                         f"(bound {LM_BF16_REL} x {scale:.4g})")
    timed = serve.generate(params, cfg, batch, LM_GEN)  # warm: the times reported
    return {"params": params, "batch": batch, "init_s": init_s, "tokens": toks,
            "decode_vs_forward_max_abs": err, "max_abs_logit": scale,
            "decode_vs_forward_rel": err / scale, "first_run": res, "timed": timed,
            "weight_bytes": sum(t.numel() * t.element_size() for t in leaves(params))}


def decode_vs_forward(torch, params, cfg, batch) -> tuple:
    """``serve.generate`` for LM_GEN tokens, then the train-mode forward over
    the LM_PROMPT + LM_GEN - 1 positions its steps read: the run, the
    largest difference between each step's logits and the forward's for
    each row and step (B, LM_GEN) on the host (step 0: the prefill's last
    position) over the real vocabulary, and the forward's largest logit
    magnitude there; the serving logits' padded columns must read -1e9."""
    from repro_torch.launch import serve
    from repro_torch.models import encdec, lm

    with LogitsRecorder() as rec, torch.no_grad():
        res = serve.generate(params, cfg, batch, LM_GEN)
        seq = torch.cat([batch["tokens"], res["tokens"][:, :-1]], dim=1)
        if cfg.is_encoder_decoder:  # the same source frames, the target grown
            full = encdec.forward(params, cfg, {"embeds": batch["embeds"], "tokens": seq}).float()
        else:
            full = lm.forward(params, cfg, tokens=seq, mode="train")[0].float()
    torch.cuda.synchronize()
    steps = torch.stack(rec.logits, dim=1)  # (B, LM_GEN, V): prefill's last, then each decode
    want = full[:, LM_PROMPT - 1:]
    if steps.shape != want.shape or not bool(torch.isfinite(steps).all()):
        raise SystemExit(f"{cfg.name}: serving logits {tuple(steps.shape)} are not finite or not "
                         f"of the forward's shape {tuple(want.shape)}")
    if not torch.equal(res["tokens"], steps.argmax(-1).to(torch.int32)):
        raise SystemExit(f"{cfg.name}: the greedy tokens are not their logits' argmax")
    V = cfg.vocab_size  # padded columns: -1e9 here, rounded to bf16 in a bf16 forward
    if not bool((steps[..., V:] == -1e9).all()):
        raise SystemExit(f"{cfg.name}: the serving logits' padded vocabulary columns are not -1e9")
    steps, want = steps[..., :V], want[..., :V]
    return res, (steps - want).abs().amax(-1).cpu(), float(want.abs().max())


@contextmanager
def planted(owner, name: str, make):
    """``owner.name`` (``owner[name]`` where ``owner`` is a dict, as
    ``lm._MIXERS``) replaced by ``make(original)`` for the length of the
    block (a fault planted in the port at run time), restored after."""
    table = isinstance(owner, dict)
    orig = owner[name] if table else getattr(owner, name)
    put = owner.__setitem__ if table else lambda n, v: setattr(owner, n, v)
    put(name, make(orig))
    try:
        yield
    finally:
        put(name, orig)


def planted_decode_fault(kind: str):
    """One of DECODE_FAULTS in the GQA decode step, as a ``planted``
    context: ``lm``'s attention mixer entry, or
    ``attention.decode_attention``."""
    from repro_torch.models import attention, lm

    if kind == "own position masked":
        def masked(dec):
            def own_position_masked(q, k, v, mask):
                m = mask.clone()
                m[:, int(mask[0].nonzero()[-1])] = False
                return dec(q, k, v, m)
            return own_position_masked
        return planted(attention, "decode_attention", masked)
    if kind not in DECODE_FAULTS:
        raise ValueError(kind)

    def faulty(entry):
        fwd = entry[1]

        def forward(p, cfg, x, *, mode, cache=None, cache_index=None, **kw):
            if mode != "decode":
                return fwd(p, cfg, x, mode=mode, cache=cache, cache_index=cache_index, **kw)
            if kind == "cache_index - 1":
                return fwd(p, cfg, x, mode=mode, cache=cache, cache_index=int(cache_index) - 1,
                           **kw)
            out, _ = fwd(p, cfg, x, mode=mode, cache={k: v.clone() for k, v in cache.items()},
                         cache_index=cache_index, **kw)  # the k/v write lost
            return out, cache
        return (entry[0], forward, entry[2])
    return planted(lm._MIXERS, "attn", faulty)


def planted_faults(torch, cfg, params, batch) -> dict:
    """The decode-vs-forward reading of each of DECODE_FAULTS, as a share of
    the largest logit; each must exceed LM_BF16_REL."""
    out = {}
    for kind in DECODE_FAULTS:
        with planted_decode_fault(kind):
            _, diffs, scale = decode_vs_forward(torch, params, cfg, batch)
        out[kind] = float(diffs.max()) / scale
    passed = [k for k, rel in out.items() if not rel > LM_BF16_REL]
    if passed:
        raise SystemExit(f"{cfg.name}: LM_BF16_REL = {LM_BF16_REL} passes the planted decode "
                         f"faults {passed}: {out}")
    return out


def profile_decode(torch, cfg, params, batch, n: int = 8) -> dict:
    """``n`` steps of ``serve.decode`` under torch.profiler (each
    synchronised, as the serving loop is): the device's busy and idle share
    of a step, its device ops per step and its top five device ops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    P = batch["tokens"].shape[1]
    cache, tok = serve.start(params, cfg, batch, serve.full_cache(cfg, batch, n + 1))
    cache, toks, _ = serve.decode(params, cfg, cache, tok, P, 1)  # warm-up step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.decode(params, cfg, cache, toks[-1], P + 1, n)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / n
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "step_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_step": sum(e.count for e in dev) / n,
        "top_device": [(e.key[:70], e.count // n, e.self_device_time_total / 1e3 / n) for e in top],
    }


def serve_times(cfg, run: dict, smi: str) -> dict:
    """Prefill ms, decode ms/token (mean of decodes 2..), and the decode
    step's bound: the bytes it must read (every weight but the embedding
    table, of which it gathers B rows, and an encoder-decoder's encoder,
    plus the cache: GQA's k and v, MLA's latent and rope key,
    ``lm.cache_shapes``; the self and cross k and v of
    ``encdec.cache_shapes``) over HBM's rate."""
    from repro_torch.models import encdec, lm
    from repro_torch.pytree import leaves

    timed = run["timed"]
    dec = timed["decode_ms"]
    p = run["params"]
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in leaves(tree))
    unread = nbytes(p["embed"])
    if cfg.is_encoder_decoder:
        unread += nbytes(p["enc"]) + nbytes(p["enc_norm"])
        cache = encdec.cache_shapes(cfg, LM_BATCH, LM_PROMPT + LM_GEN, LM_PROMPT)
    else:
        cache = lm.cache_shapes(cfg, LM_BATCH, LM_PROMPT + LM_GEN)
    cache_bytes = nbytes(cache)
    read = (run["weight_bytes"] - unread + LM_BATCH * cfg.d_model * p["embed"].element_size()
            + cache_bytes)
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": LM_BATCH,
        "prompt": LM_PROMPT, "generated": LM_GEN, "prefill_ms": timed["prefill_ms"],
        "decode_ms_per_token": float(np.mean(dec[1:])), "decode_ms": dec,
        "first_run_prefill_ms": run["first_run"]["prefill_ms"],
        "weight_bytes": run["weight_bytes"],
        "bound_ms_all_weights": run["weight_bytes"] / HBM_BYTES_PER_S * 1e3,
        "bound_ms_decode_step": read / HBM_BYTES_PER_S * 1e3, "decode_read_bytes": read,
        "cache_bytes": cache_bytes,
        "init_s": run["init_s"], "card": smi,
    }


def f32_card_vs_cpu(torch) -> dict:
    """tinyllama-1.1b at full width and 2 layers in f32 (TF32 off), the same
    weights on the card and on the CPU: prefill logits within LM_F32_REL of
    the largest logit magnitude, and the first LM_F32_TOKENS greedy tokens
    identical up to the first step whose CPU top-2 margin is within that
    bound (after such a step a row's inputs may rightly differ)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.pytree import tree_map

    cfg = configs.get_config("tinyllama-1.1b").replace(num_layers=2, dtype="float32",
                                                       param_dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(2), cfg)
    batch = serve.make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator().manual_seed(3), "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        with LogitsRecorder() as rec, torch.no_grad():
            res = serve.generate(p, cfg, b, LM_F32_TOKENS)
        runs[dev] = (res["tokens"].cpu(), [l.cpu() for l in rec.logits])
    (tc, lc), (tg, lg) = runs["cpu"], runs["cuda"]
    scale = float(lc[0].abs().max())
    bound = LM_F32_REL * scale
    err = float((lg[0] - lc[0]).abs().max())
    top2 = torch.stack([l.topk(2, dim=-1).values for l in lc], dim=1)  # (B, steps, 2)
    margin = top2[..., 0] - top2[..., 1]
    compared = 0
    for r in range(LM_BATCH):
        for j in range(LM_F32_TOKENS):
            if tg[r, j] != tc[r, j]:
                raise SystemExit(f"f32 card vs CPU: row {r} step {j} token {int(tg[r, j])} vs "
                                 f"{int(tc[r, j])} at a CPU top-2 margin {float(margin[r, j]):.3g}")
            compared += 1
            if float(margin[r, j]) <= bound:
                break
    if err > bound:
        raise SystemExit(f"f32 card vs CPU: prefill logits differ by {err:.3g} > {bound:.3g}")
    return {"prefill_logits_max_abs": err, "max_abs_logit": scale, "rel": err / scale,
            "bound": bound, "tokens_compared": compared, "tokens": tc.tolist(),
            "min_top2_margin": float(margin.min())}


def chunked_vs_sdpa(torch, cfg) -> dict:
    """The port's chunked attention core at the prefill shape beside one
    ``scaled_dot_product_attention`` call (a yardstick only: the path runs
    the chunked core), host cost included."""
    import torch.nn.functional as F

    from repro_torch.models import attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (LM_BATCH, LM_PROMPT, cfg.num_heads, cfg.head_dim)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(cfg.adtype) for _ in range(3))
    chunked = lambda: attention.chunked_attention(q, k, v, chunk_q=cfg.attn_chunk,
                                                  chunk_kv=cfg.attn_chunk)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    err = float((chunked().float() - sdpa().transpose(1, 2).float()).abs().max())
    return {"shape": list(shape), "dtype": cfg.dtype, "chunked_ms": eager_ms(torch, chunked),
            "sdpa_ms": eager_ms(torch, sdpa), "max_abs_diff": err}


def drive_lm(torch, smi: str) -> dict:
    """Phase 4d's LM part: b, c and d of the module docstring."""
    from repro_torch import configs

    bf16_rr = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # f32 accumulation
    try:
        return _drive_lm(torch, smi, bf16_rr)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16_rr


def _drive_lm(torch, smi: str, bf16_rr: bool) -> dict:
    from repro_torch import configs

    out = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "allow_bf16_reduced_precision_reduction": False, "default_bf16_rr": bf16_rr}
    set_counts(dict.fromkeys(COUNTED, 0))
    tiny = configs.get_config("tinyllama-1.1b")
    run = serve_on_card(torch, tiny)
    out["tinyllama"] = serve_times(tiny, run, smi)
    out["tinyllama"].update(decode_vs_forward_max_abs=run["decode_vs_forward_max_abs"],
                            decode_vs_forward_rel=run["decode_vs_forward_rel"],
                            tokens_row0=run["tokens"][0].tolist())
    qwen = configs.get_config("qwen3-8b").replace(num_layers=QWEN_LAYERS)
    qrun = serve_on_card(torch, qwen, seed=10)
    out["qwen3"] = serve_times(qwen, qrun, smi)
    out["qwen3"].update(decode_vs_forward_max_abs=qrun["decode_vs_forward_max_abs"],
                        decode_vs_forward_rel=qrun["decode_vs_forward_rel"])
    del qrun
    torch.cuda.synchronize()
    out["launches"] = counts()
    out["f32_2layer"] = f32_card_vs_cpu(torch)
    with uncounted():
        out["tinyllama_planted_faults"] = planted_faults(torch, tiny, run["params"], run["batch"])
        out["tinyllama_decode_profile"] = profile_decode(torch, tiny, run["params"], run["batch"])
        out["attention_at_prefill_shape"] = chunked_vs_sdpa(torch, tiny)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out



# ---------------------------------------------------------------------------
# phase 4e: the LM training path


def _rel(torch, a, b) -> float:
    """max |a - b| over max |b|."""
    b = b.float()
    return float((a.float() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _leaf_rels(torch, got: dict, want: dict) -> dict:
    from repro_torch.ckpt import key_paths
    from repro_torch.pytree import leaves

    return {p: _rel(torch, a.cpu(), b.cpu()) for p, a, b in zip(key_paths(want), leaves(got),
                                                                  leaves(want))}


def _card_vs_cpu_run(torch, fn, inputs: dict, fault: str | None = None) -> dict:
    """``fn(inputs on dev)`` on the CPU and on the card and, with ``fault``
    (one of RECURRENT_F32_FAULTS), on the card again under it: each a dict
    of host tensors (or trees)."""
    from repro_torch.pytree import tree_map

    plan = [("cpu", "cpu", nullcontext()), ("card", "cuda", nullcontext())]
    if fault:
        plan.append(("fault", "cuda", recurrent_fault(fault)))
    runs = {}
    for tag, dev, ctx in plan:
        with ctx:
            runs[tag] = tree_map(lambda t: t.detach().cpu(),
                                 fn(tree_map(lambda t: t.to(dev), inputs)))
        torch.cuda.empty_cache()
    return runs


def _gate(out: dict, bounds: dict) -> bool:
    return all(out[k] <= b for k, b in bounds.items())


def cut_depth(cfg, layers: int):
    """``cfg`` at ``layers`` layers; an encoder-decoder's encoder too."""
    return cfg.replace(num_layers=layers,
                       **({"enc_layers": layers} if cfg.is_encoder_decoder else {}))


def lm_f32_card_vs_cpu(torch, arch: str, layers: int, seed: int, fault: str | None = None) -> dict:
    """a (phases 4e, 4f, 4g): ``arch`` at full width and ``layers`` layers
    in f32 (remat on, TF32 off), B = TRAIN_F32_BATCH, S = TRAIN_F32_SEQ, the
    same weights and batch on the card and on the CPU: the train-mode
    forward's logits within LM_F32_REL of the largest; the loss (and an MoE
    model's aux loss, which must be positive) within TRAIN_LOSS_RTOL; every
    gradient leaf (``grads_and_metrics``; the routers' included) within
    TRAIN_GRAD_REL of its largest; every top-k expert index of the forward
    and of the backward's recompute equal.  Then the optimizer alone:
    ``build_train_step``'s update (AdamW: m, v, the master weights) on the
    card and on the CPU from the same inputs, the CPU's weights and
    gradients, every leaf within TRAIN_ADAM_REL of its largest (from the
    gradients each side computed, the first step's m is 0.1 g and would
    only repeat the gradient check).  With ``fault``, the card run under it
    must fail the gate."""
    from repro_torch import configs, optim
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.pytree import tree_map

    cfg = configs.get_config(arch).replace(num_layers=layers, dtype="float32",
                                           param_dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(seed), cfg)
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, TRAIN_F32_SEQ,
                                                     TRAIN_F32_BATCH), 0, None, "cpu")
    opt = optim.make_optimizer(cfg)
    n_moe = _n_moe(cfg)

    def fn(inp):
        p, b = inp["params"], inp["batch"]
        with RoutingRecorder() as rec:
            with torch.no_grad():
                logits, _, aux = lm.forward(p, cfg, tokens=b["tokens"], mode="train")
            g, m = steps.grads_and_metrics(cfg, RunPlan(), p, b)
        return {"logits": logits, "aux": torch.as_tensor(aux), "loss": m["loss"],
                "aux_step": torch.as_tensor(m["aux"]), "grads": g, "idx": rec.idx}

    runs = _card_vs_cpu_run(torch, fn, {"params": params, "batch": batch}, fault)
    cpu = runs["cpu"]

    def update(dev):  # the plain train step's optimizer update
        p, g = (tree_map(lambda t: t.to(dev), x) for x in (params, cpu["grads"]))
        new, state = opt.update(g, opt.init(p), p)
        return tree_map(lambda t: t.cpu(), {"params": new, "opt": state})

    adam = _leaf_rels(torch, update("cuda"), update("cpu"))
    torch.cuda.empty_cache()

    def read(run):
        flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                    for a, b in zip(run["idx"], cpu["idx"]))
        grads = _leaf_rels(torch, run["grads"], cpu["grads"])
        rel = lambda k: abs(float(run[k]) - float(cpu[k])) / max(abs(float(cpu[k])), 1e-30)
        return {"logits_rel": _rel(torch, run["logits"], cpu["logits"]), "loss_rel": rel("loss"),
                "aux_rel": rel("aux") if n_moe else 0.0, "grad_rel_max": max(grads.values()),
                "tokens_routed_differently": flips,
                "topk_calls_off": abs(len(run["idx"]) - (2 + cfg.remat) * n_moe),
                "grad_rel": grads}

    bounds = {"logits_rel": LM_F32_REL, "loss_rel": TRAIN_LOSS_RTOL, "aux_rel": TRAIN_LOSS_RTOL,
              "grad_rel_max": TRAIN_GRAD_REL, "tokens_routed_differently": 0, "topk_calls_off": 0}
    card = runs["card"]
    out = dict(read(card), arch=arch, layers=layers, adam_rel_max=max(adam.values()),
               loss_cpu=float(cpu["loss"]),
               loss_card=float(card["loss"]), aux_cpu=float(cpu["aux"]),
               aux_card=float(card["aux"]), aux_step_equals_forward=bool(
                   torch.equal(card["aux_step"], card["aux"])),
               topk_calls=len(card["idx"]), tokens_routed=sum(int(a[..., 0].numel())
                                                              for a in cpu["idx"]))
    out["router_grad_rel"] = {k: v for k, v in out["grad_rel"].items() if k.endswith("router")}
    passed = (_gate(out, bounds) and out["adam_rel_max"] <= TRAIN_ADAM_REL
              and (not n_moe or out["aux_cpu"] > 0))
    if fault:
        bad = read(runs["fault"])
        out["planted_fault"] = {"kind": fault, **{k: bad[k] for k in bounds}}
    if not passed or (fault and _gate(bad, bounds)):
        raise SystemExit(f"{arch} f32 card vs CPU: the gate fails, or passes the planted fault: "
                         f"{out}")
    return out


def remat_agreement(torch, arch: str, layers: int, seed: int,
                    global_batch: int = TRAIN_BATCH) -> dict:
    """c (phases 4f, 4g, 4h): ``arch`` at full width, ``layers`` layers
    (an encoder-decoder's encoder too), bf16,
    B = ``global_batch``, S = TRAIN_SEQ, on the card: the gradients with remat
    ("nothing": the block recomputed in the backward, its routing and its
    chunk checkpoints with it) and without; the recompute's top-k indices
    equal the forward's, the loss and aux equal, every leaf bit-equal but
    the embedding table's (within REMAT_EMBED_REL of its largest: its
    backward adds repeated tokens' rows in any order)."""
    from repro_torch import configs
    from repro_torch.ckpt import key_paths
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.models import encdec, lm
    from repro_torch.pytree import leaves

    cfg = cut_depth(configs.get_config(arch), layers)
    model = encdec if cfg.is_encoder_decoder else lm
    params = model.init_params(torch.Generator().manual_seed(seed), cfg, device="cuda")
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, TRAIN_SEQ, global_batch), 0,
                             None, "cuda")
    with RoutingRecorder() as rec:
        on, m_on = steps.grads_and_metrics(cfg, RunPlan(), params, batch)
    off, m_off = steps.grads_and_metrics(cfg.replace(remat=False), RunPlan(), params, batch)
    torch.cuda.synchronize()
    n = _n_moe(cfg)
    recompute_same = len(rec.idx) == 2 * n and all(
        torch.equal(rec.idx[i], rec.idx[n + i]) for i in range(n))
    unequal = [p for p, a, b in zip(key_paths(on), leaves(on), leaves(off)) if not torch.equal(a, b)]
    out = {"arch": arch, "layers": layers, "batch": global_batch, "remat_policy": cfg.remat_policy,
           "recompute_routes_the_same": recompute_same,
           "loss_equal": bool(torch.equal(m_on["loss"], m_off["loss"])),
           "aux_equal": bool(torch.equal(torch.as_tensor(m_on["aux"]),
                                         torch.as_tensor(m_off["aux"]))),
           "leaves": len(leaves(on)), "leaves_not_bit_equal": unequal,
           "embed_rel": _rel(torch, on["embed"], off["embed"])}
    if (not recompute_same or not out["loss_equal"] or not out["aux_equal"]
            or set(unequal) - {"embed"} or out["embed_rel"] > REMAT_EMBED_REL):
        raise SystemExit(f"{arch} remat against no remat on the card: {out}")
    return out


def _chunks(x, chunk: int, G: int):
    """(B, S, H, D) -> the flash core's (nS, B, chunk, H // G, G, D) view."""
    B, S, H, D = x.shape
    return x.reshape(B, S // chunk, chunk, H // G, G, D).transpose(0, 1)


def planted_flash_fault(kind: str, nq: int):
    """One of FLASH_FAULTS in ``models/attention``'s flash backward
    (``_bwd_q_chunk``), as a ``planted`` context."""
    from repro_torch.models import attention

    def make(orig):
        def faulty(iq, q_i, do_i, lse_i, delta_i, *rest):
            if kind == "delta dropped":
                return orig(iq, q_i, do_i, lse_i, delta_i * 0, *rest)
            dq, dk, dv = orig(iq, q_i, do_i, lse_i, delta_i, *rest)
            return (dq, dk, dv) if iq == nq - 1 else (dq, dk * 0, dv * 0)
        return faulty
    return planted(attention, "_bwd_q_chunk", make)


def flash_backward_on_card(torch) -> dict:
    """b: ``_Flash``'s dq, dk, dv at FLASH_SHAPE, causal, two query and two
    key chunks of 512, against autograd through the plain chunked forward
    (``attention._flash_fwd``, differentiated op by op) in f32 on the card:
    bf16 within FLASH_BF16_REL, f32 within FLASH_F32_REL of each gradient's
    largest magnitude; each of FLASH_FAULTS, planted, must read above
    FLASH_BF16_REL.  Then _Flash's forward plus backward beside
    ``scaled_dot_product_attention``'s (a yardstick only)."""
    import torch.nn.functional as F

    from repro_torch.models import attention

    B, S, H, D = FLASH_SHAPE
    chunk = 512
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    xs = [t.float().requires_grad_(True) for t in (q, k, v)]
    out, _ = attention._flash_fwd(_chunks(xs[0], chunk, 1), _chunks(xs[1], chunk, 1)[..., 0, :],
                                  _chunks(xs[2], chunk, 1)[..., 0, :], True, 0, None, D ** -0.5)
    want = torch.autograd.grad(out.transpose(0, 1).reshape(B, S, H, D), xs, do.float())
    del out

    def flash(dtype):
        ins = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        o = attention.chunked_attention(*ins, chunk_q=chunk, chunk_kv=chunk)
        return torch.autograd.grad(o, ins, do.to(dtype))

    names = ("dq", "dk", "dv")
    got16 = flash(torch.bfloat16)
    res = {"bf16": {n: _rel(torch, a, b) for n, a, b in zip(names, got16, want)},
           "f32": {n: _rel(torch, a, b) for n, a, b in zip(names, flash(torch.float32), want)},
           "dtypes": [str(t.dtype)[6:] for t in got16], "faults": {}}
    for kind in FLASH_FAULTS:
        with planted_flash_fault(kind, S // chunk):
            res["faults"][kind] = {n: _rel(torch, a, b) for n, a, b in
                                   zip(names, flash(torch.bfloat16), want)}
    del want, got16
    if (max(res["bf16"].values()) > FLASH_BF16_REL or max(res["f32"].values()) > FLASH_F32_REL
            or res["dtypes"] != ["bfloat16"] * 3):
        raise SystemExit(f"flash backward on the card past its bounds: {res}")
    passed = [k for k, r in res["faults"].items() if not max(r.values()) > FLASH_BF16_REL]
    if passed:
        raise SystemExit(f"FLASH_BF16_REL = {FLASH_BF16_REL} passes the planted faults {passed}")
    res["fault_margin"] = min(max(r.values()) for r in res["faults"].values()) / FLASH_BF16_REL
    ins = [t.requires_grad_(True) for t in (q.clone(), k.clone(), v.clone())]
    tq, tk, tv = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)
    res["flash_fwd_bwd_ms"] = eager_ms(torch, lambda: torch.autograd.grad(
        attention.chunked_attention(*ins, chunk_q=chunk, chunk_kv=chunk), ins, do),
        iters=5, warmup=2)
    res["sdpa_fwd_bwd_ms"] = eager_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(tq, tk, tv, is_causal=True), (tq, tk, tv), dot),
        iters=20, warmup=3)
    res["shape"] = list(FLASH_SHAPE)
    return res


def _profile_step(torch, fn) -> dict:
    """One call of ``fn`` (a train step) under torch.profiler: its wall
    time, the device's busy and idle share, device ops, top five."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)
    return {
        "step_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops": sum(e.count for e in dev),
        "top_device": [(e.key[:70], e.count, e.self_device_time_total / 1e3) for e in top[:5]],
        "q8_hop_kernels_ms": {  # the QSGD kernels' device time (none in a plain step)
            "qsgd_quantize": sum(e.self_device_time_total for e in dev if "quantize_rows" in e.key
                                 and "dequantize" not in e.key) / 1e3,
            "qsgd_dequantize": sum(e.self_device_time_total for e in dev
                                   if "dequantize_rows" in e.key) / 1e3},
    }


@contextmanager
def drawn_on_card():
    """For the block, ``nn.truncated_normal_init`` draws on the card: the
    same law (a uniform's inverse CDF, clipped to [-2, 2]) from a CUDA
    generator seeded by the next draw of the CPU generator it is handed,
    so a full-size init spends no host time on its draws (rwkv6-7b's
    7.53e9 took 60.9 s on the host).  The weights are another draw of the
    same law, a function of the seed as before."""
    import math

    import torch

    from repro_torch.models import nn

    def make(_host_draws):
        def on_card(gen, shape, dtype, stddev):
            seed = int(torch.randint(0, 2**62, (1,), generator=gen))
            t = torch.empty(tuple(shape), dtype=torch.float32, device="cuda")
            t.uniform_(nn._ERF_LO, nn._ERF_HI,
                       generator=torch.Generator(device="cuda").manual_seed(seed))
            t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
            return t.mul_(stddev).to(dtype)
        return on_card

    with planted(nn, "truncated_normal_init", make):
        yield


@contextmanager
def frozen_heap():
    """For the block: the script's own heap (every object alive now) out
    of the garbage collector's reach (``gc.freeze``), so that a phase's
    timed loops pay for collecting their own objects only, as in a
    process that runs that phase alone.  Blocks do not nest."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def gc_during(fn) -> tuple:
    """``fn()`` and the count and ms of the garbage collections made
    meanwhile (``gc.callbacks``)."""
    got, start = {"collections": 0, "ms": 0.0}, [0.0]

    def timer(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            got["collections"] += 1
            got["ms"] += (time.perf_counter() - start[0]) * 1e3

    gc.callbacks.append(timer)
    try:
        return fn(), got
    finally:
        gc.callbacks.remove(timer)


def model_flops(cfg, tokens: int, seq: int) -> float:
    """6 N T + 3 L H (Dk + Dv) S T: N the active parameters
    (``lm.count_params_analytic``: a token's top-k experts, not all of them)
    without the embedding table; L the attention layers, causal, with q/k
    head dim Dk and v head dim Dv (head_dim both for GQA; MLA's Dk adds
    qk_rope_dim).  The recurrent mixers' cores are left out: RWKV's chunked
    wkv products and Mamba's scan count only through their weights in N.

    An encoder-decoder config (``launch/train``'s batches: source frames
    and target tokens of ``seq`` each, T tokens of each a step): N is the
    encoder, the decoder and the head (``encdec.count_params_analytic``
    without ``embed``), and the attention term counts three groups, the
    encoder's bidirectional self-attention (twice the causal count), the
    decoder's causal self-attention, and its cross-attention over the
    source (bidirectional, twice):

        6 N T + 3 H (Dk + Dv) S T (2 L_enc + L_dec + 2 L_dec)."""
    from repro_torch.models import encdec, lm

    if cfg.is_encoder_decoder:
        n = encdec.count_params_analytic(cfg)[0] - cfg.padded_vocab * cfg.d_model
        layers = 2 * cfg.enc_layers + 3 * cfg.num_layers
        return 6.0 * n * tokens + 3.0 * layers * cfg.num_heads * 2 * cfg.head_dim * seq * tokens
    n = lm.count_params_analytic(cfg)[1] - cfg.padded_vocab * cfg.d_model
    dk = cfg.head_dim + (cfg.qk_rope_dim if cfg.attn_impl == "mla" else 0)
    n_attn = (sum(m in ("attn", "mla") for m, _ in lm.layer_pattern(cfg)) * lm.num_blocks(cfg)
              + cfg.first_dense)
    return 6.0 * n * tokens + 3.0 * n_attn * cfg.num_heads * (dk + cfg.head_dim) * seq * tokens


def train_lm(torch, smi: str, cfg, global_batch: int = TRAIN_BATCH) -> dict:
    """c (4e: tinyllama-1.1b at full width and depth; 4f: deepseek-v2-lite
    at full width, MOE_TRAIN_LAYERS layers; 4g: rwkv6-7b at full width,
    RWKV_TRAIN_LAYERS layers; 4h: seamless-m4t-medium at full width and
    depth, B SEAMLESS_BATCH), bf16, AdamW, remat on, through
    ``launch/train.train`` (its garbage collections timed, ``gc_during``):
    TRAIN_STEPS steps of B = ``global_batch``, S = TRAIN_SEQ, losses finite and
    falling (an MoE model's aux losses finite and positive); then one more
    step under torch.profiler."""
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.models import encdec, lm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    set_counts(dict.fromkeys(COUNTED, 0))
    t0 = time.perf_counter()
    run, collected = gc_during(lambda: train.train(
        cfg, RunPlan(), steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=global_batch,
        device="cuda", log=lambda *a: None))
    wall = time.perf_counter() - t0
    got = counts()
    losses, auxes = run["losses"], run["auxes"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"{cfg.name} training: losses {losses} not finite or not falling")
    if cfg.moe_num_experts and not all(np.isfinite(a) and a > 0 for a in auxes):
        raise SystemExit(f"{cfg.name} training: aux losses {auxes} not finite and positive")
    if got != dict.fromkeys(COUNTED, 0):
        raise SystemExit(f"{cfg.name} training: launches {got}, expected none")
    steady = float(np.mean(run["step_ms"][1:]))
    tokens = global_batch * TRAIN_SEQ
    flops = model_flops(cfg, tokens, TRAIN_SEQ)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype, "remat": cfg.remat,
           "remat_policy": cfg.remat_policy, "batch": global_batch, "seq": TRAIN_SEQ,
           "lr": cfg.learning_rate, "losses": losses, "auxes": auxes,
           "params_total_active": list((encdec if cfg.is_encoder_decoder else lm)
                                       .count_params_analytic(cfg)),
           "step_ms": run["step_ms"], "ms_per_step": steady, "tokens_per_s": tokens / steady * 1e3,
           "model_flops_per_step": flops, "mfu": flops / (steady * 1e-3) / BF16_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": got,
           "wall_s": wall, "gc_in_train": collected, "card": smi}
    step = steps.build_train_step(cfg, RunPlan())
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, TRAIN_SEQ, global_batch),
                             TRAIN_STEPS, None, "cuda")
    state = run.pop("state")
    out["profile"] = _profile_step(torch, lambda: step(state, batch))
    return out


def timed_leaf(named: dict, kind: str) -> str:
    """The path of the podded gradient leaf the hop's kernels are timed
    on: the largest (``kind`` "largest") or the largest routed-expert
    stack (``"expert"``: ``blocks/pos*/ffn/w*``, (pods, blocks, E, in,
    out))."""
    pool = [p for p, t in named.items() if kind == "largest"
            or (p.startswith("blocks/") and "/ffn/w" in p and t.dim() == 5)]
    return max(pool, key=lambda p: named[p].numel())


def hop_bits_equal(torch, ops, ref, named: dict, halves) -> dict:
    """For each podded gradient leaf of ``named`` (path: (pods, ...)),
    whether both hop kernels match their plain versions bit for bit on its
    rows (``steps.pod_rows``): the int8 lattice and the scales
    ``ops.qsgd_quantize`` gives against ``ref.quantize_ref``'s, and
    ``ops.qsgd_dequantize`` of them against ``ref.dequantize_ref``'s."""
    from repro_torch.fl import steps

    out = {}
    for path, g in named.items():
        rows = steps.pod_rows(g)
        u = halves[: rows.shape[0]]
        q, scale = ops.qsgd_quantize(rows, u)
        rq, rs = ref.quantize_ref(rows, u)
        same = bool(torch.equal(q, rq)) and _bits_equal(torch, scale, rs)
        del rows, rq, rs
        out[path] = same and _bits_equal(torch, ops.qsgd_dequantize(q, scale),
                                         ref.dequantize_ref(q, scale))
    return out


def planted_hop_fault(kind: str, ops):
    """One of HOP_FAULTS in a hop kernel's output, as a ``planted``
    context on ``ops``: the first lattice point of a quantize launch a
    step off, or the first value of a dequantize launch an ulp off."""
    import torch

    def lattice(kernel):
        def quantize(rows, u):
            q, scale = kernel(rows, u)
            q = q.clone()
            q.view(-1)[0] += 1 if int(q.view(-1)[0]) < 127 else -1
            return q, scale
        return quantize

    def ulp(kernel):
        def dequantize(q, scale):
            d = kernel(q, scale).clone()
            d.view(-1)[:1].view(torch.int32)[0] += 1  # the f32's bits: one ulp
            return d
        return dequantize

    if kind == "a lattice point a step off":
        return planted(ops, "qsgd_quantize", lattice)
    if kind == "a dequantized value an ulp off":
        return planted(ops, "qsgd_dequantize", ulp)
    raise ValueError(kind)


def train_podded(torch, qz, ops, ref, cfg, timed: str, global_batch: int = TRAIN_BATCH) -> dict:
    """d: the podded ``totoro_tree_q8`` step, PODS pods, B = ``global_batch``
    and S = TRAIN_SEQ (pod p takes rows p B / PODS ..), POD_STEPS steps
    through ``launch/train.train``: one quantize and one dequantize launch
    per leaf a step; then, on the next batch's gradients
    (``steps.pod_grads``, the step's own), the aggregate within one
    quantization step (max |g| / 127) of the plain pod mean, and both
    kernels bit-equal to their plain versions on the rows of every leaf
    (``hop_bits_equal``), a gate that each of HOP_FAULTS, planted on the
    smallest leaf, must fail; both kernels timed on the rows of
    ``timed_leaf(.., timed)``; one step under torch.profiler."""
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.pytree import key_paths, leaves

    plan = RunPlan(aggregation="totoro_tree_q8")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    set_counts(dict.fromkeys(COUNTED, 0))
    t0 = time.perf_counter()
    run, collected = gc_during(lambda: train.train(
        cfg, plan, steps=POD_STEPS, seq_len=TRAIN_SEQ, global_batch=global_batch, device="cuda",
        num_pods=PODS, log=lambda *a: None))
    wall = time.perf_counter() - t0
    got = counts()
    state = run.pop("state")
    n_leaves = len(leaves(state["params"]))
    want = {**dict.fromkeys(COUNTED, 0), "qsgd_quantize": POD_STEPS * n_leaves,
            "qsgd_dequantize": POD_STEPS * n_leaves}
    if got != want or not all(np.isfinite(run["losses"])):
        raise SystemExit(f"podded training: launches {got} (expected {want}) or losses "
                         f"{run['losses']} not finite")
    peak = torch.cuda.max_memory_allocated() / 1e9
    sc = train.StreamConfig(cfg.vocab_size, TRAIN_SEQ, global_batch)
    batch = train.make_batch(cfg, sc, POD_STEPS, None, "cuda")
    with uncounted():
        grads_pod, _, _ = steps.pod_grads(cfg, plan, state["params"], batch, PODS)
        halves = steps.rounding_halves(grads_pod)
        agg = steps.q8_mean_over_pods(grads_pod, halves)
        worst = 0.0
        for a, g in zip(leaves(agg), leaves(grads_pod)):
            step_size = float(g.abs().max()) / 127
            d = float((a - g.mean(0)).abs().max())
            worst = max(worst, d / step_size)
        del agg
        named = dict(zip(key_paths(grads_pod), leaves(grads_pod)))
        bit_equal = hop_bits_equal(torch, ops, ref, named, halves)
        small = min(named, key=lambda p: named[p].numel())
        caught = {}
        for kind in HOP_FAULTS:
            with planted_hop_fault(kind, ops):
                caught[kind] = not any(hop_bits_equal(torch, ops, ref, {small: named[small]},
                                                      halves).values())
        n_rows = sum(steps.pod_rows_count(g) for g in leaves(grads_pod))
        leaf = timed_leaf(named, timed)
        big = steps.pod_rows(named[leaf])
        R = big.shape[0]
        hb = halves[:R]
        bq, bs = ops.qsgd_quantize(big, hb)
        reps = dict(calls=3, replays=3)
        hop_rows = {
            "qsgd_quantize": _time_row(torch, lambda: ops.qsgd_quantize(big, hb),
                                       lambda: ref.quantize_ref(big, hb), 9 * R * 256 + 4 * R,
                                       7 * R * 256, shape=[R, 256], **reps),
            "qsgd_dequantize": _time_row(torch, lambda: ops.qsgd_dequantize(bq, bs),
                                         lambda: ref.dequantize_ref(bq, bs), 5 * R * 256 + 4 * R,
                                         R * 256, library=lambda: torch.mul(bq, bs),
                                         shape=[R, 256], **reps),
        }
        del grads_pod, named, halves, g, big, hb, bq, bs
    if worst > 1.0 + 1e-6 or not all(bit_equal.values()) or not all(caught.values()):
        raise SystemExit(f"q8 hop: aggregate {worst:.4g} quantization steps from the pod mean, "
                         f"or a kernel differs from its plain version on "
                         f"{[p for p, ok in bit_equal.items() if not ok]}, or the gate passes a "
                         f"planted fault ({caught})")
    pod_step = steps.build_train_step(cfg, plan, num_pods=PODS)
    with uncounted():
        prof = _profile_step(torch, lambda: pod_step(state, batch))
    elems = n_rows * 256
    hop_bytes = {"qsgd_quantize": 9 * elems + 4 * n_rows, "qsgd_dequantize": 5 * elems + 4 * n_rows}
    # without the constant 0.5 uniforms' 4 B an element, which the hop
    # itself does not need (f32 in, int8 and scales out; back again)
    hop_bytes_own = {"qsgd_quantize": 5 * elems + 4 * n_rows, "qsgd_dequantize": 5 * elems + 4 * n_rows}
    return {
        "pods": PODS, "batch": global_batch, "steps": POD_STEPS, "losses": run["losses"],
        "step_ms": run["step_ms"],
        "ms_per_step": float(np.mean(run["step_ms"][1:])), "peak_mem_gb": peak, "wall_s": wall,
        "gc_in_train": collected, "launches": got, "leaves": n_leaves, "agg_vs_mean_in_q_steps": worst,
        "hop_leaves_bit_equal": sum(bit_equal.values()), "hop_rows_per_step": n_rows,
        "hop_faults_caught": caught, "hop_fault_leaf": small,
        "timed_leaf": leaf, "arch": cfg.name, "layers": cfg.num_layers,
        "hop_bytes_per_step": hop_bytes, "hop_bytes_per_step_no_uniforms": hop_bytes_own,
        "hop_bound_ms": sum(hop_bytes.values()) / HBM_BYTES_PER_S * 1e3,
        "hop_bound_ms_no_uniforms": sum(hop_bytes_own.values()) / HBM_BYTES_PER_S * 1e3,
        "hop_kernels_ms": prof["q8_hop_kernels_ms"], "profile": prof, "timed_rows": hop_rows,
    }


def checkpoint_resume(torch, cfg) -> dict:
    """4e e (tinyllama-1.1b at CKPT_LAYERS layers): ``cfg``, bf16: CKPT_STEPS
    steps, ``ckpt.save`` of CKPT_REPLICAS replicas into a temporary
    directory (removed at the end), replica 0 truncated, ``ckpt.restore``
    onto the card: every leaf bit-equal to the saved state, and the next
    step's loss from the restored state equal to the uninterrupted one's."""
    import shutil
    import tempfile

    from repro_torch import ckpt
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.launch import train
    from repro_torch.pytree import leaves

    run = train.train(cfg, RunPlan(), steps=CKPT_STEPS, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, device="cuda", log=lambda *a: None)
    state = run["state"]
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = ckpt.save(state, d, step=CKPT_STEPS, replicas=CKPT_REPLICAS)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(written[0], "arrays.npz"))
        ckpt.corrupt_replica(d, 0, CKPT_STEPS)
        t0 = time.perf_counter()
        restored, at = ckpt.restore(state, d, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same = at == CKPT_STEPS and all(
        a.device.type == "cuda" and a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
        for a, b in zip(leaves(restored), leaves(state)))
    step = steps.build_train_step(cfg, RunPlan())
    batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH),
                             CKPT_STEPS, None, "cuda")
    _, m_cont = step(state, batch)
    del state
    _, m_rest = step(restored, batch)
    cont, rest = float(m_cont["loss"]), float(m_rest["loss"])
    out = {"arch": cfg.name, "layers": cfg.num_layers, "replicas": CKPT_REPLICAS,
           "bytes_per_replica": nbytes,
           "save_s": save_s, "restore_s": restore_s, "restored_bit_equal": same,
           "next_loss_uninterrupted": cont, "next_loss_restored": rest,
           "next_loss_bit_equal": bool(torch.equal(m_cont["loss"], m_rest["loss"])),
           "losses": run["losses"]}
    if not same or cont != rest:
        raise SystemExit(f"checkpoint: restore not bit-equal or next loss differs: {out}")
    return out


def drive_training(torch, smi: str, qz, ops, ref) -> dict:
    """Phase 4e, with bf16 GEMMs accumulating in f32 (restored after)."""
    from repro_torch import configs

    bf16_rr = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        out = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        out["a_f32_card_vs_cpu"] = lm_f32_card_vs_cpu(torch, "tinyllama-1.1b", TRAIN_F32_LAYERS, 2)
        with uncounted():
            out["b_flash_backward"] = flash_backward_on_card(torch)
        tiny = configs.get_config("tinyllama-1.1b")
        out["c_tinyllama"] = train_lm(torch, smi, tiny)
        out["d_podded_q8"] = train_podded(torch, qz, ops, ref, tiny, "largest")
        with uncounted():
            out["e_checkpoint"] = checkpoint_resume(torch, cut_depth(tiny, CKPT_LAYERS))
        torch.cuda.empty_cache()
        return out
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16_rr


# ---------------------------------------------------------------------------
# phase 4f: the MoE family (deepseek-v2-lite-16b)


class RoutingRecorder:
    """Keeps every top-k expert choice the MoE layers make (``moe.top_k``
    wrapped for one run): the (G, T, k) indices of each call, on the host,
    in call order."""

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._orig, self.idx = moe, moe.top_k, []

        def recorded(gates, k):
            w, idx = self._orig(gates, k)
            self.idx.append(idx.detach().cpu())
            return w, idx

        moe.top_k = recorded
        return self

    def __exit__(self, *exc):
        self._moe.top_k = self._orig


def _n_moe(cfg) -> int:
    from repro_torch.models import lm

    return sum(f == "moe" for _, f in lm.layer_pattern(cfg)) * lm.num_blocks(cfg)


def moe_route_share(torch, cfg) -> dict:
    """c: one MoE FFN of ``cfg`` at the training shape (B = TRAIN_BATCH, S =
    TRAIN_SEQ, bf16), forward plus backward, eager (CUDA events, host cost
    included): the whole ``moe.moe_forward``, and ``moe.route`` alone (the
    (G, T, E, C) one-hot dispatch and combine built in k passes) on the
    gates ``moe_forward`` handed it.  route's share of the FFN is a floor
    under the dense dispatch's: its two einsums are not timed apart."""
    from repro_torch.models import moe
    from repro_torch.pytree import tree_map

    p = tree_map(lambda t: t.cuda().requires_grad_(True),
                 moe.init_moe(torch.Generator().manual_seed(6), cfg))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, device="cuda", generator=gen)
    x = x.to(cfg.adtype).requires_grad_(True)
    route, handed = moe.route, []

    def handing(gates, k, capacity):
        handed.append((gates, k, capacity))
        return route(gates, k, capacity)

    moe.route = handing
    try:
        with torch.no_grad():
            moe.moe_forward(p, cfg, x)
    finally:
        moe.route = route
    gates, k, capacity = handed[0]
    gates.requires_grad_(True)

    def whole():
        out, aux = moe.moe_forward(p, cfg, x)
        (out.float().sum() + aux).backward()

    def route_alone():
        _, comb, aux = route(gates, k, capacity)
        (comb.sum() + aux).backward()

    ms = {name: eager_ms(torch, fn, iters=5, warmup=2)
          for name, fn in (("moe_forward", whole), ("route", route_alone))}
    ms["route_share"] = ms["route"] / ms["moe_forward"]
    ms["shape_gtec"] = [*gates.shape, capacity]
    return ms


def routing_flips(idx: list, n_moe: int) -> dict:
    """Token routings (a token's top-k expert set in one MoE layer) of a
    ``decode_vs_forward`` run that differ between the serving path (the
    prefill over the prompt, then each decode step) and the train forward
    over the same positions, and for each row the first of its LM_GEN
    logits entries such a flip reaches (LM_GEN: none).  ``idx``:
    RoutingRecorder's calls, in order:
    the prefill's n_moe, LM_GEN - 1 decode steps' n_moe each, the
    forward's n_moe."""
    B, P = LM_BATCH, LM_PROMPT
    pre, fwd = idx[:n_moe], idx[-n_moe:]
    dec = idx[n_moe:-n_moe]
    if len(dec) != (LM_GEN - 1) * n_moe:
        raise SystemExit(f"MoE serving: {len(idx)} top-k calls, not {(LM_GEN + 1) * n_moe}")
    sets = lambda t: t.reshape(B, -1, t.shape[-1]).sort(-1).values
    flips = {"prefill": 0, "decode": 0}
    # a row's logits from the first one a flip reaches on (a prompt flip
    # reaches the prefill's, entry 0; decode step s's, entry s + 1 and, by
    # the cache, every later one)
    first = [LM_GEN] * B
    for layer in range(n_moe):
        want = sets(fwd[layer])  # (B, P + LM_GEN - 1, k)
        row_pre = (sets(pre[layer]) != want[:, :P]).any(-1)  # (B, P)
        flips["prefill"] += int(row_pre.sum())
        for r in row_pre.any(-1).nonzero().flatten().tolist():
            first[r] = 0
        for step in range(LM_GEN - 1):
            row = (sets(dec[step * n_moe + layer])[:, 0] != want[:, P + step]).any(-1)
            flips["decode"] += int(row.sum())
            for r in row.nonzero().flatten().tolist():
                first[r] = min(first[r], step + 1)
    flips["routings"] = n_moe * B * (P + LM_GEN - 1)
    flips["first_logits_reached_per_row"] = first
    return flips


def planted_moe_fault(kind: str):
    """One of MOE_DECODE_FAULTS in the decode step, as a ``planted``
    context: the shared experts left out of each MoE layer's decode
    output, or the rope half of MLA's absorbed scores left out (the step
    reads a zero rope-key cache)."""
    import torch

    from repro_torch.models import lm, moe

    if kind == "shared experts dropped":
        def make(ffn):
            def no_shared(p, cfg, x):
                if x.shape[1] == 1:  # a decode step's one token
                    p = {k: v for k, v in p.items() if k != "shared"}
                    cfg = cfg.replace(moe_num_shared=0)
                return ffn(p, cfg, x)
            return no_shared
        return planted(moe, "moe_forward", make)
    if kind != "rope scores left out":
        raise ValueError(kind)

    def make(entry):
        mla = entry[1]

        def no_rope(p, cfg, x, *, mode, cache=None, **kw):
            if mode != "decode":
                return mla(p, cfg, x, mode=mode, cache=cache, **kw)
            zero = {"c_kv": cache["c_kv"], "k_rope": torch.zeros_like(cache["k_rope"])}
            return mla(p, cfg, x, mode=mode, cache=zero, **kw)[0], cache
        return (entry[0], no_rope, entry[2])
    return planted(lm._MIXERS, "mla", make)


def moe_decode_gate(torch, idx: list, n_moe: int, diffs, scale: float, bound: float,
                    max_flips: int, min_clean: int) -> dict:
    """One ``decode_vs_forward`` run read under its own routing flips
    (``routing_flips`` of its RoutingRecorder calls ``idx``): it passes when
    at most ``max_flips`` token routings differ, at least ``min_clean`` of
    the B x (LM_GEN - 1) decode entries are reached by no flip, and those
    entries and the prefill's (step 0) are within ``bound`` of the largest
    logit ``scale``."""
    flips = routing_flips(idx, n_moe)
    reach = torch.tensor(flips["first_logits_reached_per_row"])
    clean = torch.arange(LM_GEN)[None, :] < reach[:, None]  # (B, LM_GEN): no flip reaches
    n_flips, n_clean = flips["prefill"] + flips["decode"], int(clean[:, 1:].sum())
    rel = float(diffs[clean].max()) / scale if clean.any() else float("inf")
    return {"flips": n_flips, "max_flips": max_flips, "routing_flips": flips,
            "decode_entries_no_flip_reaches": n_clean, "min_clean": min_clean,
            "rel_no_flip": rel, "rel_all": float(diffs.max()) / scale, "bound": bound,
            "passed": n_flips <= max_flips and n_clean >= min_clean and rel < bound}


def moe_decode_check(torch, cfg, params, batch, bound: float, max_flips: int,
                     min_clean: int) -> dict:
    """Decode against the train forward, both dropless, through
    ``decode_vs_forward``: the sound run and each of MOE_DECODE_FAULTS,
    each read by ``moe_decode_gate`` under the flips it makes itself.  The
    sound run must pass and every fault fail."""
    dropless = cfg.replace(capacity_factor=64.0)
    n_moe = _n_moe(cfg)
    out = {"faults": {}}
    for kind in (None,) + MOE_DECODE_FAULTS:
        with RoutingRecorder() as rec, (planted_moe_fault(kind) if kind else nullcontext()):
            res, diffs, scale = decode_vs_forward(torch, params, dropless, batch)
        gate = moe_decode_gate(torch, rec.idx, n_moe, diffs, scale, bound, max_flips, min_clean)
        if kind:
            out["faults"][kind] = gate
            continue
        out.update(gate, max_abs_logit=scale, tokens_row0=res["tokens"][0].tolist(),
                   rel_per_entry=[[round(float(v) / scale, 5) for v in row] for row in diffs])
    caught = [k for k, g in out["faults"].items() if not g["passed"]]
    if not out["passed"] or len(caught) != len(MOE_DECODE_FAULTS):
        raise SystemExit(f"{cfg.name} ({cfg.dtype}): decode against the dropless train forward "
                         f"fails its gate, or the gate passes a planted fault (caught only "
                         f"{caught}): {out}")
    return out


def moe_decode_f32(torch) -> dict:
    """b, the strict gate: MOE_ARCH at full width, MOE_F32_LAYERS layers,
    f32 (TF32 off), on the card: ``moe_decode_check`` with no flip allowed
    and every entry within MOE_F32_DECODE_REL."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = configs.get_config(MOE_ARCH).replace(num_layers=MOE_F32_LAYERS, dtype="float32",
                                               param_dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(22), cfg, device="cuda")
    batch = serve.make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator().manual_seed(23), "cuda")
    out = moe_decode_check(torch, cfg, params, batch, MOE_F32_DECODE_REL, 0,
                           LM_BATCH * (LM_GEN - 1))
    return dict(out, layers=MOE_F32_LAYERS)


def serve_moe(torch, smi: str) -> dict:
    """b: MOE_ARCH at full width, MOE_SERVE_LAYERS layers, bf16, through
    ``launch/serve``'s functions (batch LM_BATCH, prompt LM_PROMPT, LM_GEN
    generated): ``moe_decode_check`` within LM_BF16_REL, at most
    MOE_BF16_MAX_FLIPS flips and MOE_BF16_MIN_CLEAN clean decode entries.
    Then two runs at the config's capacity, the second timed, its top-k
    choices kept: the decode bound over all 64 experts' weights, and over
    the experts the batch's tokens were routed to."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.pytree import leaves

    cfg = configs.get_config(MOE_ARCH).replace(num_layers=MOE_SERVE_LAYERS)
    n_moe = _n_moe(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator().manual_seed(20), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = serve.make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator().manual_seed(21), "cuda")
    check = moe_decode_check(torch, cfg, params, batch, LM_BF16_REL, MOE_BF16_MAX_FLIPS,
                             MOE_BF16_MIN_CLEAN)
    first = serve.generate(params, cfg, batch, LM_GEN)
    with RoutingRecorder() as timed_rec:
        timed = serve.generate(params, cfg, batch, LM_GEN)
    run = {"params": params, "timed": timed, "first_run": first, "init_s": init_s,
           "weight_bytes": sum(t.numel() * t.element_size() for t in leaves(params))}
    out = serve_times(cfg, run, smi)
    # experts a decode step reads: those its B tokens were routed to, per layer
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff * params["embed"].element_size()
    dec = timed_rec.idx[n_moe:]
    used = [sum(int(dec[s * n_moe + l].unique().numel()) for l in range(n_moe))
            for s in range(LM_GEN - 1)]
    unread = n_moe * cfg.moe_num_experts - float(np.mean(used[1:]))
    out.update(
        decode_vs_forward=check,
        experts_read_per_decode_step=used, moe_layers=n_moe, num_experts=cfg.moe_num_experts,
        bound_ms_routed_experts=(out["decode_read_bytes"] - unread * per_expert)
        / HBM_BYTES_PER_S * 1e3,
        params_total_active=list(lm.count_params_analytic(cfg)))
    with uncounted():
        out["decode_profile"] = profile_decode(torch, cfg, params, batch)
    return out


def drive_moe(torch, smi: str, qz, ops, ref) -> dict:
    """Phase 4f, with bf16 GEMMs accumulating in f32 (restored after); a,
    b, c and d of the module docstring, every launch counter set to 0 just
    before each and read just after."""
    from repro_torch import configs

    bf16_rr = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        out = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        set_counts(dict.fromkeys(COUNTED, 0))
        out["a_f32_card_vs_cpu"] = lm_f32_card_vs_cpu(torch, MOE_ARCH, MOE_F32_LAYERS, 2)
        out["a_launches"] = counts()
        torch.cuda.empty_cache()
        set_counts(dict.fromkeys(COUNTED, 0))
        out["b_decode_f32"] = moe_decode_f32(torch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out["b_serve"] = serve_moe(torch, smi)
        out["b_launches"] = counts()
        out["b_serve"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        cfg = configs.get_config(MOE_ARCH)
        out["c_train"] = train_lm(torch, smi, cfg.replace(num_layers=MOE_TRAIN_LAYERS))
        torch.cuda.empty_cache()
        with uncounted():
            out["c_remat"] = remat_agreement(torch, MOE_ARCH, MOE_REMAT_LAYERS, 4)
            torch.cuda.empty_cache()
            out["c_route"] = moe_route_share(torch, cfg)
        torch.cuda.empty_cache()
        out["d_podded_q8"] = train_podded(torch, qz, ops, ref,
                                          cfg.replace(num_layers=MOE_POD_LAYERS), "expert")
        torch.cuda.empty_cache()
        for tag in ("a_launches", "b_launches"):
            if out[tag] != dict.fromkeys(COUNTED, 0):
                raise SystemExit(f"MoE {tag[0]}: launches {out[tag]}, expected none")
        return out
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16_rr


# ---------------------------------------------------------------------------
# phase 4g: the recurrent families (rwkv6-7b; jamba's Mamba layer)


def recurrent_fault(kind: str):
    """One of the faults that phase 4g plants, as a ``planted`` context:
    one of RWKV_DECODE_FAULTS in the decode step's wkv state update (the
    state it returns in place of ``w S + k v^T``), or one of
    RECURRENT_F32_FAULTS (phase a, on the card's side only)."""
    from repro_torch.models import rwkv, ssm

    state_update = {
        "k and v swapped in the state update":
            lambda k, v, w, s: w[..., None] * s + v[..., :, None] * k[..., None, :],
        "the token's kv left out of the state": lambda k, v, w, s: w[..., None] * s,
        "the decay left out of the state update":
            lambda k, v, w, s: s + k[..., :, None] * v[..., None, :],
    }
    if kind in state_update:
        def make(step):
            def faulty(r, k, v, w, u, state):
                return step(r, k, v, w, u, state)[0], state_update[kind](k, v, w, state)
            return faulty
        return planted(rwkv, "_wkv_step", make)
    if kind == "wkv state not carried across chunks":
        return planted(rwkv, "_wkv_chunk",
                       lambda chunk: lambda r, k, v, lw, u, state: chunk(r, k, v, lw, u,
                                                                         state * 0.0))
    if kind == "scan state not carried across chunks":
        return planted(ssm, "_scan_chunk",
                       lambda body: lambda dt, A, Bm, Cm, x, D, h: body(dt, A, Bm, Cm, x, D,
                                                                        h * 0.0))
    if kind == "ssm state not carried in decode":
        return planted(ssm, "_ssm_step", lambda step: lambda a, bu, h: step(a, bu, h * 0.0))
    raise ValueError(kind)


def mamba_layer_f32_card_vs_cpu(torch) -> dict:
    """a: jamba's ("mamba", "dense") layer alone at full width, f32 weights
    and activations (TF32 off), B = TRAIN_F32_BATCH, S = TRAIN_F32_SEQ (two
    scan chunks of 64): ``lm.apply_layer`` in train mode, its output within
    LM_F32_REL of the largest, the gradients of a fixed random projection
    of it (every parameter and the input) within TRAIN_GRAD_REL of each
    one's largest; the card run with the scan state not carried from chunk
    to chunk must fail that gate."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.pytree import leaves, tree_map, unflatten_like

    cfg = configs.get_config(JAMBA_ARCH).replace(dtype="float32")
    assert cfg.param_dtype == "float32"
    params = lm.init_layer(torch.Generator().manual_seed(31), cfg, "mamba", "dense")
    gen = torch.Generator().manual_seed(32)
    x = torch.randn(TRAIN_F32_BATCH, TRAIN_F32_SEQ, cfg.d_model, generator=gen)
    w = torch.randn(TRAIN_F32_BATCH, TRAIN_F32_SEQ, cfg.d_model, generator=gen)

    def fn(inp):
        p = tree_map(lambda t: t.detach().requires_grad_(True), inp["params"])
        xin = inp["x"].detach().requires_grad_(True)
        out = lm.apply_layer(p, cfg, xin, "mamba", "dense", positions=None, mode="train")[0]
        g = torch.autograd.grad((out * inp["w"]).sum(), [xin] + leaves(p))
        return {"out": out, "grads": {"x": g[0], "params": unflatten_like(p, list(g[1:]))}}

    fault = RECURRENT_F32_FAULTS[1]
    runs = _card_vs_cpu_run(torch, fn, {"params": params, "x": x, "w": w}, fault)
    cpu = runs["cpu"]

    def read(run):
        rels = _leaf_rels(torch, run["grads"], cpu["grads"])
        return {"out_rel": _rel(torch, run["out"], cpu["out"]), "grad_rel_max": max(rels.values()),
                "grad_rel": rels}

    bounds = {"out_rel": LM_F32_REL, "grad_rel_max": TRAIN_GRAD_REL}
    out = dict(read(runs["card"]), d_model=cfg.d_model, d_inner=cfg.expand * cfg.d_model,
               params=sum(t.numel() for t in leaves(params)))
    bad = read(runs["fault"])
    out["planted_fault"] = {"kind": fault, **{k: bad[k] for k in bounds}}
    if not _gate(out, bounds) or _gate(bad, bounds):
        raise SystemExit(f"{JAMBA_ARCH} Mamba layer f32 card vs CPU: the gate fails, or passes "
                         f"the planted fault: {out}")
    return out


def jamba_reduced_card_vs_cpu(torch) -> dict:
    """a: jamba's reduced config (16 layers: two pattern blocks of attention,
    Mamba and MoE) end to end in f32 (TF32 off), through ``launch/serve``'s
    functions: B LM_BATCH, prompt LM_PROMPT, LM_GEN generated.  The prefill's
    and every decode step's logits within LM_F32_REL of the CPU's largest,
    the prefill's cache (k, v, conv history, SSM state) within LM_F32_REL of
    each leaf's largest, the tokens identical; the card run with the SSM
    state not carried from decode step to decode step must fail that gate."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.pytree import leaves

    cfg = configs.get_reduced(JAMBA_ARCH)
    params = lm.init_params(torch.Generator().manual_seed(33), cfg)
    batch = serve.make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator().manual_seed(34), "cpu")

    def fn(inp):
        with LogitsRecorder() as rec, torch.no_grad():
            res = serve.generate(inp["params"], cfg, inp["batch"], LM_GEN)
        with torch.no_grad():
            _, pcache, _ = lm.forward(inp["params"], cfg, mode="prefill", **inp["batch"])
        return {"logits": torch.stack(rec.logits, 1), "tokens": res["tokens"],
                "cache": pcache}

    fault = RECURRENT_F32_FAULTS[2]
    runs = _card_vs_cpu_run(torch, fn, {"params": params, "batch": batch}, fault)
    cpu = runs["cpu"]

    def read(run):
        return {"logits_rel": _rel(torch, run["logits"], cpu["logits"]),
                "cache_rel_max": max(_leaf_rels(torch, run["cache"], cpu["cache"]).values()),
                "tokens_differ": int((run["tokens"] != cpu["tokens"]).sum())}

    bounds = {"logits_rel": LM_F32_REL, "cache_rel_max": LM_F32_REL, "tokens_differ": 0}
    out = dict(read(runs["card"]), layers=cfg.num_layers, d_model=cfg.d_model,
               cache_leaves=len(leaves(cpu["cache"])))
    bad = read(runs["fault"])
    out["planted_fault"] = {"kind": fault, **bad}
    if not _gate(out, bounds) or _gate(bad, bounds):
        raise SystemExit(f"{JAMBA_ARCH} reduced, card vs CPU: the gate fails, or passes the "
                         f"planted fault: {out}")
    return out


def length_spread(torch, params, cfg, batch, tokens) -> float:
    """The train forward's own spread: its logits over the LM_PROMPT +
    LM_GEN - 1 positions a ``decode_vs_forward`` run reads (``tokens``, the
    run's generated tokens) against its logits over the prompt alone, on
    the prompt's positions, as a share of the former's largest logit over
    the positions decode is compared on.  Two forwards of one model, same
    weights and tokens, differing only in sequence length (so in chunk
    length and GEMM shapes): how far the model carries arithmetic
    differences of the size the serving path makes."""
    from repro_torch.models import lm

    with torch.no_grad():
        seq = torch.cat([batch["tokens"], tokens[:, :-1]], dim=1)
        full = lm.forward(params, cfg, tokens=seq, mode="train")[0].float()
        short = lm.forward(params, cfg, tokens=batch["tokens"], mode="train")[0].float()
    scale = float(full[:, LM_PROMPT - 1:].abs().max())
    return float((full[:, :LM_PROMPT] - short).abs().max()) / scale


def randomised_rwkv_leaves(torch, params, seed: int) -> None:
    """Every RWKV leaf of ``params`` that is a constant at init redrawn in
    place from ``seed``, as tests/test_torch_rwkv.py does: ``mix_*``
    uniform in [0, 1]; ``decay_0`` uniform in [-6, -1], the range the
    upstream RWKV-6 init spreads a layer's channels over (a decay of 0.9975
    to 0.69 a token); ``bonus_u`` and ``ln_bias`` 0.5 N(0, 1);
    ``ln_scale`` 1 + 0.3 N(0, 1)."""
    from repro_torch.pytree import key_paths, leaves

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for path, t in zip(key_paths(params), leaves(params)):
            name = path.rsplit("/", 1)[-1]
            if name.startswith("mix_"):
                t.copy_(torch.rand(t.shape, generator=gen))
            elif name == "decay_0":
                t.copy_(-6.0 + 5.0 * torch.rand(t.shape, generator=gen))
            elif name in ("bonus_u", "ln_bias"):
                t.copy_(0.5 * torch.randn(t.shape, generator=gen))
            elif name == "ln_scale":
                t.copy_(1.0 + 0.3 * torch.randn(t.shape, generator=gen))


def rwkv_decode_readings(torch, cfg, params, batch) -> dict:
    """Decode against the train forward (``decode_vs_forward``) as a share
    of the largest logit: the sound run, each of RWKV_DECODE_FAULTS planted
    in the decode step's wkv state update, and beside them the forward's
    own ``length_spread``."""
    res, diffs, scale = decode_vs_forward(torch, params, cfg, batch)
    out = {"dtype": cfg.dtype, "rel": float(diffs.max()) / scale, "max_abs_logit": scale,
           "rel_per_step": [round(float(v) / scale, 7) for v in diffs.amax(0)],
           "length_spread": length_spread(torch, params, cfg, batch, res["tokens"]),
           "tokens_row0": res["tokens"][0].tolist(), "faults": {}}
    for kind in RWKV_DECODE_FAULTS:
        with recurrent_fault(kind):
            _, fd, fs = decode_vs_forward(torch, params, cfg, batch)
        out["faults"][kind] = float(fd.max()) / fs
    return out


def serve_rwkv(torch, smi: str) -> dict:
    """b: RWKV_ARCH at full width and RWKV_SERVE_LAYERS layers through
    ``launch/serve``'s functions, weights from one seeded ``lm.init_params``
    (``drawn_on_card``, its init time recorded) with the constant-at-init
    leaves redrawn
    (``randomised_rwkv_leaves``).  ``rwkv_decode_readings`` in f32 (TF32
    off), then on the same weights in the config's bf16 layout
    (``decay_0`` and ``bonus_u`` stay f32); prefill ms, decode ms/token
    beside the weight-read bound, a decode step's idle share and device
    ops.  Then the gate, in f32: the sound run within RWKV_F32_DECODE_REL,
    every planted fault above it (bf16's readings are recorded)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.pytree import leaves, tree_map

    cfg = configs.get_config(RWKV_ARCH).replace(num_layers=RWKV_SERVE_LAYERS)
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    with drawn_on_card():
        params = lm.init_params(torch.Generator().manual_seed(35), cfg32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    randomised_rwkv_leaves(torch, params, RWKV_LEAF_SEED)
    batch = serve.make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator().manual_seed(36), "cuda")
    readings = {"float32": rwkv_decode_readings(torch, cfg32, params, batch)}
    with torch.device("meta"):
        layout = lm.init_params(torch.Generator(), cfg, device="meta")
    params = tree_map(lambda t, m: t.to(m.dtype), params, layout)  # bf16 but decay_0, bonus_u
    torch.cuda.empty_cache()
    readings["bfloat16"] = rwkv_decode_readings(torch, cfg, params, batch)
    first = serve.generate(params, cfg, batch, LM_GEN)
    timed = serve.generate(params, cfg, batch, LM_GEN)  # warm: the times reported
    run = {"params": params, "timed": timed, "first_run": first, "init_s": init_s,
           "weight_bytes": sum(t.numel() * t.element_size() for t in leaves(params))}
    out = serve_times(cfg, run, smi)
    out.update(decode_vs_forward_f32=readings["float32"], decode_vs_forward_bf16=readings["bfloat16"],
               params_total=lm.count_params_analytic(cfg)[0], leaf_seed=RWKV_LEAF_SEED)
    with uncounted():
        out["decode_profile"] = profile_decode(torch, cfg, params, batch)
    f32 = readings["float32"]
    f32["bound"] = RWKV_F32_DECODE_REL
    if not (f32["rel"] <= f32["bound"] and all(f > f32["bound"] for f in f32["faults"].values())):
        raise SystemExit(f"{RWKV_ARCH}: f32 decode against the train forward fails its bound, or "
                         f"the bound passes a planted fault: {json.dumps(readings)}")
    return out


def mamba_chunk_loop_share(torch) -> dict:
    """e: jamba's Mamba sublayer (``ssm.mamba_forward``) at full width in
    its own dtypes (f32 weights, bf16 activations), B = MAMBA_BATCH, S =
    TRAIN_SEQ, forward plus backward, eager (CUDA events, host cost
    included): the whole sublayer, and ``ssm.selective_scan`` alone (the
    chunk loop: per chunk the log-depth scan, under its checkpoint) on the
    inputs the sublayer handed it; the loop's share and the peak memory.
    A lead for later work, not a gate."""
    from repro_torch import configs
    from repro_torch.models import ssm
    from repro_torch.pytree import tree_map

    cfg = configs.get_config(JAMBA_ARCH)
    p = tree_map(lambda t: t.cuda().requires_grad_(True),
                 ssm.init_mamba(torch.Generator().manual_seed(37), cfg))
    gen = torch.Generator(device="cuda").manual_seed(38)
    x = torch.randn(MAMBA_BATCH, TRAIN_SEQ, cfg.d_model, device="cuda", generator=gen)
    x = x.to(cfg.adtype).requires_grad_(True)
    scan, handed = ssm.selective_scan, []

    def handing(*args):
        handed.append(args)
        return scan(*args)

    ssm.selective_scan = handing
    try:
        with torch.no_grad():
            ssm.mamba_forward(p, cfg, x, mode="train")
    finally:
        ssm.selective_scan = scan
    args = [a.detach().requires_grad_(a.is_floating_point()) if isinstance(a, torch.Tensor) else a
            for a in handed[0]]

    def whole():
        out, _ = ssm.mamba_forward(p, cfg, x, mode="train")
        out.float().sum().backward()

    def loop_alone():
        y, h = scan(*args)
        (y.sum() + h.sum()).backward()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = {name: eager_ms(torch, fn, iters=3, warmup=1)
          for name, fn in (("mamba_forward", whole), ("selective_scan", loop_alone))}
    ms.update(chunk_loop_share=ms["selective_scan"] / ms["mamba_forward"],
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, batch=MAMBA_BATCH,
              seq=TRAIN_SEQ, chunk=args[-1], d_inner=cfg.expand * cfg.d_model,
              d_state=cfg.d_state, dtype=cfg.dtype, param_dtype=cfg.param_dtype)
    return ms


def drive_recurrent(torch, smi: str, qz, ops, ref) -> dict:
    """Phase 4g, with bf16 GEMMs accumulating in f32 (restored after); a to
    e of the module docstring, every launch counter set to 0 just before
    each and read just after."""
    from repro_torch import configs

    bf16_rr = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        out = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        set_counts(dict.fromkeys(COUNTED, 0))
        out["a_rwkv_f32"] = lm_f32_card_vs_cpu(torch, RWKV_ARCH, RWKV_F32_LAYERS, 30,
                                               RECURRENT_F32_FAULTS[0])
        out["a_mamba_layer_f32"] = mamba_layer_f32_card_vs_cpu(torch)
        out["a_jamba_reduced"] = jamba_reduced_card_vs_cpu(torch)
        out["a_launches"] = counts()
        torch.cuda.empty_cache()
        set_counts(dict.fromkeys(COUNTED, 0))
        torch.cuda.reset_peak_memory_stats()
        out["b_serve"] = serve_rwkv(torch, smi)
        out["b_launches"] = counts()
        out["b_serve"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        cfg = configs.get_config(RWKV_ARCH)
        out["c_train"] = train_lm(torch, smi, cfg.replace(num_layers=RWKV_TRAIN_LAYERS))
        torch.cuda.empty_cache()
        with uncounted():
            out["c_remat"] = remat_agreement(torch, RWKV_ARCH, RWKV_REMAT_LAYERS, 36)
        torch.cuda.empty_cache()
        out["d_podded_q8"] = train_podded(torch, qz, ops, ref,
                                          cfg.replace(num_layers=RWKV_POD_LAYERS), "largest")
        torch.cuda.empty_cache()
        set_counts(dict.fromkeys(COUNTED, 0))
        out["e_mamba"] = mamba_chunk_loop_share(torch)
        out["e_launches"] = counts()
        torch.cuda.empty_cache()
        for tag in ("a_launches", "b_launches", "e_launches"):
            if out[tag] != dict.fromkeys(COUNTED, 0):
                raise SystemExit(f"recurrent {tag[0]}: launches {out[tag]}, expected none")
        return out
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16_rr


# ---------------------------------------------------------------------------
# phase 4h: the encoder-decoder family (seamless-m4t-medium)


def redrawn_norms(torch, params, seed: int) -> None:
    """Every norm leaf of an encoder-decoder's ``params`` (ENCDEC_NORMS,
    zeros at init) redrawn in place as 0.3 N(0, 1) from ``seed``."""
    from repro_torch.pytree import key_paths, leaves

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for path, t in zip(key_paths(params), leaves(params)):
            if path.rsplit("/", 1)[-1] in ENCDEC_NORMS:
                t.copy_(0.3 * torch.randn(t.shape, generator=gen))


def encdec_fault(kind: str):
    """One of ENCDEC_F32_FAULTS or ENCDEC_DECODE_FAULTS planted in the port
    at run time, as a ``planted`` context."""
    from repro_torch.launch import serve
    from repro_torch.models import attention, encdec

    if kind == "cross keys from the decoder's states":
        def make(fwd):
            def cross(p, cfg, x, *, enc_kv=None, enc_out=None):
                return fwd(p, cfg, x, enc_kv=enc_kv, enc_out=None if enc_out is None else x)
            return cross
        return planted(attention, "cross_attn_forward", make)
    if kind == "causal encoder":  # the decoder's self-attention is causal already
        return planted(attention, "gqa_forward",
                       lambda fwd: lambda *a, **kw: fwd(*a, **{**kw, "causal": True}))
    if kind == "norm_x and norm2 swapped":
        return planted(encdec, "_dec_layer", lambda layer: lambda lp, *a, **kw: layer(
            {**lp, "norm_x": lp["norm2"], "norm2": lp["norm_x"]}, *a, **kw))
    if kind == "pad mask skipped":
        return planted(encdec, "_mask_pad_vocab", lambda mask: lambda cfg, logits: logits)
    if kind == "cross cache left zero after prefill":
        def zeroed(start):
            def after_prefill(*a):
                cache, tok = start(*a)
                for t in cache["cross"].values():
                    t.zero_()
                return cache, tok
            return after_prefill
        return planted(serve, "start", zeroed)
    if kind not in ENCDEC_DECODE_FAULTS:
        raise ValueError(kind)

    def faulty(stack):
        def decode_stack(params, cfg, tgt, *, mode, cache=None, cache_index=None, **kw):
            if mode != "decode":
                return stack(params, cfg, tgt, mode=mode, cache=cache, cache_index=cache_index,
                             **kw)
            if kind == "self-cache index off by one":
                return stack(params, cfg, tgt, mode=mode, cache=cache,
                             cache_index=int(cache_index) - 1, **kw)
            wrong = {"self": cache["self"],  # layer i reads layer i - 1's cross k and v
                     "cross": {k: t.roll(1, 0) for k, t in cache["cross"].items()}}
            x, _ = stack(params, cfg, tgt, mode=mode, cache=wrong, cache_index=cache_index, **kw)
            return x, cache
        return decode_stack
    return planted(encdec, "decode_stack", faulty)


def encdec_f32_card_vs_cpu(torch) -> dict:
    """a: SEAMLESS_ARCH at full width and SEAMLESS_F32_LAYERS encoder and
    decoder layers in f32 (remat on, TF32 off), norms redrawn, the same
    weights and batch on the card and on the CPU: ``encdec.forward``'s
    logits (the padded columns, -1e9, included) within LM_F32_REL of the
    largest over the real vocabulary, the loss within TRAIN_LOSS_RTOL, every gradient leaf
    (``grads_and_metrics``) within TRAIN_GRAD_REL of its largest; then the
    card again under each of ENCDEC_F32_FAULTS, each of which must fail."""
    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.fl import steps
    from repro_torch.models import encdec
    from repro_torch.pytree import tree_map

    cfg = cut_depth(configs.get_config(SEAMLESS_ARCH), SEAMLESS_F32_LAYERS).replace(
        dtype="float32", param_dtype="float32")
    params = encdec.init_params(torch.Generator().manual_seed(40), cfg)
    redrawn_norms(torch, params, SEAMLESS_NORM_SEED)
    gen, B = torch.Generator().manual_seed(42), TRAIN_F32_BATCH
    batch = {"embeds": torch.randn((B, SEAMLESS_SRC, cfg.d_model), generator=gen) * 0.3,
             "tokens": torch.randint(0, cfg.vocab_size, (B, SEAMLESS_TGT), generator=gen,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (B, SEAMLESS_TGT), generator=gen,
                                     dtype=torch.int32)}

    def run(dev, fault=None):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        with encdec_fault(fault) if fault else nullcontext():
            with torch.no_grad():
                logits = encdec.forward(p, cfg, b)
            g, m = steps.grads_and_metrics(cfg, RunPlan(), p, b)
        out = {"logits": logits.cpu(), "loss": float(m["loss"]),
               "grads": tree_map(lambda t: t.cpu(), g)}
        del p, g, logits
        torch.cuda.empty_cache()
        return out

    cpu = run("cpu")

    scale = float(cpu["logits"][..., :cfg.vocab_size].abs().max())  # the padded columns read -1e9

    def read(r):
        grads = _leaf_rels(torch, r["grads"], cpu["grads"])
        return {"logits_rel": float((r["logits"] - cpu["logits"]).abs().max()) / scale,
                "loss_rel": abs(r["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                "grad_rel_max": max(grads.values()), "grad_rel": grads}

    bounds = {"logits_rel": LM_F32_REL, "loss_rel": TRAIN_LOSS_RTOL, "grad_rel_max": TRAIN_GRAD_REL}
    card = run("cuda")
    out = dict(read(card), arch=SEAMLESS_ARCH, layers=cfg.num_layers, enc_layers=cfg.enc_layers,
               src=SEAMLESS_SRC, tgt=SEAMLESS_TGT, loss_cpu=cpu["loss"], loss_card=card["loss"],
               pad_columns_masked=bool((card["logits"][..., cfg.vocab_size:] == -1e9).all()),
               planted_faults={})
    del card
    for kind in ENCDEC_F32_FAULTS:
        bad = read(run("cuda", kind))
        out["planted_faults"][kind] = {k: bad[k] for k in bounds}
    passed = _gate(out, bounds) and out["pad_columns_masked"]
    caught = [k for k, r in out["planted_faults"].items() if not _gate(r, bounds)]
    if not passed or len(caught) != len(ENCDEC_F32_FAULTS):
        raise SystemExit(f"{SEAMLESS_ARCH} f32 card vs CPU: the gate fails, or passes a planted "
                         f"fault: {out}")
    return out


def serve_encdec(torch, smi: str) -> dict:
    """b: SEAMLESS_ARCH at full width and depth through ``launch/serve``'s
    functions, weights from one seeded ``encdec.init_params`` (its init time
    recorded), LM_BATCH rows of LM_PROMPT source frames and prompt tokens.
    Decode against the train forward (``decode_vs_forward``, as a share of
    the largest logit) in f32 (TF32 off) within SEAMLESS_F32_DECODE_REL,
    then on the same weights in bf16 within LM_BF16_REL, each of
    ENCDEC_DECODE_FAULTS above the bound in both dtypes; prefill ms, decode ms/token beside the
    weight-read bound, a decode step's idle share and device ops."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.pytree import leaves, tree_map

    cfg = configs.get_config(SEAMLESS_ARCH)
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    params = encdec.init_params(torch.Generator().manual_seed(43), cfg32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = serve.make_batch(cfg, LM_BATCH, LM_PROMPT, torch.Generator().manual_seed(44), "cuda")
    def readings(cfg, bound):
        res, d, scale = decode_vs_forward(torch, params, cfg, batch)
        out = {"rel": float(d.max()) / scale, "bound": bound, "max_abs_logit": scale,
               "rel_per_step": [round(float(v) / scale, 7) for v in d.amax(0)],
               "tokens_row0": res["tokens"][0].tolist(), "faults": {}}
        for kind in ENCDEC_DECODE_FAULTS:
            with encdec_fault(kind):
                _, fd, fs = decode_vs_forward(torch, params, cfg, batch)
            out["faults"][kind] = float(fd.max()) / fs
        return out

    f32 = readings(cfg32, SEAMLESS_F32_DECODE_REL)
    params = tree_map(lambda t: t.to(cfg.pdtype), params)
    torch.cuda.empty_cache()
    bf16 = readings(cfg, LM_BF16_REL)
    first = serve.generate(params, cfg, batch, LM_GEN)
    timed = serve.generate(params, cfg, batch, LM_GEN)  # warm: the times reported
    run = {"params": params, "timed": timed, "first_run": first, "init_s": init_s,
           "weight_bytes": sum(t.numel() * t.element_size() for t in leaves(params))}
    out = serve_times(cfg, run, smi)
    out.update(enc_layers=cfg.enc_layers, decode_vs_forward_f32=f32, decode_vs_forward_bf16=bf16,
               params_total=encdec.count_params_analytic(cfg)[0])
    with uncounted():
        out["decode_profile"] = profile_decode(torch, cfg, params, batch)
    if not all(r["rel"] <= r["bound"] and all(f > r["bound"] for f in r["faults"].values())
               for r in (f32, bf16)):
        raise SystemExit(f"{SEAMLESS_ARCH}: decode against the train forward fails its bounds, or "
                         f"LM_BF16_REL passes a planted fault: f32 {json.dumps(f32)}, bf16 "
                         f"{json.dumps(bf16)}")
    return out


def drive_encdec(torch, smi: str, qz, ops, ref) -> dict:
    """Phase 4h, with bf16 GEMMs accumulating in f32 (restored after); a to
    d of the module docstring, every launch counter set to 0 just before
    each and read just after."""
    from repro_torch import configs

    bf16_rr = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        out = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        set_counts(dict.fromkeys(COUNTED, 0))
        out["a_f32"] = encdec_f32_card_vs_cpu(torch)
        out["a_launches"] = counts()
        torch.cuda.empty_cache()
        set_counts(dict.fromkeys(COUNTED, 0))
        torch.cuda.reset_peak_memory_stats()
        out["b_serve"] = serve_encdec(torch, smi)
        out["b_launches"] = counts()
        out["b_serve"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        cfg = configs.get_config(SEAMLESS_ARCH)
        out["c_train"] = train_lm(torch, smi, cfg, SEAMLESS_BATCH)
        torch.cuda.empty_cache()
        with uncounted():
            out["c_remat"] = remat_agreement(torch, SEAMLESS_ARCH, SEAMLESS_REMAT_LAYERS, 45,
                                             SEAMLESS_BATCH)
        torch.cuda.empty_cache()
        out["d_podded_q8"] = train_podded(torch, qz, ops, ref, cut_depth(cfg, SEAMLESS_POD_LAYERS),
                                          "largest", SEAMLESS_BATCH)
        torch.cuda.empty_cache()
        for tag in ("a_launches", "b_launches"):
            if out[tag] != dict.fromkeys(COUNTED, 0):
                raise SystemExit(f"encdec {tag[0]}: launches {out[tag]}, expected none")
        return out
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16_rr


def log_encdec(enc: dict, smi: str) -> None:
    """Phase 4h's lines."""
    a = enc["a_f32"]
    log(f"[4h encdec a] {SEAMLESS_ARCH} full width, {a['enc_layers']} + {a['layers']} layers, f32, "
        f"B={TRAIN_F32_BATCH} S_src={a['src']} S_tgt={a['tgt']}, remat on, TF32 {enc['allow_tf32']}: "
        f"logits within {a['logits_rel']:.3g} of the largest (bound {LM_F32_REL}; padded columns "
        f"-1e9: {a['pad_columns_masked']}); loss card {a['loss_card']:.7f} CPU {a['loss_cpu']:.7f}, "
        f"rel {a['loss_rel']:.3g} (rtol {TRAIN_LOSS_RTOL}); gradients within "
        f"{a['grad_rel_max']:.3g} of each leaf's largest (bound {TRAIN_GRAD_REL}); planted faults "
        f"{json.dumps(a['planted_faults'])}; card: {smi}")
    log(f"[4h encdec a] {json.dumps(a)}")
    b = enc["b_serve"]
    log(f"[4h encdec b] {SEAMLESS_ARCH} {b['enc_layers']} + {b['layers']} layers {b['dtype']} "
        f"({b['params_total']:,} parameters, {b['weight_bytes'] / 1e9:.3f} GB) B={LM_BATCH} "
        f"source {LM_PROMPT} frames, prompt {LM_PROMPT} + {LM_GEN} generated: prefill "
        f"{b['prefill_ms']:.3f} ms (first call {b['first_run_prefill_ms']:.3f}), decode "
        f"{b['decode_ms_per_token']:.3f} ms/token (mean of decodes 2-{LM_GEN - 1}, host clock "
        f"after synchronize); bound {b['bound_ms_decode_step']:.4f} ms for the "
        f"{b['decode_read_bytes'] / 1e9:.3f} GB a decode step reads (the decoder, the head, the "
        f"self and cross caches) at {HBM_BYTES_PER_S / 1e12} TB/s; decode vs train forward, f32 "
        f"{json.dumps(b['decode_vs_forward_f32'])}, bf16 {json.dumps(b['decode_vs_forward_bf16'])}; "
        f"idle {b['decode_profile']['device_idle_share']:.3f}, "
        f"{b['decode_profile']['device_ops_per_step']:.0f} device ops a step; peak "
        f"{b['peak_mem_gb']:.2f} GB; init {b['init_s']:.1f} s; card: {smi}")
    log(f"[4h encdec b] {json.dumps({k: v for k, v in b.items() if k != 'card'})}")
    c = enc["c_train"]
    log(f"[4h encdec c] {SEAMLESS_ARCH} {c['layers']} + {c['layers']} layers {c['dtype']} AdamW lr "
        f"{c['lr']} remat {c['remat']}, B={c['batch']} S_src=S_tgt={c['seq']}: losses "
        f"{[round(x, 4) for x in c['losses']]}; {c['ms_per_step']:.1f} ms/step (steps 2-"
        f"{TRAIN_STEPS}), {c['tokens_per_s']:.0f} target tokens/s, MFU {c['mfu']:.4f} "
        f"({c['model_flops_per_step']:.4g} model FLOPs a step over {BF16_FLOPS / 1e12:.0f} TFLOP/s "
        f"bf16); peak memory {c['peak_mem_gb']:.2f} GB; idle "
        f"{c['profile']['device_idle_share']:.3f}; card: {smi}")
    log(f"[4h encdec c] one step under torch.profiler: {json.dumps(c['profile'])}")
    log(f"[4h encdec c] {json.dumps({k: v for k, v in c.items() if k not in ('profile', 'card')})}")
    log(f"[4h encdec c] remat on vs off, {SEAMLESS_REMAT_LAYERS} + {SEAMLESS_REMAT_LAYERS} layers: "
        f"{json.dumps(enc['c_remat'])}")
    d = enc["d_podded_q8"]
    log(f"[4h encdec d] podded totoro_tree_q8, {SEAMLESS_ARCH} {d['layers']} + {d['layers']} "
        f"layers, B={d['batch']}, {d['pods']} pods, {d['steps']} steps: losses "
        f"{[round(x, 4) for x in d['losses']]}; {d['ms_per_step']:.1f} ms/step (steps 2-"
        f"{d['steps']}); launches {json.dumps(d['launches'])} ({d['leaves']} leaves a step); "
        f"aggregate within {d['agg_vs_mean_in_q_steps']:.4f} quantization steps of the pod mean; "
        f"kernels bit-equal to ref.quantize_ref / dequantize_ref on {d['hop_leaves_bit_equal']} of "
        f"{d['leaves']} leaves ({d['hop_rows_per_step']:,} rows), the gate failing on each planted "
        f"fault ({d['hop_fault_leaf']}: {json.dumps(d['hop_faults_caught'])}); "
        f"hop kernels {json.dumps(d['hop_kernels_ms'])} ms a step against a byte bound of "
        f"{d['hop_bound_ms']:.3f} ms ({d['hop_bound_ms_no_uniforms']:.3f} without the uniforms); "
        f"peak memory {d['peak_mem_gb']:.2f} GB; card: {smi}")
    log(f"[4h encdec d] {json.dumps({k: v for k, v in d.items() if k != 'profile'})}")
    log(f"[4h encdec d] one step under torch.profiler: {json.dumps(d['profile'])}")


# ---------------------------------------------------------------------------
# phase 4i: the podded step with one pod per rank (tinyllama-1.1b)


def bit_digest(torch, t, chunk: int = 1 << 24) -> list:
    """A position-weighted digest of ``t``'s bits, on its device: the sum of
    its elements' bit patterns and the sum of each times its index plus
    one, both wrapping in int64 (a changed element or two swapped ones
    change it)."""
    flat = t.detach().reshape(-1)
    if flat.is_floating_point():
        flat = flat.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[flat.element_size()])
    s0 = torch.zeros((), dtype=torch.int64, device=flat.device)
    s1 = torch.zeros((), dtype=torch.int64, device=flat.device)
    for lo in range(0, flat.numel(), chunk):
        b = flat[lo:lo + chunk].long()
        s0 += b.sum()
        s1 += (b * torch.arange(lo + 1, lo + 1 + b.numel(), device=b.device)).sum()
    return [int(s0), int(s1)]


class PodRankGates:
    """Inside one rank of phase 4i, as ``planted`` wrappers on the port.

    Gate 1, after every leaf's hop (``hierarchy.dequantize_mean``), that
    the hop equals ``steps.q8_mean_over_pods`` of the ranks' gradients
    stacked: every leaf by digest, and the largest leaf whole.  By digest:
    this rank's rows quantized by the plain version (``ref.quantize_ref``,
    at the reference's rounding of 0.5) equal its part of the gathered
    lattice and scales bit for bit, so the quantize kernel is held against
    it at the shapes this path gives it; every other part has the
    ``bit_digest`` its own rank computed so (gathered through the unplanted
    ``all_gather_pods``), and the hop's output equals the plain
    dequantize (``ref.dequantize_ref``) and pod mean of the gathered rows.
    Whole: the largest leaf's gradients (``largest``: its index in leaf
    order, the first of the largest) of every rank gathered, stacked
    in rank order, the lattice and scales bit-equal to ``ops.
    qsgd_quantize`` of ``steps.pod_rows`` of the stack, and the output to
    ``steps.q8_mean_over_pods`` of it.
    Gate 2, after every step (the step ``steps.build_train_step`` builds):
    every state leaf's ``bit_digest`` equal on all ranks, and the largest
    leaf (in bytes) gathered and compared whole.

    The time both take, on the host clock between synchronizes, is kept
    per step so that the step times can leave it out; their launches are
    not counted (``uncounted``), and the memory they take is kept out of
    ``path_peak`` (the path's own peak: the allocator's peak read before
    each check and reset after it) but in ``peak``."""

    def __init__(self, torch, group, largest: int):
        from repro_torch.fl import hierarchy

        self.torch, self.group, self.largest = torch, group, largest
        self.gather = hierarchy.all_gather_pods  # unplanted, for the references
        self.leaf = None
        self.hop: list = []  # the current hop's per-leaf records
        self.steps: list = []  # per step: {"gate1": [...], "gate2": {...}, "check_ms": ...}
        self.check_s = 0.0
        self.path_peak = self.peak = 0

    @contextmanager
    def installed(self):
        from repro_torch.fl import hierarchy, steps

        with planted(hierarchy, "quantize_leaf", self._seen), \
                planted(hierarchy, "dequantize_mean", self._checked), \
                planted(steps, "build_train_step", self._stepped):
            yield self

    def _timed(self, fn):
        torch = self.torch
        torch.cuda.synchronize()
        self.path_peak = max(self.path_peak, torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        with uncounted():
            out = fn()
        torch.cuda.synchronize()
        self.check_s += time.perf_counter() - t0
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out

    def peaks_gb(self) -> dict:
        """The path's peak and the peak with the checks, in GB, so far."""
        now = self.torch.cuda.max_memory_allocated()
        return {"path": max(self.path_peak, now) / 1e9, "with_checks": max(self.peak, now) / 1e9}

    def _seen(self, quantize_leaf):
        def f(g, halves):
            self.leaf = g
            return quantize_leaf(g, halves)
        return f

    def _checked(self, dequantize_mean):
        def f(qs, ss, shape):
            out = dequantize_mean(qs, ss, shape)
            self.hop.append(self._timed(lambda: self._gate1(self.leaf, qs, ss, out)))
            self.leaf = None
            return out
        return f

    def _gate1(self, g, qs, ss, out) -> dict:
        import torch.distributed as dist

        from repro_torch.fl import steps
        from repro_torch.kernels import ops, ref

        torch = self.torch
        P, me = qs.shape[0], dist.get_rank(self.group)
        rows = steps.pod_rows(g.float()[None])
        q, s = ref.quantize_ref(rows, steps.rounding_halves({"g": g[None]}))
        del rows
        theirs = self.gather(torch.tensor(bit_digest(torch, q) + bit_digest(torch, s),
                                          device=q.device), self.group).tolist()
        gathered = [bit_digest(torch, qs[r]) + bit_digest(torch, ss[r]) for r in range(P)]
        lattice = (bool(torch.equal(qs[me], q.view(qs[me].shape)))
                   and _bits_equal(torch, ss[me], s.view(ss[me].shape)) and theirs == gathered)
        del q, s
        want = torch.mean(ref.dequantize_ref(qs.reshape(-1, steps.ROW), ss.reshape(-1, 1))
                          .view(P, -1), dim=0)[: out.numel()].view(out.shape)
        rec = {"numel": g.numel(), "lattice": lattice, "mean": _bits_equal(torch, out, want),
               "digest": bit_digest(torch, out)}
        del want
        if len(self.hop) == self.largest:  # the hop maps the leaves in leaf order
            stack = self.gather(g.float(), self.group)  # (P, ...): every rank's leaf, rank order
            rows = steps.pod_rows(stack)
            halves = steps.rounding_halves({"g": stack})
            q, s = ops.qsgd_quantize(rows, halves)
            whole = bool(torch.equal(q, qs.reshape(q.shape))) and _bits_equal(
                torch, s, ss.reshape(s.shape))
            del q, s, rows
            want = steps.q8_mean_over_pods({"g": stack}, halves)["g"]
            rec["whole"] = whole and _bits_equal(torch, out, want)
        return rec

    def _stepped(self, build_train_step):
        def build(*a, **kw):
            step = build_train_step(*a, **kw)

            def train_step(state, batch):
                self.hop, self.check_s = [], 0.0
                new_state, metrics = step(state, batch)
                gate2 = self._timed(lambda: self._gate2(new_state))
                self.steps.append({"gate1": self.hop, "gate2": gate2,
                                   "check_ms": self.check_s * 1e3})
                return new_state, metrics
            return train_step
        return build

    def _gate2(self, state) -> dict:
        from repro_torch.pytree import key_paths, leaves

        torch = self.torch
        paths, xs = key_paths(state), leaves(state)
        mine = torch.tensor([bit_digest(torch, x) for x in xs], dtype=torch.int64, device="cuda")
        every = self.gather(mine, self.group)  # (P, leaves, 2)
        differ = [p for i, p in enumerate(paths) if not all(
            torch.equal(every[0, i], every[r, i]) for r in range(1, every.shape[0]))]
        big = max(range(len(xs)), key=lambda i: xs[i].numel() * xs[i].element_size())
        whole = self.gather(xs[big], self.group)
        same = all(_bits_equal(torch, whole[0], whole[r]) for r in range(1, whole.shape[0]))
        return {"leaves": len(xs), "digests_differ": differ, "largest": paths[big],
                "largest_bytes": xs[big].numel() * xs[big].element_size(),
                "largest_equal": same}


def gate1_failed(records) -> list:
    """The indices of ``PodRankGates``' gate-1 records that failed."""
    return [i for i, r in enumerate(records)
            if not (r["lattice"] and r["mean"] and r.get("whole", True))]


def planted_rank_fault(kind: str):
    """One of RANK_FAULTS in the hop's all_gather, as a ``planted`` context
    on ``hierarchy``: the gathered pods in reverse rank order, or the
    scales' gather replaced by this rank's own scales for every pod."""
    import torch
    import torch.distributed as dist

    from repro_torch.fl import hierarchy

    def swapped(gather):
        return lambda t, group: gather(t, group).flip(0)

    def own_scales(gather):
        def f(t, group):
            if t.dtype == torch.float32 and t.shape[-1] == 1:  # the (R, 1) scales
                return t[None].expand(dist.get_world_size(group), *t.shape).contiguous()
            return gather(t, group)
        return f

    if kind == "the gathered pods swapped":
        return planted(hierarchy, "all_gather_pods", swapped)
    if kind == "each rank's own scales for both pods":
        return planted(hierarchy, "all_gather_pods", own_scales)
    raise ValueError(kind)


def hop_split_ms(torch, hierarchy, grads, group, halves) -> dict:
    """The hop over ``grads``' leaves in three parts, each between
    synchronizes on the host clock: the quantize launches, the two
    all_gathers (rows and scales, staged through pinned host buffers), the
    dequantize launches and the means."""
    out = {"quantize": 0.0, "all_gather": 0.0, "dequantize_mean": 0.0}
    for g in grads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, s = hierarchy.quantize_leaf(g, halves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        qs, ss = hierarchy.all_gather_pods(q, group), hierarchy.all_gather_pods(s, group)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        hierarchy.dequantize_mean(qs, ss, g.shape)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out["quantize"] += (t1 - t0) * 1e3
        out["all_gather"] += (t2 - t1) * 1e3
        out["dequantize_mean"] += (t3 - t2) * 1e3
    return out


def pod_rank(rank: int, tmp: str, layers: int, flags: dict) -> None:
    """One rank of phase 4i (spawned): pod ``rank`` of RANK_PODS on the
    card, through ``launch/train.train`` with a (RANK_PODS, 1, 1) mesh over
    a gloo group, the gates of ``PodRankGates`` installed; then the
    card's determinism, the planted faults and the hop's split on the next
    batch's gradients.  Writes ``tmp/rank{rank}.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    t_start = time.perf_counter()
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # both ranks on this host
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = flags["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=RANK_PODS, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        from repro_torch import configs
        from repro_torch.config import RunPlan
        from repro_torch.fl import hierarchy, steps
        from repro_torch.kernels import ops
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.launch import train
        from repro_torch.models import lm
        from repro_torch.pytree import key_paths, leaves

        mesh = mesh_mod._mk((RANK_PODS, 1, 1), ("pod", "data", "model"), "cuda")
        group = mesh.get_group("pod")
        cfg = cut_depth(configs.get_config(RANK_ARCH), layers)
        plan = RunPlan(aggregation="totoro_tree_q8")
        setup_s = time.perf_counter() - t_start
        with torch.device("meta"):
            sizes = [t.numel() for t in leaves(lm.init_params(torch.Generator(), cfg, device="meta"))]
        gates = PodRankGates(torch, group, sizes.index(max(sizes)))
        torch.cuda.reset_peak_memory_stats()
        with gates.installed():
            set_counts(dict.fromkeys(COUNTED, 0))
            t0 = time.perf_counter()
            run = train.train(cfg, plan, steps=POD_STEPS, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, device="cuda", mesh=mesh,
                              log=lambda *a: None)
            wall = time.perf_counter() - t0
            got = counts()
        peak = gates.peaks_gb()
        state = run.pop("state")
        pod = mesh.get_local_rank("pod")
        batch = train.make_batch(cfg, train.StreamConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH),
                                 POD_STEPS, None, "cuda")
        share = {k: v.reshape(RANK_PODS, -1, *v.shape[1:])[pod] for k, v in batch.items()}
        with uncounted():
            g1, m1 = steps.grads_and_metrics(cfg, plan, state["params"], share)
            g2, m2 = steps.grads_and_metrics(cfg, plan, state["params"], share)
            deterministic = all(_bits_equal(torch, a, b) for a, b in zip(leaves(g1), leaves(g2))) \
                and _bits_equal(torch, m1["loss"], m2["loss"])
            del g2
            named = dict(zip(key_paths(g1), leaves(g1)))
            small = min(named, key=lambda p: named[p].numel())
            planted_runs = {}
            with gates.installed():
                for kind in ("sound", RANK_KERNEL_FAULT) + RANK_FAULTS:
                    gates.hop = []
                    fault = (nullcontext() if kind == "sound" else planted_hop_fault(kind, ops)
                             if kind == RANK_KERNEL_FAULT else planted_rank_fault(kind))
                    with fault:
                        hierarchy.cross_pod_q8({small: named[small]}, RANK_PODS, group=group)
                    planted_runs[kind] = not gate1_failed(gates.hop)
            halves = steps.rounding_halves({p: g[None] for p, g in named.items()})
            split = [hop_split_ms(torch, hierarchy, list(named.values()), group, halves)
                     for _ in range(2)]
        n_leaves = len(named)
        out = {
            "rank": rank, "pod": pod, "layers": cfg.num_layers, "leaves": n_leaves,
            "launches": got, "losses": run["losses"], "auxes": run["auxes"],
            "step_ms": run["step_ms"], "check_ms": [s["check_ms"] for s in gates.steps],
            "gate1": [{"leaves": len(s["gate1"]), "failed": gate1_failed(s["gate1"]),
                       "whole": [r["numel"] for r in s["gate1"] if "whole" in r],
                       "digests": [r["digest"] for r in s["gate1"]]} for s in gates.steps],
            "gate2": [s["gate2"] for s in gates.steps],
            "deterministic_grads": deterministic, "planted": planted_runs, "fault_leaf": small,
            "hop_split_ms": split, "peak_mem_gb": peak["path"],
            "peak_mem_gb_with_checks": peak["with_checks"], "setup_s": setup_s,
            "train_wall_s": wall, "init_s": wall - sum(run["step_ms"]) / 1e3,
        }
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier(group)
    finally:
        dist.destroy_process_group()


def drive_pod_ranks(torch, smi: str, podded: dict) -> dict:
    """Phase 4i: RANK_PODS ranks spawned (``torch.multiprocessing``, a
    ``file://`` store in a temporary directory, removed after), each
    ``pod_rank``; every rank's launches, gates 1 and 2, its losses against
    phase 4e d's single-process podded run (``podded``: bit-equal when the
    card's gradients are deterministic, else within TRAIN_LOSS_RTOL), and
    the planted faults, each of which must fail gate 1 where the sound run
    passes.  The ranks are killed if they outlast RANK_TIMEOUT_S."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "card_free_gb": free / 1e9, "card_total_gb": total / 1e9}
    flags = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pods_")
    try:
        t0 = time.perf_counter()
        ctx = mp.start_processes(pod_rank, args=(tmp, RANK_LAYERS, flags), nprocs=RANK_PODS,
                                 start_method="spawn", join=False)
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > RANK_TIMEOUT_S:
                    raise SystemExit(f"phase 4i: the ranks outlasted {RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(RANK_PODS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n = ranks[0]["leaves"]
    want = {**dict.fromkeys(COUNTED, 0), "qsgd_quantize": POD_STEPS * n,
            "qsgd_dequantize": POD_STEPS * n}
    deterministic = all(r["deterministic_grads"] for r in ranks)
    if deterministic:
        same_losses = all(r["losses"] == podded["losses"] for r in ranks)
    else:
        same_losses = all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
                          for r in ranks for a, b in zip(r["losses"], podded["losses"]))
    out = {
        "arch": RANK_ARCH, "layers": ranks[0]["layers"], "ranks": RANK_PODS, "leaves": n,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": POD_STEPS, "wall_s": wall,
        "parent_held": held, "launches_per_rank": [r["launches"] for r in ranks],
        "launches_expected_per_rank": want,
        "gate1_every_leaf_every_step": all(
            not s["failed"] and s["leaves"] == n and len(s["whole"]) == 1
            for r in ranks for s in r["gate1"]),
        "hop_digests_equal_across_ranks": all(
            [s["digests"] for s in r["gate1"]] == [s["digests"] for s in ranks[0]["gate1"]]
            for r in ranks),
        "gate2_states_equal_every_step": all(
            not g["digests_differ"] and g["largest_equal"] for r in ranks for g in r["gate2"]),
        "deterministic_grads": deterministic,
        "gate3_bound": "bit-equal" if deterministic else f"rtol {TRAIN_LOSS_RTOL}",
        "gate3_losses_equal_4e_d": same_losses, "losses_4e_d": podded["losses"],
        "faults_caught": {k: all(not r["planted"][k] for r in ranks)
                          for k in (RANK_KERNEL_FAULT,) + RANK_FAULTS},
        "sound_run_passes": all(r["planted"]["sound"] for r in ranks),
        "ms_per_step_per_rank": [
            float(np.mean([a - c for a, c in zip(r["step_ms"][1:], r["check_ms"][1:])]))
            for r in ranks],
        "hop_split_ms_per_rank": [r["hop_split_ms"][-1] for r in ranks],
        "card": smi, "per_rank": ranks,
    }
    ok = (all(r["launches"] == want for r in ranks) and out["gate1_every_leaf_every_step"]
          and out["hop_digests_equal_across_ranks"] and out["gate2_states_equal_every_step"]
          and same_losses and all(out["faults_caught"].values()) and out["sound_run_passes"])
    if not ok:
        raise SystemExit(f"phase 4i: {json.dumps({k: v for k, v in out.items() if k != 'per_rank'})}")
    return out


def log_pod_ranks(pods: dict, smi: str) -> None:
    """Phase 4i's lines."""
    log(f"[4i pod ranks] podded totoro_tree_q8, {pods['arch']} {pods['layers']} layers, "
        f"{pods['ranks']} ranks (one pod each, a gloo pod group, both on the one card), global "
        f"B={pods['batch']} S={pods['seq']}, {pods['steps']} steps: losses "
        f"{[r['losses'] for r in pods['per_rank']]} against 4e d's {pods['losses_4e_d']} "
        f"({pods['gate3_bound']}: the card's gradients deterministic: "
        f"{pods['deterministic_grads']}; equal: {pods['gate3_losses_equal_4e_d']}); launches a rank "
        f"{json.dumps(pods['launches_per_rank'][0])} ({pods['leaves']} leaves a step); gate 1 (hop "
        f"= q8_mean_over_pods of the stacked gradients, lattice and scales too; every leaf by "
        f"digest, the largest whole): "
        f"{pods['gate1_every_leaf_every_step']}; gate 2 (states equal after every step): "
        f"{pods['gate2_states_equal_every_step']}; planted faults caught "
        f"{json.dumps(pods['faults_caught'])}, the sound run passing: {pods['sound_run_passes']}")
    log(f"[4i pod ranks] two ranks sharing one card, not a multi-card number: ms a step a rank "
        f"(steps 2-{pods['steps']}, the gates' time left out) "
        f"{[round(x, 1) for x in pods['ms_per_step_per_rank']]}; the hop a step a rank, host clock "
        f"between synchronizes {json.dumps(pods['hop_split_ms_per_rank'])}; peak memory a rank "
        f"{[round(r['peak_mem_gb'], 2) for r in pods['per_rank']]} GB, with the gates' checks "
        f"{[round(r['peak_mem_gb_with_checks'], 2) for r in pods['per_rank']]} GB (the parent holding "
        f"{json.dumps(pods['parent_held'])}); set-up {[round(r['setup_s'], 1) for r in pods['per_rank']]} s, "
        f"init {[round(r['init_s'], 1) for r in pods['per_rank']]} s, phase wall {pods['wall_s']:.1f} s; "
        f"card: {smi}")
    log(f"[4i pod ranks] {json.dumps({k: v for k, v in pods.items() if k != 'per_rank'})}")
    for r in pods["per_rank"]:
        log(f"[4i pod ranks] rank {r['rank']}: {json.dumps(r)}")


@contextmanager
def shard_fault(kind: str):
    """One of SHARD_FAULTS planted in the port at run time (in a rank of
    phase 4j): the attention's ``wo`` output (``lm``'s attention mixer
    entry), a partial sum over ``model``, read as already reduced; every parameter gradient's partial sum over
    ``data`` read as reduced (the FSDP gathers' backward and the grads'
    placement), so each data rank keeps its own batch's share; the batch
    placed with data rank 0's rows on every data rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch import optim
    from repro_torch.launch import specs
    from repro_torch.models import lm, nn

    def unreduced(t, axis):
        """``t`` with its partial sums over ``axis`` read as replicated."""
        names = t.device_mesh.mesh_dim_names
        pls = [Replicate() if n == axis and isinstance(pl, Partial) else pl
               for n, pl in zip(names, t.placements)]
        return DTensor.from_local(t.to_local(), t.device_mesh, pls, shape=t.shape,
                                  stride=t.stride())

    if kind == SHARD_FAULTS[0]:
        def make(entry):
            def gqa(*a, **k):
                out, cache = entry[1](*a, **k)
                return (unreduced(out, "model") if isinstance(out, DTensor) else out), cache
            return (entry[0], gqa, entry[2])
        ctx = planted(lm._MIXERS, "attn", make)
    elif kind == SHARD_FAULTS[1]:
        import torch

        class Gather(torch.autograd.Function):
            @staticmethod
            def forward(ctx, w, gather):
                ctx.placements = w.placements
                return gather(w.detach())

            @staticmethod
            def backward(ctx, g):
                g = unreduced(g, "data")
                return g.redistribute(g.device_mesh, ctx.placements), None

        def make_gather(orig):
            return lambda w: Gather.apply(w, orig) if isinstance(w, DTensor) else w

        def make_placed(orig):
            return lambda t, like: orig(unreduced(t, "data") if isinstance(t, DTensor) else t,
                                        like)

        @contextmanager
        def both():
            with planted(nn, "gather_fsdp", make_gather), \
                    planted(optim, "placed_like", make_placed):
                yield
        ctx = both()
    elif kind == SHARD_FAULTS[2]:
        def make(orig):
            def place(tree, shardings):
                out = orig(tree, shardings)
                if "labels" not in tree:
                    return out
                fixed = {}
                for k, t in tree.items():
                    d = out[k]
                    mesh = d.device_mesh
                    first = t.chunk(mesh.size(mesh.mesh_dim_names.index("data")), 0)[0]
                    fixed[k] = DTensor.from_local(first.contiguous(), mesh, d.placements,
                                                  shape=d.shape, stride=d.stride())
                return fixed
            return place
        ctx = planted(specs, "place", make)
    else:
        raise ValueError(kind)
    with ctx:
        yield


def _adam_direction(m, v):
    """AdamW's first-step direction from its moments, in f64: (m / c1) /
    (sqrt(v / c2) + eps) at step 1 under the optimizer's defaults."""
    c1, c2 = 1.0 - 0.9, 1.0 - 0.95
    return (m.double() / c1) / ((v.double() / c2).sqrt() + 1e-8)


def shard_readings(torch, state, want: dict, lr: float) -> tuple:
    """Phase 4j a on one rank: each state leaf's shard (a DTensor of the
    sharded step's state) against the same slice of the single-process
    step's leaf (``want``: leaf path -> the whole leaf, this rank's own
    run): the largest difference.  A weight (parameters, master) is held
    to the single-process weight moved by lr times the difference of the
    two runs' AdamW directions, each from its own m and v: the first
    update, lr g / (|g| + 1e-8), turns a gradient's rounding into up to
    2 lr where |g| is ~1e-8, so the weights are compared after that map
    and the gradients through m and v.  Returns (paths, a (leaves,) f64
    tensor)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.ckpt import key_paths
    from repro_torch.pytree import leaves

    paths = key_paths(state)
    local = dict(zip(paths, (t.to_local() for t in leaves(state))))
    rows = []
    for path, t in zip(paths, leaves(state)):
        def mine(whole):
            return distribute_tensor(whole, t.device_mesh, t.placements,
                                     src_data_rank=None).to_local()
        w = mine(want[path]).double()
        if path.startswith(("params/", "opt/master/")):
            leaf = path.split("/", 1)[1].removeprefix("master/")
            m, v = f"opt/m/{leaf}", f"opt/v/{leaf}"
            w = w - lr * (_adam_direction(local[m], local[v])
                          - _adam_direction(mine(want[m]), mine(want[v])))
        d = (local[path].double() - w).abs()
        rows.append(float(d.max()) if d.numel() else 0.0)
    return paths, torch.tensor(rows, dtype=torch.float64)


def shard_gate(readings, want: dict, loss: float) -> dict:
    """Phase 4j a's gate from every rank's ``shard_readings`` (their
    element-wise max, ``readings``): the loss within TRAIN_LOSS_RTOL and
    each leaf's largest difference within TRAIN_GRAD_REL of its largest
    magnitude."""
    paths, rows = readings
    rel = {p: float(r) / max(float(want[p].float().abs().max()), 1e-30)
           for p, r in zip(paths, rows)}
    out = {"loss_rel": abs(loss - want["loss"]) / abs(want["loss"]), "leaf_rel": rel,
           "leaf_rel_max": max(rel.values())}
    out["passed"] = out["loss_rel"] <= TRAIN_LOSS_RTOL and out["leaf_rel_max"] <= TRAIN_GRAD_REL
    return out


def shard_rank(rank: int, tmp: str, layers: int) -> None:
    """One rank of phase 4j (spawned): a, the f32 gate and its planted
    faults (launch/train's seed-0 parameters and first batch, drawn once;
    the single-process step on every rank, each rank reading its own
    shards against it); b, the bf16 run through ``launch/train.train``
    with its collectives logged.  Writes ``tmp/rank{rank}.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank on this host
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=SHARD_RANKS,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        from repro_torch import configs
        from repro_torch.config import RunPlan, ShapeSpec
        from repro_torch.fl import steps
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.launch import specs, train
        from repro_torch.models import lm
        from repro_torch.pytree import key_paths, leaves

        t0 = time.perf_counter()
        mesh = mesh_mod._mk(SHARD_MESH, SHARD_AXES, "cuda")
        tiny = configs.get_config(SHARD_ARCH)
        plan = RunPlan(aggregation="totoro_tree")
        f32 = cut_depth(tiny, SHARD_F32_LAYERS).replace(dtype="float32", param_dtype="float32")
        # launch/train's seed-0 parameters and first batch, drawn once
        params = lm.init_params(torch.Generator().manual_seed(0), f32, device="cuda")
        batch = train.make_batch(f32, train.StreamConfig(f32.vocab_size, SHARD_F32_SEQ,
                                                         SHARD_F32_BATCH), 0, None, "cuda")
        state, metrics = steps.build_train_step(f32, plan)(steps.init_train_state(f32, params),
                                                           batch)  # one process, every rank
        want = dict(zip(key_paths(state), leaves(state)), loss=float(metrics["loss"]))
        del state
        state_sh, batch_sh = specs.cell_for(f32, ShapeSpec("4j a", "train", SHARD_F32_SEQ,
                                                           SHARD_F32_BATCH), plan,
                                            mesh).in_shardings
        step = steps.build_train_step(f32, plan, mesh=mesh)
        gate = {}
        for kind in ("sound",) + SHARD_FAULTS:
            with nullcontext() if kind == "sound" else shard_fault(kind):
                state = specs.place(steps.init_train_state(f32, specs.place(
                    params, state_sh["params"])), state_sh)
                state, metrics = step(state, specs.place(batch, batch_sh))
            paths, rows = shard_readings(torch, state, want, f32.learning_rate)
            dist.all_reduce(rows, op=dist.ReduceOp.MAX)  # a CPU tensor: gloo as it is
            gate[kind] = shard_gate((paths, rows), want, float(metrics["loss"].full_tensor()))
            del state
        del want, params
        torch.cuda.empty_cache()
        gate_s = time.perf_counter() - t0

        cfg = cut_depth(tiny, layers)
        # what b's placed state and batch take on this rank (phase 4k b):
        # launch/train.train's placement, measured around it
        requested = "requested_bytes.all.current"
        before = torch.cuda.memory_allocated(), torch.cuda.memory_stats()[requested]
        state_sh, batch_sh = specs.cell_for(cfg, ShapeSpec("4j b", "train", TRAIN_SEQ, TRAIN_BATCH),
                                            plan, mesh).in_shardings
        params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
        placed = (specs.place(steps.init_train_state(cfg, specs.place(params, state_sh["params"])),
                              state_sh),
                  specs.place(train.make_batch(cfg, train.StreamConfig(
                      cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 0, None, "cuda"), batch_sh))
        del params
        placed_bytes = {"allocated": torch.cuda.memory_allocated() - before[0],
                        "requested": torch.cuda.memory_stats()[requested] - before[1],
                        "largest_state_leaf": max(t.to_local().numel() * t.element_size()
                                                  for t in leaves(placed[0]))}
        del placed
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh_mod.reset_wire()
        set_counts(dict.fromkeys(COUNTED, 0))
        with mesh_mod.CollectiveLog(mesh) as coll:
            t0 = time.perf_counter()
            run = train.train(cfg, plan, steps=SHARD_STEPS, seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, device="cuda", mesh=mesh,
                              log=lambda *a: None)
            wall = time.perf_counter() - t0
        wire = mesh_mod.wire_stats()
        launches, peak_bytes = counts(), torch.cuda.max_memory_allocated()
        with shard_fault(SHARD_B_FAULT):  # the same run's first steps, faulted
            faulted = train.train(cfg, plan, steps=SHARD_B_FAULT_STEPS, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, device="cuda", mesh=mesh,
                                  log=lambda *a: None)["losses"]
        out = {
            "rank": rank, "coords": {a: mesh.get_local_rank(a) for a in SHARD_AXES},
            "gate": gate, "layers": cfg.num_layers, "losses": run["losses"],
            "step_ms": run["step_ms"], "launches": launches, "faulted_losses": faulted,
            "peak_mem_gb": peak_bytes / 1e9, "peak_bytes": peak_bytes,
            "placed_bytes": placed_bytes, "collective_calls": coll.calls,
            "collectives_per_step": {k: {"count": v["count"] / SHARD_STEPS,
                                         "bytes": v["bytes"] / SHARD_STEPS}
                                     for k, v in coll.summary().items()},
            "wire_per_step": {k: {"calls": v["calls"] / SHARD_STEPS,
                                  "ms": v["seconds"] * 1e3 / SHARD_STEPS,
                                  "bytes": v["bytes"] / SHARD_STEPS} for k, v in wire.items()},
            "train_wall_s": wall, "gate_s": gate_s,
        }
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def drive_shard_ranks(torch, smi: str, plain: dict) -> dict:
    """Phase 4j: SHARD_RANKS ranks spawned (``shard_rank``), killed if they
    outlast SHARD_TIMEOUT_S.  The f32 gate must pass the sound run and fail
    each planted fault; the bf16 losses must lie within SHARD_BF16_LOSS_RTOL
    of ``plain``'s (the same steps in one process on the card), with no
    kernel launched (none lies on this path), and SHARD_B_FAULT's must
    not."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        t0 = time.perf_counter()
        ctx = mp.start_processes(shard_rank, args=(tmp, SHARD_LAYERS), nprocs=SHARD_RANKS,
                                 start_method="spawn", join=False)
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                    raise SystemExit(f"phase 4j: the ranks outlasted {SHARD_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    gate = ranks[0]["gate"]
    rel = [abs(a - b) / abs(b) for r in ranks for a, b in zip(r["losses"], plain["losses"])]
    faulted = [max(abs(a - b) / abs(b) for a, b in zip(r["faulted_losses"], plain["losses"]))
               for r in ranks]
    steady = [float(np.mean(r["step_ms"][1:])) for r in ranks]
    wire_ms = [sum(v["ms"] for v in r["wire_per_step"].values()) for r in ranks]
    out = {
        "arch": SHARD_ARCH, "mesh": dict(zip(SHARD_AXES, SHARD_MESH)), "ranks": SHARD_RANKS,
        "aggregation": "totoro_tree", "layers": ranks[0]["layers"], "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": SHARD_STEPS, "wall_s": wall,
        "a_f32_gate": gate, "a_sound_passes": gate["sound"]["passed"],
        "a_faults_caught": {k: not gate[k]["passed"] for k in SHARD_FAULTS},
        "b_losses": ranks[0]["losses"], "b_losses_plain": plain["losses"],
        "b_loss_rel_max": max(rel), "b_losses_equal_across_ranks": all(
            r["losses"] == ranks[0]["losses"] for r in ranks),
        "b_fault": SHARD_B_FAULT, "b_fault_losses": ranks[0]["faulted_losses"],
        "b_fault_loss_rel_max_per_rank": faulted,
        "ms_per_step_per_rank": steady,
        "wire_ms_per_step_per_rank": wire_ms,
        "wire_share_of_step": [w / s for w, s in zip(wire_ms, steady)],
        "collectives_per_step": ranks[0]["collectives_per_step"],
        "wire_per_step_rank0": ranks[0]["wire_per_step"],
        "gate_s_per_rank": [r["gate_s"] for r in ranks],
        "b_train_wall_s_per_rank": [r["train_wall_s"] for r in ranks],
        "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks],
        "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
        "placed_bytes_per_rank": [r["placed_bytes"] for r in ranks],
        "collective_calls_rank0": ranks[0]["collective_calls"],
        "launches_per_rank": [r["launches"] for r in ranks], "card": smi,
    }
    ok = (out["a_sound_passes"] and all(out["a_faults_caught"].values())
          and out["b_loss_rel_max"] <= SHARD_BF16_LOSS_RTOL and out["b_losses_equal_across_ranks"]
          and min(faulted) > SHARD_BF16_LOSS_RTOL
          and all(np.isfinite(out["b_losses"]))
          and all(r["launches"] == dict.fromkeys(COUNTED, 0) for r in ranks))
    if not ok:
        raise SystemExit(f"phase 4j: {json.dumps(out)}")
    return out


def shard_plain_losses(torch) -> dict:
    """Phase 4j b's reference: the same SHARD_STEPS bf16 steps at
    SHARD_LAYERS layers in one process on the card."""
    from repro_torch import configs
    from repro_torch.config import RunPlan
    from repro_torch.launch import train

    cfg = cut_depth(configs.get_config(SHARD_ARCH), SHARD_LAYERS)
    with uncounted():
        run = train.train(cfg, RunPlan(), steps=SHARD_STEPS, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, device="cuda", log=lambda *a: None)
    torch.cuda.empty_cache()
    return {"losses": run["losses"], "from": f"one process, {SHARD_LAYERS} layers"}


def log_shard_ranks(sh: dict, smi: str) -> None:
    """Phase 4j's lines."""
    a = sh["a_f32_gate"]
    log(f"[4j sharded a] {sh['arch']} full width, {SHARD_F32_LAYERS} layers f32, mesh "
        f"{json.dumps(sh['mesh'])} over {sh['ranks']} gloo ranks on the one card, totoro_tree, "
        f"B={SHARD_F32_BATCH} S={SHARD_F32_SEQ}: one sharded step against the single-process "
        f"step (each rank its shards; the weights after AdamW's first-step map), loss rel "
        f"{a['sound']['loss_rel']:.3g}, leaves rel max {a['sound']['leaf_rel_max']:.3g} (bounds "
        f"{TRAIN_LOSS_RTOL}, {TRAIN_GRAD_REL}); faults caught "
        f"{json.dumps(sh['a_faults_caught'])}: "
        + "; ".join(f"{k}: loss rel {a[k]['loss_rel']:.3g}, leaves {a[k]['leaf_rel_max']:.3g}"
                    for k in SHARD_FAULTS))
    log(f"[4j sharded b] {sh['layers']} layers bf16, B={sh['batch']} S={sh['seq']}, "
        f"{sh['steps']} steps: losses {sh['b_losses']} against one process's "
        f"{sh['b_losses_plain']} (rel max {sh['b_loss_rel_max']:.3g}, bound "
        f"{SHARD_BF16_LOSS_RTOL}); {sh['b_fault']} for {SHARD_B_FAULT_STEPS} steps: losses "
        f"{sh['b_fault_losses']} (rel max a rank "
        f"{[f'{x:.3g}' for x in sh['b_fault_loss_rel_max_per_rank']]}, above the bound); four ranks sharing one card, not a multi-card number: ms a "
        f"step a rank (steps 2-{sh['steps']}) {[round(x, 1) for x in sh['ms_per_step_per_rank']]}, "
        f"of it in the staged collectives (host clock) "
        f"{[round(x, 1) for x in sh['wire_ms_per_step_per_rank']]}; peak memory a rank "
        f"{[round(x, 2) for x in sh['peak_mem_gb_per_rank']]} GB; phase wall {sh['wall_s']:.1f} "
        f"s; card: {smi}")
    log(f"[4j sharded b] collectives a step (rank 0, op/mesh axis): "
        f"{json.dumps(sh['collectives_per_step'])}")
    log(f"[4j sharded] "
        f"{json.dumps({k: v for k, v in sh.items() if k != 'collective_calls_rank0'})}")


def dryrun_cmd(*args: str) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", SHARD_ARCH,
            "--shape", "train_4k", *args]


def dryrun_gates(rec: dict, sh: dict) -> dict:
    """Phase 4k's gates a-c and reading d, from the dry-run's record of 4j
    b's cell and 4j's output ``sh``."""
    from repro_torch import configs

    # 4j b's log holds its steps' collectives in order, each step's alike: the
    # dry-run's one step, repeated, must be it call for call (op, mesh axis,
    # bytes), which holds the per-op totals too
    want = [list(c) for c in rec["collectives"]["calls"]] * sh["steps"]
    card_calls = sh["collective_calls_rank0"]
    first_diff = next((i for i, (a, b) in enumerate(zip(want, card_calls)) if a != b),
                      None if len(want) == len(card_calls) else min(len(want), len(card_calls)))
    arg = rec["memory"]["argument_bytes_per_dev"]
    placed = [r["allocated"] for r in sh["placed_bytes_per_rank"]]
    requested = [r["requested"] for r in sh["placed_bytes_per_rank"]]
    peak = rec["memory"]["peak_bytes_per_dev"]
    cfg = cut_depth(configs.get_config(SHARD_ARCH), sh["layers"])
    mf = model_flops(cfg, sh["batch"] * sh["seq"], sh["seq"])
    return {
        "a_schedule_equal": card_calls == want,
        "a_calls_first_difference": first_diff,
        "b_argument_bytes": arg, "b_placed_allocated_per_rank": placed,
        "b_placed_requested_per_rank": requested,
        "b_rel_per_rank": [abs(arg - m) / m for m in placed],
        "b_passes": (all(abs(arg - m) <= DRYRUN_ARG_REL * m for m in placed)
                     and all(m == arg for m in requested)),
        "c_peak_bytes": peak, "c_card_peak_bytes_per_rank": sh["peak_bytes_per_rank"],
        "c_ratio_per_rank": [peak / m for m in sh["peak_bytes_per_rank"]],
        "c_passes": all(abs(peak / m - 1) <= DRYRUN_PEAK_REL for m in sh["peak_bytes_per_rank"]),
        "d_flops_per_dev": rec["cost"]["flops_per_dev"], "d_model_flops": mf,
        "d_ratio": rec["cost"]["flops_per_dev"] * rec["chips"] / mf,
    }


def drive_dryrun(smi: str, sh: dict) -> dict:
    """Phase 4k: the dry-run of 4j b's cell (``--calls``) and of the
    production mesh's at DRYRUN_PROD_LAYERS layers, two subprocesses at once
    with no card visible, read against 4j's output ``sh``; gates a-c must
    pass on the sound record and each of DRYRUN_FAULTS, planted in a copy
    of it, must fail its gate."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), CUDA_VISIBLE_DEVICES="")
    cmds = {
        "cell": dryrun_cmd("--mesh-shape", "x".join(map(str, SHARD_MESH)), "--layers",
                           str(sh["layers"]), "--seq-len", str(sh["seq"]), "--global-batch",
                           str(sh["batch"]), "--aggregation", sh["aggregation"], "--calls",
                           "--out", os.path.join(tmp, "cell.json")),
        "production": dryrun_cmd("--mesh", "single", "--layers", str(DRYRUN_PROD_LAYERS),
                                 "--out", os.path.join(tmp, "production.json")),
    }
    procs: dict = {}
    try:
        t0 = time.perf_counter()
        for k, c in cmds.items():
            procs[k] = subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
        outs = {k: p.communicate(timeout=DRYRUN_TIMEOUT_S) for k, p in procs.items()}
        wall = time.perf_counter() - t0
        for k, p in procs.items():
            if p.returncode:
                raise SystemExit(f"phase 4k: the {k} dry-run exited {p.returncode}: "
                                 f"{outs[k][1][-3000:]}")
        with open(os.path.join(tmp, "cell.json")) as f:
            rec = json.load(f)[0]
        with open(os.path.join(tmp, "production.json")) as f:
            prod = json.load(f)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


    gates = dryrun_gates(rec, sh)
    dropped = json.loads(json.dumps(rec))
    dropped["collectives"]["calls"].pop(0)
    doubled = json.loads(json.dumps(rec))
    doubled["memory"]["argument_bytes_per_dev"] += sh["placed_bytes_per_rank"][0][
        "largest_state_leaf"]
    faults = {DRYRUN_FAULTS[0]: not dryrun_gates(dropped, sh)["a_schedule_equal"],
              DRYRUN_FAULTS[1]: not dryrun_gates(doubled, sh)["b_passes"]}
    out = {"cell": {k: v for k, v in rec.items() if k != "collectives"},
           "cell_collectives": {k: v for k, v in rec["collectives"].items() if k != "calls"},
           "gates": gates, "faults_caught": faults, "production": prod, "wall_s": wall,
           "card": smi}
    ok = (gates["a_schedule_equal"] and gates["b_passes"] and gates["c_passes"]
          and all(faults.values()) and prod["cost"]["flops_per_dev"] > 0)
    if not ok:
        raise SystemExit(f"phase 4k: {json.dumps(out)}")
    return out


def log_dryrun(dr: dict, smi: str) -> None:
    """Phase 4k's lines."""
    g = dr["gates"]
    log(f"[4k dryrun] 4j b's cell on a fake process group of {dr['cell']['chips']} ranks (CPU "
        f"counts, no card): a, collectives of one step, repeated, equal to 4j b's calls on rank "
        f"0 (op, mesh axis, bytes, in order): {g['a_schedule_equal']} (first difference at "
        f"{g['a_calls_first_difference']}); b, argument bytes "
        f"{g['b_argument_bytes']} against the placed state and batch on each rank "
        f"{g['b_placed_allocated_per_rank']} (memory_allocated), rel "
        f"{[f'{x:.3g}' for x in g['b_rel_per_rank']]} (bound {DRYRUN_ARG_REL}), and requested "
        f"{g['b_placed_requested_per_rank']} (equal to the byte); c, peak {g['c_peak_bytes']} "
        f"against 4j b's {g['c_card_peak_bytes_per_rank']}, ratio {[round(x, 4) for x in g['c_ratio_per_rank']]} "
        f"(bound ±{DRYRUN_PEAK_REL}); d, flops a device x {dr['cell']['chips']} over model_flops "
        f"{g['d_ratio']:.4f} (not gated); faults caught {json.dumps(dr['faults_caught'])}; "
        f"wall {dr['wall_s']:.1f} s; card: {smi}")
    log(f"[4k dryrun] {json.dumps({k: v for k, v in dr.items() if k != 'production'})}")
    log(f"[4k dryrun] production 16x16, {DRYRUN_PROD_LAYERS} layers: "
        f"{json.dumps(dr['production'])}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    marks = []  # (phase, host clock at its start): each phase's wall, logged at the end

    from repro_torch.core import pathplan
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import broadcast as bc
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import policy_update as pu
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import tree_aggregate as ta

    marks.append(("1", time.perf_counter()))
    # -- 1. device ------------------------------------------------------------
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"[1 device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[1 device] nvidia-smi: {smi}")

    marks.append(("2", time.perf_counter()))
    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, all started together
    for name in _build.sources():
        _build.load(name)
    log(f"[2 build] {_build.sources()} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    marks.append(("3", time.perf_counter()))
    # -- 3. kernels against their plain versions -----------------------------
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [
        (3, 5, 333, f32), (3, 5, 333, bf16),      # ragged groups, L % 1024 != 0
        (1, 1, 1, f32), (4, 1, 1029, bf16),       # C = 1
        (1, 7, 4097, f32),                         # G = 1
        (1, 16, 131072, bf16), (1, 16, 131072, f32),  # kernel bench shape
    ]
    max_err = check_tree_aggregate(torch, ta, ref, shapes)
    torch.cuda.synchronize()
    log(f"[3 kernels] tree_aggregate_groups max_abs_err={max_err:.3e} over {len(shapes)} shapes")
    comp_err = check_compression_kernels(torch, qz, bc, ta, ref)
    log(f"[3 kernels] slice-B kernels max_abs_err {json.dumps(comp_err)}")
    fused_cases = [(1, f32), (1000, f32), (1 << 17, bf16), (1 << 17, f32), (1 << 24, f32)]
    fused_err = check_fused_update(torch, fu, ops, ref, fused_cases)
    n_big = 2 * fu.max_leaves() + 5  # past one launch's parameter table
    fused_err = max(fused_err, check_fused_tables(torch, fu, ops, ref, [
        ("edge", [1, 0, 7, 4099, 0, 3, 1000, 1], [f32, bf16], (0, 2, 3, 6)),
        ("edge-f32", [1, 0, 7, 4099, 0, 3, 1000, 1], [f32], (2, 3)),
        (f"{n_big}-leaves", [(37 * j) % 3001 for j in range(n_big)], [f32, bf16], range(0, n_big, 7)),
    ]))
    policy_err = check_policy_update(torch, pu, ref, pathplan)
    log(f"[3 kernels] slice-C kernels max_abs_err fused_update={fused_err:.3e} "
        f"policy_update={policy_err:.3e}")

    marks.append(("4a", time.perf_counter()))
    # -- 4a. slice A: the synchronous round at full width ----------------------
    # The CPU comparison below runs in full f32; cuDNN's convolutions would
    # otherwise run the CNN in TF32 (about 3 decimal digits), and matmuls
    # are kept from it too, so the card and the CPU compute the same function.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_counts(dict.fromkeys(COUNTED, 0))
    t0 = time.perf_counter()
    gpu = drive_main_path("cuda")
    torch.cuda.synchronize()
    sync_counts = counts()
    launches = sync_counts["tree_aggregate_groups"]
    wall = time.perf_counter() - t0
    n_levels = len(gpu["levels"])
    log(f"[4 main path] quickstart losses: {[round(l, 4) for l in gpu['losses']]}")
    log(f"[4 main path] quickstart accuracy after each of 8 rounds: {gpu['accs']}")
    log(f"[4 main path] master failed -> new master {hex(gpu['new_master'])}")
    log(f"[4 main path] CNN losses: {gpu['cnn_losses']}; params L: {gpu['sizes']}")
    log(f"[4 main path] tree levels (G, C, L): {[lv[:3] for lv in gpu['levels']]}")
    log(f"[4 main path] launches {json.dumps(sync_counts)} for {n_levels} levels; "
        f"{wall:.2f} s wall")
    sync_want = {**dict.fromkeys(COUNTED, 0), "tree_aggregate_groups": n_levels,
                 "fused_update": gpu["fused_implied"]}
    log(f"[4 main path] fused_update launches implied by the training dispatches "
        f"(local steps x launches per step's leaf table): {gpu['fused_implied']}")
    if launches == 0 or gpu["fused_implied"] == 0 or sync_counts != sync_want:
        raise SystemExit(f"expected launches {sync_want}, saw {sync_counts}")
    if not gpu["losses"][-1] < gpu["losses"][0] or not gpu["cnn_losses"][-1] < gpu["cnn_losses"][0]:
        raise SystemExit("loss did not fall")
    level_shapes = sorted({lv[:3] for lv in gpu["levels"]})
    level_err = check_tree_aggregate(torch, ta, ref, [(*s, f32) for s in level_shapes])
    max_err = max(max_err, level_err)
    log(f"[4 main path] tree_aggregate_groups max_abs_err={level_err:.3e} over "
        f"{len(level_shapes)} main-path level shapes")
    leaf_tables = set(gpu["leaf_tables"])
    cpu = drive_main_path("cpu")
    errs = {
        "quickstart_loss": compare("quickstart loss", gpu["losses"], cpu["losses"], PATH_TOL),
        "cnn_loss": compare("cnn loss", gpu["cnn_losses"], cpu["cnn_losses"], PATH_TOL),
    }
    for k in gpu["params"]:
        errs[f"mlp.{k}"] = compare(f"mlp {k}", gpu["params"][k], cpu["params"][k], PATH_TOL)
    for k in gpu["cnn_params"]:
        errs[f"cnn.{k}"] = compare(f"cnn {k}", gpu["cnn_params"][k], cpu["cnn_params"][k], PATH_TOL)
    if gpu["levels"] != cpu["levels"] or gpu["new_master"] != cpu["new_master"]:
        raise SystemExit("control plane differs between the card and CPU runs")
    log(f"[4 main path] card vs CPU max abs diff {json.dumps(errs)} ({PATH_TOL})")

    marks.append(("4b", time.perf_counter()))
    # -- 4b. slice B: the async buffered round, compressed and not ------------
    async_counts = {}
    runs = {}
    for compressed in (True, False):
        tag = "compressed" if compressed else "uncompressed"
        set_counts(dict.fromkeys(COUNTED, 0))
        t0 = time.perf_counter()
        run = drive_async("cuda", compressed, record=compressed)
        torch.cuda.synchronize()
        async_counts[tag] = got = counts()
        want = async_launches_expected(run, compressed)
        log(f"[4 async {tag}] losses: {[round(l, 5) for l in run['losses']]}")
        log(f"[4 async {tag}] applies (t_ms, arrivals, mean/max staleness): "
            f"{[(round(e[2], 3), e[3], e[4], e[5]) for e in run['events']]}")
        log(f"[4 async {tag}] churn: {run['churn']}")
        log(f"[4 async {tag}] launches {json.dumps(got)}, implied by {sum(run['arrivals'])} "
            f"commits over {len(run['arrivals'])} applies: {json.dumps(want)}; "
            f"{time.perf_counter() - t0:.2f} s wall")
        if got != want:
            raise SystemExit(f"async {tag}: launches {got} differ from the run's {want}")
        if len(run["losses"]) != ASYNC_APPLIES or not run["losses"][-1] < run["losses"][0]:
            raise SystemExit(f"async {tag}: {len(run['losses'])} applies, or the loss did not fall")
        leaf_tables |= run["leaf_tables"]
        runs[tag] = run
    replayed = replay_on_cpu(torch, ref, runs["compressed"]["calls"])
    log(f"[4 async compressed] every card kernel call re-run through its plain version on "
        f"the CPU: {json.dumps(replayed)} calls; quantize (EF residuals included), dequantize "
        f"and chain apply bit-equal, int8 aggregation bit-equal to its chain and within {TOL}")
    # the full-model QSGD downlink: each apply's broadcast runs qsgd_dequantize
    tag = "compressed-qsgd-downlink"
    set_counts(dict.fromkeys(COUNTED, 0))
    t0 = time.perf_counter()
    run = drive_async("cuda", True, record=True, downlink="qsgd-int8", applies=QSGD_DOWNLINK_APPLIES)
    torch.cuda.synchronize()
    async_counts[tag] = got = counts()
    want = async_launches_expected(run, True, "qsgd-int8")
    log(f"[4 async {tag}] losses: {[round(l, 5) for l in run['losses']]}; launches "
        f"{json.dumps(got)}, implied by {sum(run['arrivals'])} commits over "
        f"{len(run['arrivals'])} applies: {json.dumps(want)}; {time.perf_counter() - t0:.2f} s wall")
    if got != want or len(run["losses"]) != QSGD_DOWNLINK_APPLIES or not np.all(np.isfinite(run["losses"])):
        raise SystemExit(f"async {tag}: launches {got} differ from {want}, or applies or losses are off")
    leaf_tables |= run["leaf_tables"]
    runs[tag] = run
    replayed = replay_on_cpu(torch, ref, run["calls"])
    log(f"[4 async {tag}] every card kernel call re-run through its plain version on the CPU: "
        f"{json.dumps(replayed)} calls, bit-equal (the aggregation to its chain)")

    cpu_u = drive_async("cpu", False)
    cpu_c = drive_async("cpu", True, record=True)
    for tag, c in (("uncompressed", cpu_u), ("compressed", cpu_c)):
        g = runs[tag]
        if (g["events"], g["churn"], g["downlink_log"]) != (c["events"], c["churn"], c["downlink_log"]):
            raise SystemExit(f"async {tag}: event, churn or download traces differ from the CPU run")
    aerr = {"loss": compare("async loss", runs["uncompressed"]["losses"], cpu_u["losses"], PATH_TOL)}
    for k, v in runs["uncompressed"]["params"].items():
        aerr[k] = compare(f"async {k}", v, cpu_u["params"][k], PATH_TOL)
    log(f"[4 async uncompressed] traces identical to the CPU run; max abs diff "
        f"{json.dumps(aerr)} ({PATH_TOL})")
    first = runs["compressed"]["arrivals"][0]
    lat = [[out[0] for _, _, out in run["calls"]["qsgd_quantize_residual"]][:first]
           for run in (runs["compressed"], cpu_c)]
    steps = torch.stack([(a.int() - b.int()).abs() for a, b in zip(*lat)])
    dloss = np.abs(np.subtract(runs["compressed"]["losses"], cpu_c["losses"]))
    probe = drive_async("cpu", True, perturb=PERTURB)
    if probe["events"] != cpu_c["events"]:
        raise SystemExit("async compressed: perturbed start weights changed the event trace")
    dprobe = float(np.abs(np.subtract(probe["losses"], cpu_c["losses"])).max())
    log(f"[4 async compressed] traces identical to the CPU run; first apply's {first} commit "
        f"lattices: max |dq|={int(steps.max())}, share of +-1 elements={float((steps == 1).float().mean()):.3e}; "
        f"per-apply loss max |d|={float(dloss.max()):.3e} (atol {ASYNC_LOSS_ATOL}), "
        f"all {[float(d) for d in dloss]}; CPU start weights perturbed by {PERTURB} "
        f"relative move the losses by max |d|={dprobe:.3e}")
    if int(steps.max()) > 1 or float(dloss.max()) > ASYNC_LOSS_ATOL:
        raise SystemExit("async compressed: the card and CPU runs disagree past the stated bounds")
    leaf_cases = sorted({leaf for table in leaf_tables for leaf in table})
    log(f"[4 main path] fused_update leaf tables of the sync and async runs: "
        f"{sorted([(n, str(d)[6:]) for n, d in t] for t in leaf_tables)}")
    fused_err = max(fused_err, check_fused_update(torch, fu, ops, ref, leaf_cases))
    path_tables = sorted([n for n, _ in t] for t in leaf_tables)
    fused_err = max(fused_err, check_fused_tables(torch, fu, ops, ref, [
        (f"path-{i}-{dt}", lengths, [d], ()) for i, lengths in enumerate(path_tables)
        for dt, d in (("f32", f32), ("bf16", bf16))]))

    marks.append(("4c", time.perf_counter()))
    # -- 4c. slice C: the planners, then live placement -------------------------
    set_counts(dict.fromkeys(COUNTED, 0))
    t0 = time.perf_counter()
    plan = drive_planners("cuda", record=True)
    torch.cuda.synchronize()
    plan_counts = counts()
    n_updates = sum(len(rec.episodes) for rec in plan["episodes"].values())
    plan_want = {**dict.fromkeys(COUNTED, 0), "policy_update": n_updates}
    for name, ser in plan["series"].items():
        brief = {k: (round(v[-1], 4) if isinstance(v, list) else v) for k, v in ser.items()
                 if k != "selection_freq"}
        log(f"[4 planner] {name}: last of each series {json.dumps(brief)}; "
            f"{plan['episode_ms'].get(name, float('nan')):.2f} ms an episode (host clock, first call)")
    log(f"[4 planner] launches {json.dumps(plan_counts)}, implied by {n_updates} Alg.-1 updates; "
        f"{time.perf_counter() - t0:.2f} s wall")
    if plan_counts != plan_want:
        raise SystemExit(f"planner: launches {plan_counts} differ from {plan_want}")
    tp, bd = (plan["series"][k]["cum_latency_ms"][-1] for k in ("totoro_plus", "bandit"))
    log(f"[4 planner] cumulative latency over 40 episodes: Totoro+ {tp:.1f} ms, bandit {bd:.1f} ms, "
        f"OPT {plan['series']['opt']['cum_latency_ms'][-1]:.1f} ms")
    if not tp < bd:
        raise SystemExit("planner: Totoro+'s cumulative latency is not below the bandit's")
    replay = replay_planners(torch, ref, pathplan, plan)
    log(f"[4 planner] every card policy update replayed on the CPU: {json.dumps(replay)} "
        f"(tol {PLANNER_TOL}; rho and pi~ identical on every node)")
    cpu_plan = drive_planners("cpu")
    series_err = compare_planner_series(plan, cpu_plan)
    log(f"[4 planner] card vs CPU runs of the same seeds, max |d| per series (relative for "
        f"cum_latency_ms): {json.dumps(series_err)} (tol {PLANNER_TOL})")

    set_counts(dict.fromkeys(COUNTED, 0))
    placed = drive_async("cuda", False, placement=pathplan.PlacementEngine(cooldown_ms=5000.0))
    torch.cuda.synchronize()
    place_counts = counts()
    place_want = async_launches_expected(placed, False)
    cpu_placed = drive_async("cpu", False, placement=pathplan.PlacementEngine(cooldown_ms=5000.0))
    log(f"[4 placement] replans (time_ms, trigger, moves): "
        f"{[(round(r[0], 3), r[1], len(r[2])) for r in placed['replans']]}")
    log(f"[4 placement] launches {json.dumps(place_counts)}, implied {json.dumps(place_want)}; "
        f"losses {[round(l, 5) for l in placed['losses']]}")
    if place_counts != place_want or not placed["replans"]:
        raise SystemExit(f"placement: launches {place_counts} differ from {place_want}, or no replan")
    if (placed["events"], placed["churn"], placed["replans"]) != (
            cpu_placed["events"], cpu_placed["churn"], cpu_placed["replans"]):
        raise SystemExit("placement: event, churn or replan logs differ from the CPU run")
    perr = compare("placement loss", placed["losses"], cpu_placed["losses"], PATH_TOL)
    log(f"[4 placement] event, churn and replan logs identical to the CPU run; loss max |d| {perr:.3e}")
    path_shapes = set(gpu["agg_shapes"]).union(*(r["agg_shapes"] for r in (*runs.values(), placed)))
    later = sorted(path_shapes - {(*sh, f32) for sh in level_shapes}, key=str)
    level_err = check_tree_aggregate(torch, ta, ref, later)
    max_err = max(max_err, level_err)
    log(f"[4 main path] tree_aggregate_groups bit-equal to its chain, max_abs_err={level_err:.3e} "
        f"over the async and placement runs' {len(later)} other (G, C, L, dtype): "
        f"{[(*sh[:3], str(sh[3])[6:]) for sh in later]}")

    marks.append(("4d", time.perf_counter()))
    # -- 4d. FedAvg / DP on the card, then the LM serving path ------------------
    fl_mod = drive_fl_modules(torch, ops, *gpu["live"])
    fl_want = {**dict.fromkeys(COUNTED, 0), "tree_aggregate_groups": 1}
    log(f"[4d fl modules] {json.dumps(fl_mod)} (TOL {TOL}; fedavg card vs CPU bit-equal)")
    if fl_mod["launches"] != fl_want or fl_mod["tree_aggregate_launches"] != 1:
        raise SystemExit(f"fl modules: launches {fl_mod['launches']} differ from {fl_want}, or "
                         f"the G = 1 call made {fl_mod['tree_aggregate_launches']}, not 1")
    g1_shape = (1, fl_mod["workers"], fl_mod["L"])
    g1_err = check_tree_aggregate(torch, ta, ref, [(*g1_shape, f32)])
    log(f"[4d fl modules] tree_aggregate at the phase's {g1_shape}: bit-equal to its chain, "
        f"max_abs_err={g1_err:.3e} against the plain version")
    lm_run = drive_lm(torch, smi)
    for name in ("tinyllama", "qwen3"):
        r = lm_run[name]
        log(f"[4d serve] {name} {r['layers']} layers {r['dtype']} B={LM_BATCH} prompt {LM_PROMPT} "
            f"+ {LM_GEN} generated: prefill {r['prefill_ms']:.3f} ms (first call "
            f"{r['first_run_prefill_ms']:.3f}), decode {r['decode_ms_per_token']:.3f} ms/token "
            f"(mean of decodes 2-{LM_GEN - 1}, host clock after synchronize); bound "
            f"{r['bound_ms_all_weights']:.4f} ms/token for {r['weight_bytes'] / 1e9:.4f} GB of "
            f"weights at {HBM_BYTES_PER_S / 1e12} TB/s ({r['bound_ms_decode_step']:.4f} ms for the "
            f"bytes a decode step reads); decode vs train forward max |d| "
            f"{r['decode_vs_forward_max_abs']:.4g} = {r['decode_vs_forward_rel']:.4g} of the largest "
            f"logit (bound {LM_BF16_REL}); init {r['init_s']:.1f} s; card: {smi}")
        log(f"[4d serve] {name} {json.dumps({k: v for k, v in r.items() if k != 'card'})}")
    log(f"[4d serve] tinyllama decode vs train forward with a planted fault, as a share of the "
        f"largest logit (each must exceed {LM_BF16_REL}; the sound run read "
        f"{lm_run['tinyllama']['decode_vs_forward_rel']:.4g}): "
        f"{json.dumps(lm_run['tinyllama_planted_faults'])}")
    log(f"[4d serve] tinyllama decode step under torch.profiler: "
        f"{json.dumps(lm_run['tinyllama_decode_profile'])}")
    log(f"[4d serve] f32, 2 layers, card vs CPU: {json.dumps(lm_run['f32_2layer'])} "
        f"(bound {LM_F32_REL} of the largest logit, TF32 {lm_run['allow_tf32']})")
    log(f"[4d serve] attention at the prefill shape: {json.dumps(lm_run['attention_at_prefill_shape'])}")
    log(f"[4d serve] bf16 GEMMs with allow_bf16_reduced_precision_reduction=False (default "
        f"{lm_run['default_bf16_rr']}); peak memory {lm_run['peak_mem_gb']:.2f} GB; launches "
        f"{json.dumps(lm_run['launches'])} (the serving path runs none of the seven kernels)")
    if lm_run["launches"] != dict.fromkeys(COUNTED, 0):
        raise SystemExit(f"serving path: launches {lm_run['launches']}, expected none")

    marks.append(("4e", time.perf_counter()))
    # -- 4e. the LM training path -----------------------------------------------
    with frozen_heap():  # 4e, 4f and 4g each with the heap of phases 1-4d frozen
        tr = drive_training(torch, smi, qz, ops, ref)
    a = tr["a_f32_card_vs_cpu"]
    log(f"[4e train a] tinyllama-1.1b full width, {TRAIN_F32_LAYERS} layers, f32, B="
        f"{TRAIN_F32_BATCH} S={TRAIN_F32_SEQ}, remat on, TF32 {tr['allow_tf32']}: logits within "
        f"{a['logits_rel']:.3g} of the largest (bound {LM_F32_REL}); loss card "
        f"{a['loss_card']:.7f} CPU {a['loss_cpu']:.7f}, rel {a['loss_rel']:.3g} (rtol "
        f"{TRAIN_LOSS_RTOL}); gradients within {a['grad_rel_max']:.3g} of each leaf's largest "
        f"(bound {TRAIN_GRAD_REL}); AdamW's update from the same inputs within "
        f"{a['adam_rel_max']:.3g} (bound {TRAIN_ADAM_REL})")
    log(f"[4e train a] {json.dumps(a)}")
    b = tr["b_flash_backward"]
    log(f"[4e train b] flash backward at {FLASH_SHAPE} (B, S, heads, head_dim), causal, chunks "
        f"of 512, against autograd of the plain forward in f32, share of each gradient's largest: "
        f"bf16 {json.dumps(b['bf16'])} (bound {FLASH_BF16_REL}), f32 {json.dumps(b['f32'])} "
        f"(bound {FLASH_F32_REL}); planted faults {json.dumps(b['faults'])}, the least "
        f"{b['fault_margin']:.3g}x over the bound; fwd+bwd _Flash {b['flash_fwd_bwd_ms']:.3f} ms, "
        f"SDPA {b['sdpa_fwd_bwd_ms']:.3f} ms (bf16, host included; a yardstick only)")
    c = tr["c_tinyllama"]
    log(f"[4e train c] tinyllama-1.1b {c['layers']} layers {c['dtype']} AdamW lr {c['lr']} remat "
        f"{c['remat']}, B={c['batch']} S={c['seq']}: losses {[round(x, 4) for x in c['losses']]}; "
        f"{c['ms_per_step']:.1f} ms/step (steps 2-{TRAIN_STEPS}, host clock after synchronize), "
        f"{c['tokens_per_s']:.0f} tokens/s, MFU {c['mfu']:.4f} ({c['model_flops_per_step']:.4g} "
        f"model FLOPs a step over {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16); peak memory "
        f"{c['peak_mem_gb']:.2f} GB; launches {json.dumps(c['launches'])}; card: {smi}")
    log(f"[4e train c] one step under torch.profiler: {json.dumps(c['profile'])}")
    log(f"[4e train c] {json.dumps({k: v for k, v in c.items() if k not in ('profile', 'card')})}")
    d = tr["d_podded_q8"]
    log(f"[4e train d] podded totoro_tree_q8, {d['pods']} pods, {d['steps']} steps: losses "
        f"{[round(x, 4) for x in d['losses']]}; {d['ms_per_step']:.1f} ms/step (steps 2-"
        f"{d['steps']}); launches {json.dumps(d['launches'])} ({d['leaves']} leaves a step); "
        f"aggregate within {d['agg_vs_mean_in_q_steps']:.4f} quantization steps of the pod mean; "
        f"kernels bit-equal to ref.quantize_ref / dequantize_ref on {d['hop_leaves_bit_equal']} of "
        f"{d['leaves']} leaves ({d['hop_rows_per_step']:,} rows), the gate failing on each planted "
        f"fault ({d['hop_fault_leaf']}: {json.dumps(d['hop_faults_caught'])}); "
        f"hop kernels {json.dumps(d['hop_kernels_ms'])} ms a step against a byte bound of "
        f"{d['hop_bound_ms']:.3f} ms ({sum(d['hop_bytes_per_step'].values()) / 1e9:.3f} GB over "
        f"{HBM_BYTES_PER_S / 1e12} TB/s), {d['hop_bound_ms_no_uniforms']:.3f} ms without the "
        f"uniforms' bytes; peak memory {d['peak_mem_gb']:.2f} GB; card: {smi}")
    log(f"[4e train d] {json.dumps({k: v for k, v in d.items() if k != 'profile'})}")
    log(f"[4e train d] one step under torch.profiler: {json.dumps(d['profile'])}")
    e = tr["e_checkpoint"]
    log(f"[4e train e] checkpoint at step {CKPT_STEPS}, {e['layers']} layers bf16: "
        f"{e['bytes_per_replica'] / 1e9:.3f} GB a replica, save {e['save_s']:.2f} s "
        f"({e['replicas']} replicas), restore after replica 0 was truncated {e['restore_s']:.2f} s; "
        f"restored bit-equal: {e['restored_bit_equal']}; next loss {e['next_loss_restored']!r} "
        f"restored vs {e['next_loss_uninterrupted']!r} uninterrupted (bit-equal: "
        f"{e['next_loss_bit_equal']})")

    marks.append(("4f", time.perf_counter()))
    # -- 4f. the MoE family: deepseek-v2-lite-16b ---------------------------------
    with frozen_heap():
        moe = drive_moe(torch, smi, qz, ops, ref)
    a = moe["a_f32_card_vs_cpu"]
    log(f"[4f moe a] {MOE_ARCH} full width, {a['layers']} layers, f32, B={TRAIN_F32_BATCH} "
        f"S={TRAIN_F32_SEQ}, remat on, TF32 {moe['allow_tf32']}: logits within "
        f"{a['logits_rel']:.3g} of the largest (bound {LM_F32_REL}); loss card {a['loss_card']:.7f} "
        f"CPU {a['loss_cpu']:.7f}, rel {a['loss_rel']:.3g}; aux card {a['aux_card']:.7f} CPU "
        f"{a['aux_cpu']:.7f}, rel {a['aux_rel']:.3g} (rtol {TRAIN_LOSS_RTOL}); gradients within "
        f"{a['grad_rel_max']:.3g} of each leaf's largest (bound {TRAIN_GRAD_REL}), routers "
        f"{json.dumps(a['router_grad_rel'])}; AdamW's update from the same inputs within "
        f"{a['adam_rel_max']:.3g} (bound {TRAIN_ADAM_REL}); {a['tokens_routed_differently']} of "
        f"{a['tokens_routed']} "
        f"token routings differ over {a['topk_calls']} top-k calls")
    log(f"[4f moe a] {json.dumps(a)}")
    strict = moe["b_decode_f32"]
    log(f"[4f moe b] {MOE_ARCH} full width, {strict['layers']} layers, f32, B={LM_BATCH} prompt "
        f"{LM_PROMPT} + {LM_GEN} generated, decode vs dropless train forward (the strict gate): "
        f"{strict['rel_all']:.4g} of the largest logit on all {LM_BATCH * LM_GEN} entries (bound "
        f"{MOE_F32_DECODE_REL}), {strict['flips']} of {strict['routing_flips']['routings']} routings "
        f"differing (none allowed); planted faults, each under its own flips "
        f"{json.dumps(strict['faults'])}")
    b = moe["b_serve"]
    dvf = b["decode_vs_forward"]
    log(f"[4f moe b] {MOE_ARCH} {b['layers']} layers {b['dtype']} B={LM_BATCH} prompt {LM_PROMPT} "
        f"+ {LM_GEN} generated: prefill {b['prefill_ms']:.3f} ms (first call "
        f"{b['first_run_prefill_ms']:.3f}), decode {b['decode_ms_per_token']:.3f} ms/token (mean "
        f"of decodes 2-{LM_GEN - 1}, host clock after synchronize); decode bounds "
        f"{b['bound_ms_decode_step']:.4f} ms reading all {b['num_experts']} experts a layer, "
        f"{b['bound_ms_routed_experts']:.4f} ms reading the routed ones (mean "
        f"{float(np.mean(b['experts_read_per_decode_step'][1:])) / b['moe_layers']:.2f} a layer); "
        f"decode vs dropless train forward {dvf['rel_no_flip']:.4g} of the largest logit on "
        f"the {dvf['decode_entries_no_flip_reaches']} of {LM_BATCH * (LM_GEN - 1)} decode entries "
        f"no routing flip reaches (bound {LM_BF16_REL}, at least {MOE_BF16_MIN_CLEAN} entries; "
        f"{dvf['rel_all']:.4g} on all), {dvf['flips']} routings differing (at most "
        f"{MOE_BF16_MAX_FLIPS}) {json.dumps(dvf['routing_flips'])}; planted faults, each under "
        f"its own flips {json.dumps(dvf['faults'])}; idle "
        f"{b['decode_profile']['device_idle_share']:.3f}; peak {b['peak_mem_gb']:.2f} GB; init "
        f"{b['init_s']:.1f} s; card: {smi}")
    log(f"[4f moe b] {json.dumps({k: v for k, v in b.items() if k != 'card'})}")
    c = moe["c_train"]
    log(f"[4f moe c] {MOE_ARCH} {c['layers']} layers {c['dtype']} AdamW lr {c['lr']} remat "
        f"{c['remat']} ({c['remat_policy']}), B={c['batch']} S={c['seq']}: losses "
        f"{[round(x, 4) for x in c['losses']]}, aux {[round(x, 4) for x in c['auxes']]}; "
        f"{c['ms_per_step']:.1f} ms/step (steps 2-{TRAIN_STEPS}), {c['tokens_per_s']:.0f} "
        f"tokens/s, MFU {c['mfu']:.4f} on {c['params_total_active'][1]:,} active of "
        f"{c['params_total_active'][0]:,} parameters ({c['model_flops_per_step']:.4g} model "
        f"FLOPs a step); peak memory {c['peak_mem_gb']:.2f} GB; idle "
        f"{c['profile']['device_idle_share']:.3f}; card: {smi}")
    log(f"[4f moe c] one step under torch.profiler: {json.dumps(c['profile'])}")
    log(f"[4f moe c] {json.dumps({k: v for k, v in c.items() if k not in ('profile', 'card')})}")
    log(f"[4f moe c] remat on vs off, {MOE_REMAT_LAYERS} layers: {json.dumps(moe['c_remat'])}")
    share = moe["c_route"]
    log(f"[4f moe c] one MoE FFN at the training shape, fwd + bwd (eager, CUDA events): "
        f"{json.dumps(share)}; its two FFNs' routing (once each way) "
        f"{2 * share['route'] / c['ms_per_step']:.3f} of a step")
    d = moe["d_podded_q8"]
    log(f"[4f moe d] podded totoro_tree_q8, {MOE_ARCH} {d['layers']} layers, {d['pods']} pods, "
        f"{d['steps']} steps: losses {[round(x, 4) for x in d['losses']]}; "
        f"{d['ms_per_step']:.1f} ms/step (steps 2-{d['steps']}); launches "
        f"{json.dumps(d['launches'])} ({d['leaves']} leaves a step); aggregate within "
        f"{d['agg_vs_mean_in_q_steps']:.4f} quantization steps of the pod mean; "
        f"kernels bit-equal to ref.quantize_ref / dequantize_ref on {d['hop_leaves_bit_equal']} of "
        f"{d['leaves']} leaves ({d['hop_rows_per_step']:,} rows), the gate failing on each planted "
        f"fault ({d['hop_fault_leaf']}: {json.dumps(d['hop_faults_caught'])}); "
        f"hop kernels {json.dumps(d['hop_kernels_ms'])} ms a step against a byte bound of "
        f"{d['hop_bound_ms']:.3f} ms ({d['hop_bound_ms_no_uniforms']:.3f} without the uniforms); "
        f"peak memory {d['peak_mem_gb']:.2f} GB; card: {smi}")
    log(f"[4f moe d] {json.dumps({k: v for k, v in d.items() if k != 'profile'})}")
    log(f"[4f moe d] one step under torch.profiler: {json.dumps(d['profile'])}")

    marks.append(("4g", time.perf_counter()))
    # -- 4g. the recurrent families: rwkv6-7b, jamba's Mamba layer ------------------
    with frozen_heap():
        rec = drive_recurrent(torch, smi, qz, ops, ref)
    a = rec["a_rwkv_f32"]
    log(f"[4g recurrent a] {RWKV_ARCH} full width, {a['layers']} layers, f32, B={TRAIN_F32_BATCH} "
        f"S={TRAIN_F32_SEQ}, remat on, TF32 {rec['allow_tf32']}: logits within "
        f"{a['logits_rel']:.3g} of the largest (bound {LM_F32_REL}); loss card {a['loss_card']:.7f} "
        f"CPU {a['loss_cpu']:.7f}, rel {a['loss_rel']:.3g} (rtol {TRAIN_LOSS_RTOL}); gradients "
        f"within {a['grad_rel_max']:.3g} of each leaf's largest (bound {TRAIN_GRAD_REL}); AdamW's "
        f"update from the same inputs within {a['adam_rel_max']:.3g} (bound {TRAIN_ADAM_REL}); "
        f"planted fault "
        f"{json.dumps(a['planted_fault'])}")
    log(f"[4g recurrent a] {json.dumps(a)}")
    a = rec["a_mamba_layer_f32"]
    log(f"[4g recurrent a] {JAMBA_ARCH} ('mamba', 'dense') layer at full width (d "
        f"{a['d_model']}, d_inner {a['d_inner']}, {a['params']:,} parameters), f32, B="
        f"{TRAIN_F32_BATCH} S={TRAIN_F32_SEQ}: output within {a['out_rel']:.3g} of the largest "
        f"(bound {LM_F32_REL}); gradients within {a['grad_rel_max']:.3g} of each one's largest "
        f"(bound {TRAIN_GRAD_REL}); planted fault {json.dumps(a['planted_fault'])}")
    log(f"[4g recurrent a] {json.dumps(a)}")
    a = rec["a_jamba_reduced"]
    log(f"[4g recurrent a] {JAMBA_ARCH} reduced ({a['layers']} layers, d {a['d_model']}), f32, "
        f"prefill + {LM_GEN - 1} decodes card vs CPU: logits within {a['logits_rel']:.3g}, cache "
        f"within {a['cache_rel_max']:.3g} (bound {LM_F32_REL}), {a['tokens_differ']} tokens differ; "
        f"planted fault {json.dumps(a['planted_fault'])}")
    b = rec["b_serve"]
    log(f"[4g recurrent b] {RWKV_ARCH} {b['layers']} layers {b['dtype']} ({b['params_total']:,} "
        f"parameters, {b['weight_bytes'] / 1e9:.3f} GB) B={LM_BATCH} prompt {LM_PROMPT} + {LM_GEN} "
        f"generated: prefill {b['prefill_ms']:.3f} ms (first call {b['first_run_prefill_ms']:.3f}), "
        f"decode {b['decode_ms_per_token']:.3f} ms/token (mean of decodes 2-{LM_GEN - 1}, host "
        f"clock after synchronize); bound {b['bound_ms_decode_step']:.4f} ms for the "
        f"{b['decode_read_bytes'] / 1e9:.3f} GB a decode step reads at {HBM_BYTES_PER_S / 1e12} "
        f"TB/s; constant-at-init leaves redrawn from seed {b['leaf_seed']}; decode vs train "
        f"forward, f32 {json.dumps(b['decode_vs_forward_f32'])}, bf16 (not gated) "
        f"{json.dumps(b['decode_vs_forward_bf16'])}; idle "
        f"{b['decode_profile']['device_idle_share']:.3f}, "
        f"{b['decode_profile']['device_ops_per_step']:.0f} device ops a step; peak "
        f"{b['peak_mem_gb']:.2f} GB; init {b['init_s']:.1f} s; card: {smi}")
    log(f"[4g recurrent b] {json.dumps({k: v for k, v in b.items() if k != 'card'})}")
    c = rec["c_train"]
    log(f"[4g recurrent c] {RWKV_ARCH} {c['layers']} layers {c['dtype']} AdamW lr {c['lr']} remat "
        f"{c['remat']} ({c['remat_policy']}), B={c['batch']} S={c['seq']}: losses "
        f"{[round(x, 4) for x in c['losses']]}; {c['ms_per_step']:.1f} ms/step (steps 2-"
        f"{TRAIN_STEPS}), {c['tokens_per_s']:.0f} tokens/s, MFU {c['mfu']:.4f} on "
        f"{c['params_total_active'][0]:,} parameters (6 N T; the chunked wkv core's FLOPs left "
        f"out); peak memory {c['peak_mem_gb']:.2f} GB; idle "
        f"{c['profile']['device_idle_share']:.3f}; card: {smi}")
    log(f"[4g recurrent c] one step under torch.profiler: {json.dumps(c['profile'])}")
    log(f"[4g recurrent c] {json.dumps({k: v for k, v in c.items() if k not in ('profile', 'card')})}")
    log(f"[4g recurrent c] remat on vs off, {RWKV_REMAT_LAYERS} layers: {json.dumps(rec['c_remat'])}")
    d = rec["d_podded_q8"]
    log(f"[4g recurrent d] podded totoro_tree_q8, {RWKV_ARCH} {d['layers']} layers, {d['pods']} "
        f"pods, {d['steps']} steps: losses {[round(x, 4) for x in d['losses']]}; "
        f"{d['ms_per_step']:.1f} ms/step (steps 2-{d['steps']}); launches "
        f"{json.dumps(d['launches'])} ({d['leaves']} leaves a step); aggregate within "
        f"{d['agg_vs_mean_in_q_steps']:.4f} quantization steps of the pod mean; "
        f"kernels bit-equal to ref.quantize_ref / dequantize_ref on {d['hop_leaves_bit_equal']} of "
        f"{d['leaves']} leaves ({d['hop_rows_per_step']:,} rows), the gate failing on each planted "
        f"fault ({d['hop_fault_leaf']}: {json.dumps(d['hop_faults_caught'])}); "
        f"hop kernels {json.dumps(d['hop_kernels_ms'])} ms a step against a byte bound of "
        f"{d['hop_bound_ms']:.3f} ms ({d['hop_bound_ms_no_uniforms']:.3f} without the uniforms); "
        f"peak memory {d['peak_mem_gb']:.2f} GB; card: {smi}")
    log(f"[4g recurrent d] {json.dumps({k: v for k, v in d.items() if k != 'profile'})}")
    log(f"[4g recurrent d] one step under torch.profiler: {json.dumps(d['profile'])}")
    log(f"[4g recurrent e] {JAMBA_ARCH} Mamba sublayer at full width, fwd + bwd (eager, CUDA "
        f"events): {json.dumps(rec['e_mamba'])}; card: {smi}")

    marks.append(("4h", time.perf_counter()))
    # -- 4h. the encoder-decoder family: seamless-m4t-medium ------------------------
    with frozen_heap():
        enc = drive_encdec(torch, smi, qz, ops, ref)
    log_encdec(enc, smi)

    marks.append(("4i", time.perf_counter()))
    # -- 4i. the podded step with one pod per rank: tinyllama-1.1b ----------------
    pods = drive_pod_ranks(torch, smi, tr["d_podded_q8"])
    log_pod_ranks(pods, smi)

    marks.append(("4j", time.perf_counter()))
    # -- 4j. the dense family's step sharded over (data, model): tinyllama-1.1b --
    sharded = drive_shard_ranks(torch, smi, shard_plain_losses(torch))
    log_shard_ranks(sharded, smi)

    marks.append(("4k", time.perf_counter()))
    # -- 4k. the dry-run of 4j b's cell, held to 4j; the production mesh's ----
    log_dryrun(drive_dryrun(smi, sharded), smi)

    marks.append(("5", time.perf_counter()))
    # -- 5. times -------------------------------------------------------------
    f32_levels = sorted({sh[:3] for sh in path_shapes if sh[3] == f32})  # sync, async, placement
    rows = [time_tree_aggregate(torch, ta, ref, g, c, l, f32) for g, c, l in f32_levels]
    main_row = max(rows, key=lambda r: r["bytes"])  # the main path's largest level
    worst_row = max(rows, key=lambda r: r["kernel_over_library"])
    rows += [  # the kernel bench's shape, then a streaming size far past L2
        time_tree_aggregate(torch, ta, ref, 1, 16, 131072, bf16),
        time_tree_aggregate(torch, ta, ref, 1, 16, 131072, f32),
        time_tree_aggregate(torch, ta, ref, 1, 16, 1 << 22, bf16),
        time_tree_aggregate(torch, ta, ref, 1, 16, 1 << 22, f32),
    ]
    bench_row = rows[-4]  # (1, 16, 131072) bf16: kernel 2's bench shape
    g1_row = time_tree_aggregate(torch, ta, ref, *g1_shape, f32)  # phase 4d's G = 1 call
    log(f"[5 times] tree_aggregate (G = 1, phase 4d) {json.dumps(g1_row)}")
    for r in rows:
        log(f"[5 times] tree_aggregate_groups {json.dumps(r)}")
    comp_rows = {R: time_compression_kernels(torch, qz, bc, ta, ref, R) for R in (27, 4096, 65536)}
    for R, by_kernel in comp_rows.items():
        for name, r in by_kernel.items():
            log(f"[5 times] {name} R={R} {json.dumps(r)}")
    prof = profile_rounds(torch, *gpu["live"])
    log(f"[5 times] quickstart round under torch.profiler: {json.dumps(prof)}")
    rms = gpu["round_ms"]
    log(f"[5 times] quickstart round ms (host clock to synchronize): first={rms[0]:.3f} "
        f"steady_mean={float(np.mean(rms[1:9])):.3f} all={[round(t, 3) for t in rms]}")
    aprof = time_async(torch)
    log(f"[5 times] compressed async applies: {json.dumps(aprof)}")
    largest_leaf = max(n for n, _ in leaf_cases)
    # one local step of the 16-worker apps: the MLP's six leaves, the CNN's three
    mlp_table = max((t for t in path_tables if len(t) == 6), key=sum)
    cnn_table = max((t for t in path_tables if len(t) == 3), key=sum)
    fused_rows = [
        time_fused_table(torch, fu, ref, "mlp-step", mlp_table, 0.2, 0.01),  # the sync path's
        time_fused_table(torch, fu, ref, "cnn-step", cnn_table, 0.1, 0.0),   # the CNN app's
        time_fused_update(torch, fu, ref, largest_leaf, f32),
        time_fused_update(torch, fu, ref, largest_leaf, f32, mu=0.0),
        time_fused_update(torch, fu, ref, 1 << 17, bf16),
        time_fused_update(torch, fu, ref, 1 << 24, f32),
        time_fused_update(torch, fu, ref, 1 << 24, f32, mu=0.0),
    ]
    for r in fused_rows:
        log(f"[5 times] fused_update {json.dumps(r)}")
    big0 = fused_rows[-1]
    log(f"[5 times] fused_update at 2^24 f32, mu = wd = 0: kernel {big0['ms'] * 1e3:.2f} us, "
        f"torch.add(w, g, alpha=-lr) {big0['library_ms'] * 1e3:.2f} us in turns (a b b a, twice); "
        f"ratio {big0['kernel_over_library']:.4f}")
    policy_rows = [time_policy_update(torch, pu, ref, pathplan, N, K, masks)
                   for N, K in ((128, 8), (4096, 16), (10_000, 16), (1_000_000, 16), (128, 36))
                   for masks in ("ones", "partial")]
    for r in policy_rows:
        log(f"[5 times] policy_update {json.dumps(r)}")
    for N in (128, 10_000):
        log(f"[5 times] planner episodes: {json.dumps(time_planner(torch, N))}")
    log(f"[5 times] card: {smi}")

    path = comp_rows[27]
    int8_row = {k: path["tree_aggregate_groups_int8"][k]
                for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "einsum_of_widened_ms")}
    KERNELS[0].update(
        launches=launches + sum(c["tree_aggregate_groups"] for c in async_counts.values())
        + place_counts["tree_aggregate_groups"] + fl_mod["launches"]["tree_aggregate_groups"],
        max_abs_err=max(max_err, comp_err["tree_aggregate_groups_int8"]), ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=main_row["library_ms"], shape=main_row["shape"],
        kernel_over_library=main_row["kernel_over_library"],
        worst_level={k: worst_row[k] for k in ("shape", "ms", "library_ms", "kernel_over_library")},
        int8=dict(int8_row, launches=async_counts["compressed"]["tree_aggregate_groups"]),
    )
    KERNELS[1].update(  # phase 4d's check of fedavg: no path of the port calls it
        launches=fl_mod["tree_aggregate_launches"], launches_from="phase 4d check of fedavg",
        max_abs_err=max(max_err, g1_err),
        ms=g1_row["ms"], plain_ms=g1_row["plain_ms"], bound_ms=g1_row["bound_ms"],
        bound_by=g1_row["bound_by"], library_ms=g1_row["library_ms"], shape=g1_row["shape"],
        bench={k: bench_row[k] for k in ("shape", "dtype", "ms", "plain_ms", "bound_ms", "library_ms")},
    )
    brief = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for entry in KERNELS[2:5]:  # launches: both compressed runs of phase 4b
        name = entry["name"]
        r = path[name]
        entry.update(
            launches=sum(async_counts[t][name] for t in ("compressed", "compressed-qsgd-downlink")),
            max_abs_err=comp_err[name], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            larger={R: {k: comp_rows[R][name][k] for k in brief} for R in (4096, 65536)},
        )
    hops = {"4e d": tr["d_podded_q8"], "4f d": moe["d_podded_q8"], "4g d": rec["d_podded_q8"],
            "4h d": enc["d_podded_q8"]}
    for entry in KERNELS[2:4]:  # phases 4e d to 4h d: the podded steps' cross-pod hop
        name = entry["name"]
        entry["launches_from"] = {"4b compressed async runs": entry["launches"],
                                  **{f"{tag} podded q8 train steps ({h['arch']}, {h['layers']} "
                                     f"layers)": h["launches"][name] for tag, h in hops.items()}}
        entry["launches"] += sum(h["launches"][name] for h in hops.values())
        entry["q8_hop"] = {tag: dict(
            arch=h["arch"], layers=h["layers"], launches=h["launches"][name],
            launches_per_step=h["leaves"], hop_kernel_ms_per_step=h["hop_kernels_ms"][name],
            hop_bound_ms_per_step=h["hop_bytes_per_step"][name] / HBM_BYTES_PER_S * 1e3,
            hop_bound_ms_per_step_no_uniforms=(
                h["hop_bytes_per_step_no_uniforms"][name] / HBM_BYTES_PER_S * 1e3),
            timed_leaf=h["timed_leaf"], timed_rows={k: h["timed_rows"][name][k] for k in brief})
            for tag, h in hops.items()}
    for entry in KERNELS[2:4]:  # phase 4i: the same hop over a process group, per rank
        name = entry["name"]
        per_rank = [r[name] for r in pods["launches_per_rank"]]
        entry["launches_from"][f"4i per-rank podded q8 train steps ({pods['arch']}, "
                               f"{pods['layers']} layers, {pods['ranks']} ranks on one card)"] = sum(per_rank)
        entry["launches"] += sum(per_rank)
        entry["q8_hop"]["4i"] = dict(
            arch=pods["arch"], layers=pods["layers"], ranks=pods["ranks"],
            launches_per_rank=per_rank, launches_per_rank_per_step=pods["leaves"],
            hop_split_ms_per_step_per_rank=pods["hop_split_ms_per_rank"],
            note="two ranks sharing one card, host clock between synchronizes")
    KERNELS[2]["residual_instance"] = dict(  # the EF commits' launches, counted in both
        launches=sum(async_counts[t]["qsgd_quantize_residual"]
                     for t in ("compressed", "compressed-qsgd-downlink")),
        max_abs_err=comp_err["qsgd_quantize_residual"],
        rows={R: {k: comp_rows[R]["qsgd_quantize_residual"][k] for k in brief}
              for R in (27, 4096, 65536)})
    step = fused_rows[0]  # one MLP local step's table, the launch the paths make most
    KERNELS[5].update(
        launches=sum(c["fused_update"] for c in (sync_counts, *async_counts.values(), place_counts)),
        max_abs_err=fused_err, ms=step["ms"], plain_ms=step["plain_ms"],
        bound_ms=step["bound_ms"], bound_by=step["bound_by"],
        library_ms=None,  # no one call at mu = 0.01; at mu = wd = 0, torch._foreach_add / torch.add:
        library_ms_mu0_wd0={"cnn-step": fused_rows[1]["library_ms"], "2^24": big0["library_ms"]},
        shape=step["shape"], leaves=step["leaves"],
    )
    demo = policy_rows[0]  # the demo's (128, 8, 17) on the planners' all-ones masks
    KERNELS[6].update(
        launches=plan_counts["policy_update"], max_abs_err=policy_err, ms=demo["ms"],
        plain_ms=demo["plain_ms"], bound_ms=demo["bound_ms"], bound_by=demo["bound_by"],
        library_ms=None, shape=demo["shape"], masks=demo["masks"],
    )
    idle = [e["name"] for e in KERNELS if not e["launches"]]
    if idle:
        raise SystemExit(f"kernels of the main paths launched no time there: {idle}")
    marks.append(("end", time.perf_counter()))
    log(f"[walls] s a phase: {json.dumps({a: round(tb - ta, 1) for (a, ta), (_, tb) in zip(marks, marks[1:])})}, "
        f"{marks[-1][1] - marks[0][1]:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": KERNELS}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
