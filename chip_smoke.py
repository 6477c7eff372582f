#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, block-sparse attention,
tensor-parallel serving and training (with sequence parallelism,
ZeRO-Infinity, the ladder models and AutoTP), ladder-model (BERT, ResNet,
OPT), offload, ZeRO-Infinity and sequence-parallel paths on one NVIDIA
GPU and hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero:

1. ``build``    — nvcc builds the kernels from ``deepspeed_tpu_torch/csrc``;
   registers and spills per kernel family, and the tensor-core
   instructions (``HMMA``) of each family in ``cuobjdump -sass``: the
   16-bit flash, decode and block-sparse families (``MMA_FAMILIES``) must
   hold some, and none of them may spill.
2. ``kernels``  — one line per decode kernel: the kernel against its plain
   version at every shape the main path gives it (32/8 heads, d 128, pages
   of 16; B 8 over up to 2048 keys with ragged lengths and window None and
   512, as served; B 4 over generate's 256 + 32 keys), bf16 and fp32 (and
   fp16 at the serving shape); then timed with CUDA events (calls queued
   back to back behind a GPU sleep so the host's overhead is hidden, median
   and range over 7 reps, inputs rotated over more than the 50 MB L2)
   beside its plain version, a PyTorch library yardstick and its bound (K/V
   bytes over 3.35 TB/s); then the decode kernel checked and timed at the
   shape v1 ``generate`` gives it (B 4, 257-288 keys) and the paged kernel
   at a serve decode step (``SERVE_STEP_LENGTHS``).
3. ``kernels``  — one line per flash kernel (forward, dq pass, dk/dv pass):
   against its plain version at every ``FLASH_CASES`` shape, bf16, fp16
   (both on the tensor-core kernels) and fp32 (the fp32-FMA kernels), and
   the backward passes on the random-``out`` regime (``regime_inputs``:
   delta far from dP, dead rows at lse 1e30; bf16 and fp16, d 64 and 128,
   four seeds), then timed the same way at the two training shapes in
   bf16 beside its plain version, SDPA and its bound (causal flops over
   989 TFLOP/s), and in fp16 beside SDPA.  The decode and block-sparse
   kernels are also held in fp16 at one shape each.
4. ``serve``    — Llama-3-8B at full width and depth (bf16, random weights
   from a seed) behind ``build_serving_frontend``: 8 requests of mixed
   classes, two sharing a 512-token header.  Every handle must return its
   budget, the prefix cache must hit, and the paged kernel must launch
   ``num_layers`` times per decode step.  Then ``serve_trace``: one
   ``torch.profiler`` trace of three decode bursts of a v2 engine on the
   same weights (8 slots of 512-token prompts): the shares of device time
   in the paged kernel, in cuBLAS and in the rest, and the device's idle
   share between the window's first and last device event.
5. ``generate`` — ``init_inference(...).generate`` on the same weights,
   ``[4, 256]`` prompts, 32 new tokens: ``32 x 31`` decode-kernel launches.
6. ``agree``    — a narrow fp32 model: v2 greedy tokens equal v1 greedy
   tokens (both through the kernels) and the CPU plain path's tokens.
7. ``train``    — ``initialize`` + 12 ``train_step``s of bench.py's
   headline (12 x 768, 12/12 heads, V 32000, bf16 on fp32 masters, AdamW
   lr 1e-4, ZeRO 0, remat, flash attention) on a repeated ``[8, 2048]``
   batch of random ids: a finite, falling loss, the flash launches of the
   formula (forward 2 L per step under remat, each backward pass L), the
   median step time of CUDA events after the first, tokens/s, MFU (6N +
   12 L S H flops per token over 989 TFLOP/s) and peak memory.
8. ``train_8b_width`` — the same at Llama-3-8B widths, 4 of its 32 layers
   (fp32 masters, grads and Adam moments of all 32 would need ~128 GB),
   ``[1, 2048]``, 5 steps.
9. ``train_agree`` — a narrow fp32 GQA model: five steps through the
   kernels give the CPU plain path's loss and grad-norm sequences to 1e-4;
   then a narrow fp32 Mixtral with ``kernels.fused_adam``: the same against
   the CPU, and fused against unfused on the card to 1e-6.

The Mixtral slice adds:

- ``kernels`` lines for the MoE dispatch and combine kernels, against their
  plain versions at the train shape (T 2048, E 8, C 1024, H 4096) and the
  serve-prefill shape (T 512, C 256), bf16 and fp32, with empty slots and
  dropped assignments (dispatch exact), and for the multi-tensor gradient
  norm and fused Adam over the Mixtral-train parameter list (3.17 B fp32
  elements; an AdamW and an L2 Adam step, moments and parameters
  bit-equal); each timed as above beside its
  plain version, a one-call library yardstick and its bound;
- ``serve_moe``: Mixtral-8x7B widths, 24 of 32 layers, bf16, behind
  ``build_serving_frontend`` with the serve phase's knobs and requests:
  every budget returned, dispatch and combine ``num_layers`` times a
  prefill call and never in a decode burst (T 8 is the dense rung), the
  paged kernel ``num_layers`` times a decode step;
- ``generate_moe``: ``init_inference(...).generate`` on the same weights,
  ``[4, 256]`` + 32: dispatch and combine ``num_layers`` times (the one
  prefill), the decode kernel ``num_layers x 31`` times;
- ``agree_moe``: a narrow fp32 Mixtral (E 4, top-2, capacity factor 2: no
  drops) on the kernel rung: v2 greedy == v1 greedy == the CPU's;
- ``train_moe``: Mixtral-8x7B widths, 2 layers, ``[1, 2048]``, bf16 on
  fp32 masters, AdamW lr 1e-4, ``kernels.fused_adam``, flash, remat, 5
  steps: a finite, falling loss; per step dispatch and combine 2 L times,
  the norm and Adam once each; MFU counts the top-2 experts.

The block-sparse slice adds:

- ``sparse_kernels``: one ``kernels`` line per block-sparse kernel
  (forward, dq pass, dk/dv pass), against its plain version over a grid of
  every layout family (BigBird, Fixed, BSLongformer, Variable, EmptyTail
  with rows that attend nothing), cells of 16 to 256 tokens, shared and
  per-head layouts, causal and not, d 64 and 128, S 272 (a ragged tile) to
  4096, bf16 and fp32 (and fp16 on the first case; bf16 and fp16 run the
  tensor-core kernels, fp32 the FMA ones), the backward passes also on
  the random-``out`` regime over two layouts (``SPARSE_REGIME``); then
  timed at the training shape (B 2, S 4096, h 16, d 64, BigBird cells of
  128, causal, bf16) beside its plain version, SDPA with the boolean token
  mask and its bound (the live token pairs' flops over 989 TFLOP/s
  against the bytes over 3.35 TB/s);
- ``sparse``: ``sparse_attention(impl="auto")`` forward and backward
  through autograd at bench.py's shapes (S 4096 to 8192), a per-head layout
  at Llama-3-8B's attention width (h 32, d 128), S 32768 and a Fixed layout
  whose route is the dense path: one line per case with its route, coarse
  and token live fractions, launches (the forward kernel once a kernel-route
  call, each backward kernel once a backward; none on the dense route),
  errors against the plain versions (in chunks of query rows), and its
  times beside the dense masked path (the H100's crossover) and, for the
  S 8192 window sweep, the port's flash attention.

The tensor-parallel slice adds:

- ``quant_kernels``: the int8 quantizer against its plain version,
  exactly, at the CPU tests' shapes and a Llama-3-8B FFN weight, in fp32,
  bf16 and fp16; timed at ``[14336, 4096]`` bf16 beside its plain version
  and its bound (bytes); then its path: the weight matrices of a one-layer
  Llama-3-8B quantized through ``quantize_int8`` and back, within
  bench.py's round-trip bound;
- ``tp_kernels``: #2b in one process: each rank's head block (``tp`` 2)
  of the paged kernel's serving shapes through
  ``paged_decode_attention_tp``, bit-equal to those heads of the unsharded
  kernel; timed beside its plain version and half of #2's bound;
- ``serve_tp`` and ``generate_tp`` (one launch): Llama-3-8B at full width
  and ``SERVE_TP_LAYERS`` (1) of its 32 layers, bf16, ``tp=2``: two
  ranks that share card 0 over gloo through the host (NCCL needs one card
  per rank), spawned by ``launcher.local.launch``; every budget returned,
  both ranks' tokens equal, #2b ``L`` times a decode step and the decode
  kernel ``L x 31`` times on each rank.  Their times are gloo through the host, two ranks
  on one card: not a TP speed;
- ``agree_tp``: Llama-3-8B widths at 2 layers, ``tp=2`` against ``tp=1``:
  fp32 greedy tokens (v2 and v1) equal and logits within 1e-4; bf16
  logits no further from the fp32 ones than ``BF16_TP_SLACK`` times the
  bf16 ``tp=1`` logits are, the token agreement reported.

The checkpoint slice adds ``train_ckpt``: bench.py's headline fed by
``initialize(training_data=...)`` (a token dataset from the seed): a sync
save at step 3 resumed in a fresh engine gives steps 4-6 of the unbroken
run bit for bit; an async save, two steps on, and the loaded state is the
one at the save; two gloo ranks on card 0 at stage 3 with fused Adam save,
one process at stage 0 loads their slices bit for bit (sha256), trains on
and ``zero_to_fp32`` counts every parameter; a seqlen curriculum (256 to
2048) sets the batch lengths and the flash launches.  Each rank file is
held within 2 % of its predicted payload (12 bytes an element); save and
load seconds are printed beside the card.

The expert-parallel slice adds:

- a ``kernels`` line ``moe_dispatch_ep``: #11 at one rank's view of
  train_moe_ep's global routing (2 ranks' 2048 tokens, C 2048: every
  other rank's slot empty), ranks 0 and 1, bf16 and fp32, dispatch exact
  and #12 within its tolerance; timed beside its plain version,
  ``index_select`` and its bound;
- ``train_moe_ep``: Mixtral-8x7B widths, 1 layer, bf16 on fp32 masters,
  ``moe.expert_parallel_size`` 2 in two ranks on card 0 over gloo (4 of
  the 8 experts a rank, ``[1, 2048]`` a rank, fused Adam, 2 steps):
  finite falling losses and one ``l_aux`` on both ranks, the launch
  formula on each, each rank's state bytes to the byte of the prediction;
- ``train_moe_ep_agree``: Mixtral-8x7B widths at 1 layer in fp32 on one
  ``[4, 512]`` batch: one process, then ep 2 (ZeRO 0, 2 rows a rank) to
  1e-4; the ep-2 ranks' save of a narrow fp32 Mixtral loads in one
  process bit for bit;
- ``serve_moe_tp`` and ``generate_moe_tp`` (one launch): Mixtral-8x7B at
  1 layer, bf16, ``tp=2`` over gloo, serve_moe's requests: budgets, both
  ranks' tokens equal, #2b ``L`` a decode step, #11/#12 ``L`` a prefill
  call, decode ``L x 31`` in generate;
- ``agree_moe_tp``: Mixtral-8x7B widths at 1 layer, ``tp=2`` against
  ``tp=1`` as ``agree_tp``.

The ladder-model slice adds:

- in ``kernels``, the rows ``decode_attention_opt`` and
  ``paged_decode_attention_opt``: #1 and #2 at OPT-1.3B's multi-head
  shape (32/32 heads, d 64: n_rep 1) over ``CHECKS``' lengths, bf16 and
  fp32, timed at B 8 x 2048 keys beside their plain versions, SDPA (#1)
  and the byte bound;
- in ``flash_kernels``, the ``bert`` case (B 8, h 16, d 64, S 512,
  non-causal, a pad tail of 0-200 a row as segment ids, row 0 without):
  all three kernels in bf16, fp16 and fp32, the backward passes on a
  random ``out`` there (``hold_bert_regime``), and timed beside SDPA with
  the same-segment boolean mask and the bound of the live pairs;
- ``train_bert``: BERT-large (24 x 1024, 16 heads, S 512) at ``[8, 512]``,
  bf16 on fp32 masters, flash, AdamW, ZeRO 0, 8 steps on an MLM batch (15 %
  of the real tokens labelled): a finite, falling loss, the flash
  launches of the formula, step time, tokens/s, MFU and peak memory;
- ``train_bert_zero``: BERT-large widths at 1 layer in two gloo ranks on
  card 0, ZeRO 0, 1 and 2, 2 steps each: losses equal across ranks and
  stages, each rank's state bytes those of the placement rule;
- ``train_resnet``: ResNet-56 on a fixed ``[128, 32, 32, 3]`` batch, bf16
  on fp32 masters, Adam lr 1e-3, 12 steps: a falling loss, step time and
  images/s (plain PyTorch: no kernel of the port may launch);
- ``serve_opt`` / ``generate_opt``: OPT-1.3B at full width and depth,
  bf16, behind ``build_serving_frontend`` with ``serve``'s requests (the
  paged kernel 24 a decode step) and v1 ``[4, 256]`` + 32 (the decode
  kernel 24 x 31);
- ``agree_opt``: fp32 OPT-1.3B widths at 4 layers: v2 greedy == v1
  greedy == the CPU's.

The offload and Infinity slice adds:

- in ``flash_kernels``, the ``70b`` case (B 2, h 64, d 128, S 2048,
  causal: Llama-3-70B's attention in a streamed layer) in all three dtypes,
  timed beside SDPA and the bound;
- ``train_infinity``: Llama-3-70B widths at ``INF_LAYERS`` (3) of 80
  layers (more than the trunk's two device buffers; the phase fails if the
  host's ``MemAvailable`` cannot hold their planes), in a process of its
  own, bf16, flash, the cpu
  tier through ``initialize`` with ``offload_param``, ``[2, 2048]``, 2
  steps: finite falling losses, the trunk's two device buffers exactly
  ``INF_PEAK_PARAM_BYTES``, no trunk leaf on the card, the peak allocation
  under the resident state plus the activations and 80 GB, the flash
  launches ``2 L`` / ``L`` / ``L`` a step; step time, one profiled step's
  device idle share, host memory and thread counts;
- ``train_infinity_nvme``: Llama-3-8B widths at 3 layers on the nvme tier
  (files under ``build/nvme_smoke``, a ring of 2 slots), gas 2 with
  clipping, 2 steps, beside the cpu tier: losses, grad norms and every
  master equal; disk bytes a step, GB/s and the O_DIRECT split;
- ``train_infinity_agree``: 8B widths at 2 fp32 layers: streamed within
  2e-4 of the on-device engine, pipelined == serial bit for bit;
- ``train_offload``: ZeRO-Offload at 8B widths, 4 layers, the bf16 wire:
  losses, host state 12 B a parameter, the peak below ``train_8b_width``'s
  and the step's split;
- in ``train_zero``, the headline at ZeRO-2 with ``offload_optimizer`` in
  the two ranks: each rank's host state its chunk to the byte, losses
  equal to one process's with a rank's rows a microbatch.

The sequence-parallel slice adds:

- in ``flash_kernels``, the ``sp`` case (B 1, h 16, d 128, S 8192,
  causal: train_sp's Ulysses shape, the full sequence on 32/2 heads) in
  all three dtypes, timed beside SDPA and the bound;
- ``train_sp``: Llama-3-8B widths at ``SP_LAYERS`` (2) of 32 layers,
  ``sequence_parallel.sp_size`` 2 in two ranks on card 0 over gloo, one
  ``[1, 8192]`` row (4096 tokens a rank), bf16, flash, remat,
  ``loss_tiles`` 8, 2 steps: finite falling losses equal on both ranks,
  per rank and step 2 L flash forwards, L dq and L dk/dv passes and 12 L
  all-to-alls, each rank's peak memory and state bytes; then one process
  at sp 1 on the same weights and row: losses and grad norms within the
  bf16 bounds of ``tests/test_torch_train.py``.  Its times are gloo
  through the host, two ranks on one card: not an SP speed;
- ``train_sp_agree`` (the same launch): ``AGREE_TRAIN``'s fp32 widths on
  ``[2, 256]``, 3 steps: Ulysses sp 2 against one process at sp 1 to
  1e-5, the ring at sp 2 to 1e-4, ``loss_tiles`` 4 against 1 (both sp
  2) to 1e-6.

The multi-rank Infinity slice adds:

- ``train_infinity_sp`` (in train_sp's launch): ZeRO-Infinity x Ulysses,
  the model and row of ``train_sp`` built in host memory, sp 2, bf16,
  flash, ``loss_tiles`` 8, the cpu tier on the fused path, 2 steps, each
  rank's host planes its half of every layer: losses and grad norms
  bit-equal on the ranks and within the bf16 bounds of train_sp's
  on-device sp-2 run, flash ``2 L`` / ``L`` / ``L`` and 12 L all-to-alls
  a rank a step, the trunk's device buffers ``2 x n_pad x 2`` bytes, the
  host plane bytes half of one process's; step time and its split, peak
  memory a rank, gather and reduce-scatter bytes a step;
- ``train_infinity_sp_agree`` (the same launch): ``AGREE_TRAIN``'s fp32
  widths on ``[2, 256]``, sp 2 streamed, against train_sp_agree's Ulysses
  run to ``INF_AGREE_RTOL``;
- in ``train_zero``, ``AGREE_TRAIN`` fp32 on the two ranks under
  ``offload_param`` (dp 2, the stash path with clipping, 2 steps): the
  ranks bit-equal, against one process's Infinity with a rank's rows a
  microbatch to ``INF_AGREE_RTOL``.

The tensor-parallel training slice adds:

- in ``train``, the hybrid engine (``hybrid_engine.enabled``): after the
  headline's steps, ``generate`` of 16 greedy tokens for two rows of the
  batch's first 128 tokens (decode #1 ``L x 15`` times at h 12, d 64),
  equal to ``init_inference``'s on the same module;
- ``train_tp`` (one launch of two ranks on card 0 over gloo):
  Llama-3-8B widths at train_sp's ``SP_LAYERS`` layers, row and loss
  tiles, ``tensor_parallel.autotp_size`` 2 (flash on 16 heads a rank at
  the ``_sp`` shape, the vocabulary-parallel loss), bf16, ZeRO 0, 2
  steps; then Mixtral-8x7B widths at train_moe's depth and row under
  fused Adam (#11/#12 on each rank's ``I/tp`` expert columns, #13/#14 on
  its shards): losses and grad norms bit-equal on the ranks, every leaf
  the ranks hold whole bit-equal (sha1), each rank's parameters and state
  bytes those of the split, the launch formula, and the first step's loss
  and grad norm within the bf16 bounds of one process (train_sp's and
  train_moe's runs);
- ``train_tp_hybrid`` (the same launch): 8 greedy tokens of the tp-2
  Llama's hybrid engine after its steps, equal on the ranks, decode #1
  ``L x 7`` a rank;
- ``train_tp_agree`` (the same launch): ``AGREE_TRAIN``'s fp32 widths and
  its Mixtral case at tp 2 against one process to ``TP_AGREE_RTOL``;
- in ``serve_tp`` / ``generate_tp``, OPT-1.3B at ``OPT_TP_LAYERS`` layers,
  tp 2 (16 of 32 heads a rank, d 64): ``serve_opt_tp`` (#2b ``L`` a
  decode step) and ``generate_opt_tp`` (decode #1 ``L x 31``); in
  ``agree_tp``, fp32 OPT-1.3B widths at 4 layers against tp 1 (tokens
  equal, logits to 1e-4).

What tensor-parallel training refused before adds:

- in ``flash_kernels``, the ``tpsp`` case (B 1, h 8, d 128, S 8192,
  causal with a 4096 window: Mistral-7B's 32 heads over tp 2 x sp 2) in
  all three dtypes, timed beside SDPA with the boolean window mask and
  the bound of the live pairs;
- in ``train_tp``'s launch: ``train_infinity_tp`` (train_tp's Llama, its
  weights and row, streamed from the cpu tier at tp 2: the ranks equal,
  the trunk's device buffers and host planes those of a tensor rank's
  plane to the byte, no trunk leaf on the card, the streamed flash
  launches, the first step within the bf16 bounds of the on-device tp-2
  run) and its fp32 agreement against train_tp_agree's tp-2 Llama to
  ``INF_AGREE_RTOL``; ``train_bert_tp`` (BERT-large widths at 2 layers,
  train_bert's batch, tp 2: 8 of 16 heads a rank on the non-causal
  flash kernels, the first step within the bf16 bounds of one process);
  ``train_tp_ladder_agree`` (fp32 OPT-1.3B widths, ResNet, a narrow BERT
  and an HF-shaped client split by AutoTP's name policy at tp 2 against
  one process);
- ``train_tp_sp`` (one launch of four ranks on card 0 over gloo):
  Mistral-7B widths at 2 layers on train_sp's ``[1, 8192]`` row, tp 2 x
  sp 2 (each rank its 16 heads of its 4096-token chunk, Ulysses over its
  seq group: flash on 8 heads at the full S), bf16, ``loss_tiles`` 8, 2
  steps: the four ranks' losses equal, every whole leaf equal on the four
  and every split leaf on its tensor coordinate's seq ranks, each rank's
  parameters and state those of the tensor split, the launch formula and
  12 L all-to-alls a step, the first step within the bf16 bounds of one
  process; ``train_tp_sp_agree``: ``AGREE_TRAIN`` fp32 at tp 2 x sp 2,
  Ulysses and the ring, against one process;
- ZeRO++ at Llama-3-8B widths (2 layers, one ``[1, 2048]`` row a rank,
  fused Adam, 2 steps a run): ``train_zeropp`` in train_zero's launch
  (exact stage 3, stage 3 with qwZ and qgZ, stage 2 with qgZ: the
  quantized runs within JAX's 5e-2 of the exact one) and
  ``train_zeropp_agree`` (``AGREE_TRAIN`` fp32 under qwZ on the two ranks
  against one process, 1e-4); ``train_hpz`` in train_tp_sp's launch (hpZ
  at ep 2 x dp 2 beside stage 3 without it, both under qwZ and qgZ,
  within ``ZERO_STAGE_RTOL``); in
  each run the ranks' losses equal, the launch formula, the state bytes
  and the bytes of the last step by collective and dtype equal to the
  count from the shapes; the plain quantizer's round trip timed.

Each rank process costs about 20 s to start and stop, so the two-rank
phases share three launches (``shared_launch``; each rank runs the phases'
bodies in turn, ``shared_rank``): serve_tp's with serve_moe_tp's;
train_zero's with train_ckpt's ZeRO part, train_moe_ep's,
train_bert_zero's and train_zeropp's; train_sp's with train_tp's (and
train_tp_sp's four ranks run train_hpz's); the first of them to run
starts the launch and the others read its result.  Ranks report to this
process through a queue; only it prints.  Then a
``kernels`` line (every kernel's launches on the main paths: the
decode kernels' from ``serve`` and ``generate``, #2b's per rank from
``serve_tp``, the flash kernels' from ``train``, the MoE kernels' from
``serve_moe``, ``generate_moe`` and ``train_moe``, the norm and Adam
kernels' from ``train_moe``, the block-sparse kernels' from ``sparse``,
the quantizer's from its path; the ``_bert`` rows' from ``train_bert``,
the ``_opt`` rows' from ``generate_opt`` and ``serve_opt`` (and the OPT
runs of ``serve_tp``), the ``_70b`` rows' from ``train_infinity``, the
``_sp`` rows' from ``train_sp``'s, ``train_tp``'s and
``train_infinity_tp``'s rank 0, the ``_inf_sp`` rows' from
``train_infinity_sp``'s rank 0, the ``_tpsp`` rows' from ``train_tp_sp``'s
rank 0; ``train_bert_tp`` adds to the ``_bert`` rows, ``train_tp``'s
Mixtral to #11-#14's and the hybrid generates to #1's; times
at the main paths' shapes), a
``timing`` line (seconds by phase; a shared launch's in its first
phase, and each launch's wall and rank 0's seconds a body),
the card's name and power limit, and the result line.
``--only build,moe_kernels,...`` runs the named phases alone and prints
neither of the last two lines.  TF32 is off for matmuls and cuDNN.  Length 0
is not tested: the TPU kernel gives 0 there and its reference the mean of
V; the engines never pass it (an idle slot attends one key on scratch page
0).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
SLICE = dict(B=8, h=32, kv_h=8, d=128, bs=16, smax=2048)
LENGTHS = [1, 15, 16, 17, 1000, 2048, 640, 1999]
V1_BATCH, V1_PROMPT, V1_NEW = 4, 256, 32
#: (name, lengths, Smax, windows): every shape the main path gives the
#: kernels.  "slice": B 8 over 2048 keys; its pool of 8 x 128 + 1 = 1025
#: pages and [8, 128] tables are the serve phase's.  "v1": generate's
#: padded cache of 256 + 32 keys, at the lengths its decode steps pass.
CHECKS = [("slice", LENGTHS, SLICE["smax"], (None, 512)),
          ("v1", [V1_PROMPT + 1, V1_PROMPT + 14, V1_PROMPT + V1_NEW - 1,
                  V1_PROMPT + V1_NEW], V1_PROMPT + V1_NEW, (None,))]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


#: the launches several phases share (each rank process costs ~20 s to
#: start and stop on one card): launch name -> its result, and the
#: directories they leave for a later phase (removed at the end)
_SHARED_LAUNCHES: dict = {}
_SHARED_DIRS: list = []


def shared_launch(name: str, run):
    """``run()``'s result, run once for every phase that shares launch
    ``name``: the first of them to run starts it."""
    if name not in _SHARED_LAUNCHES:
        _SHARED_LAUNCHES[name] = run()
    return _SHARED_LAUNCHES[name]


def shared_rank(rank: int, bodies: list) -> dict:
    """One rank of a shared launch: each ``(key, rank body, args)`` of
    ``bodies`` in turn, ``body(rank, *args)`` under ``key``, the card's
    cache emptied and its peak reset before each; ``seconds``: each
    body's on the host clock."""
    out = {"seconds": {}}
    for key, body, args in bodies:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[key] = body(rank, *args)
        out["seconds"][key] = time.perf_counter() - t0
    return out


def reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def kernel_wrappers() -> dict:
    """Every ported kernel's name in the ``kernels`` line → its wrapper,
    whose ``launches`` counts the kernel's launches."""
    from deepspeed_tpu_torch.ops import kernels as k
    return {"decode_attention": k.decode_attention,
            "paged_decode_attention": k.paged_decode_attention,
            "paged_decode_attention_tp": k.paged_decode_attention_tp,
            "quantize_int8": k.quantize_int8,
            "flash_fwd": k.flash_fwd, "flash_bwd_dq": k.flash_bwd_dq,
            "flash_bwd_dkv": k.flash_bwd_dkv,
            "block_sparse_fwd": k.block_sparse_fwd,
            "block_sparse_bwd_dq": k.block_sparse_bwd_dq,
            "block_sparse_bwd_dkv": k.block_sparse_bwd_dkv,
            "moe_dispatch": k.moe_dispatch_fwd,
            "moe_combine": k.moe_combine_fwd,
            "multi_tensor_sqsum": k.tree_sqsum, "fused_adam": k.fused_adam}


def reset_counts() -> None:
    reset_launches(*kernel_wrappers().values())


def read_counts() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


# -- phase 1 ---------------------------------------------------------------

#: kernel families that run on the tensor cores (bf16 and fp16): the flash
#: passes, the decode kernel and the block-sparse forward and backward
#: passes; each must hold tensor-core instructions and none may spill
MMA_FAMILIES = ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma",
                "gqa_decode_mma", "block_sparse_fwd_mma",
                "block_sparse_bwd_dq_mma", "block_sparse_bwd_dkv_mma")
#: a family's name is what precedes "_kernel"; each ``_mma`` name comes
#: before the name it extends, so the first alternative that matches at a
#: position is the whole family name
FAMILY = re.compile(r"(gqa_decode_mma|gqa_decode|flash_fwd_mma|flash_fwd|"
                    r"flash_bwd_dq_mma|flash_bwd_dq|flash_bwd_dkv_mma|"
                    r"flash_bwd_dkv|block_sparse_fwd_mma|block_sparse_fwd|"
                    r"block_sparse_bwd_dq_mma|block_sparse_bwd_dq|"
                    r"block_sparse_bwd_dkv_mma|block_sparse_bwd_dkv|"
                    r"dispatch|combine|sqsum_partial|sqsum_final|"
                    r"adam)_kernel")


def tensor_core_instructions(library) -> dict:
    """Per kernel family, the ``HMMA`` / ``HGMMA`` instructions in
    ``cuobjdump -sass`` of the built library (summed over its instances)."""
    import os

    from deepspeed_tpu_torch.ops import op_builder
    tool = os.path.join(os.path.dirname(op_builder.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fam = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = FAMILY.search(fn.group(1))
            fam = name.group(1) if name else None
            if fam is not None:
                counts.setdefault(fam, 0)
        elif fam is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[fam] += 1
    return counts


def phase_build() -> dict:
    from deepspeed_tpu_torch.ops import op_builder

    t0 = time.perf_counter()
    path = op_builder.build()
    op_builder.load_library()
    # ptxas -v reports each instance: "Compiling entry function '<name>'",
    # then its spill stores and its registers; kept per kernel family
    families, fam, compiled = {}, None, 0
    for line in op_builder.build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            compiled += 1
            name = FAMILY.search(entry.group(1))
            fam = name.group(1) if name else entry.group(1)
            families.setdefault(fam, [0, 0])
        for i, pattern in enumerate((r"Used (\d+) registers",
                                     r"(\d+) bytes spill stores")):
            found = re.search(pattern, line)
            if found and fam is not None:
                families[fam][i] = max(families[fam][i], int(found.group(1)))
    seconds = time.perf_counter() - t0
    mma = tensor_core_instructions(path)
    out = {"phase": "build", "seconds": seconds,
           "library": path.name, "kernels_compiled": compiled,
           "max_registers": {f: r for f, (r, _) in families.items()},
           "max_spill_bytes": {f: sp for f, (_, sp) in families.items()},
           "tensor_core_instructions": mma}
    emit(out)  # before the checks, so a failing build still reports
    for fam in MMA_FAMILIES:
        require(mma.get(fam, 0) > 0, f"build: {fam} (bf16, fp16) holds no "
                                     "tensor-core instruction")
    if families:  # empty when the library was already built
        for fam in MMA_FAMILIES:
            require(families[fam][1] == 0, f"build: {fam} spills "
                                           f"{families[fam][1]} bytes")
    return out


# -- phase 2 ---------------------------------------------------------------

def make_inputs(dtype, lengths, smax, gen, dev, heads=SLICE):
    """q; a padded cache of ``smax`` keys; a pool holding the same keys
    behind a shuffled block table; one sequence per entry of ``lengths``;
    ``heads`` names h, kv_h, d and the page size bs."""
    h, kv_h, d, bs = (heads[k] for k in ("h", "kv_h", "d", "bs"))
    B, mb = len(lengths), smax // bs
    q = torch.randn(B, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, smax, kv_h, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, smax, kv_h, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(B * mb, generator=gen, device=dev) + 1
    tables = perm.reshape(B, mb).to(torch.int32)
    k_pool = torch.zeros(B * mb + 1, bs, kv_h, d, dtype=dtype, device=dev)
    v_pool = torch.zeros_like(k_pool)
    k_pool[perm] = k.reshape(B * mb, bs, kv_h, d)
    v_pool[perm] = v.reshape(B * mb, bs, kv_h, d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, k_pool, v_pool, tables, lens


def event_pair():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def sleep_cycles_per_ms() -> float:
    """Rate of ``torch.cuda._sleep``, to size the sleeps of :func:`time_ms`."""
    a, b = event_pair()
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 1e7 / a.elapsed_time(b)


def time_ms(calls, cycles_per_ms: float, reps: int = 7,
            per_rep: int = 30) -> dict:
    """Device time of one call.  Each rep queues ``per_rep`` calls back to
    back behind a GPU sleep that outlasts the host's enqueueing, so the card
    runs them without gaps and the host's per-call overhead is not measured;
    one event pair times the lot.  The calls rotate over ``calls`` (each on
    its own inputs, so a call finds its K/V cold).  Median and range of the
    per-call time over ``reps``; ``host_hidden`` says every sleep outlasted
    its enqueueing."""
    def enqueue() -> float:
        t0 = time.perf_counter()
        for i in range(per_rep):
            calls[i % len(calls)]()
        return (time.perf_counter() - t0) * 1e3

    enqueue()
    torch.cuda.synchronize()
    sleep_ms = 3 * enqueue() + 2.0
    torch.cuda.synchronize()
    per_call, hidden = [], True
    for _ in range(reps):
        a, b = event_pair()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        a.record()
        hidden &= enqueue() < sleep_ms
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / per_rep)
    return {"ms": statistics.median(per_call), "min_ms": min(per_call),
            "max_ms": max(per_call), "reps": reps, "calls_per_rep": per_rep,
            "host_hidden": hidden}


def decode_bound_ms(q, lens, kv_h, smax, with_tables: bool) -> tuple:
    """Least time for one call without a window: bytes (q, out, live K and
    V, lengths and tables read once) over the memory rate, against 4*d flops
    per (query head, live key) over the peak rate of the inputs' type."""
    B, h, d = q.shape
    el = q.element_size()
    live_keys = int(lens.long().clamp(min=0, max=smax).sum())
    nbytes = (2 * q.numel() * el + 2 * live_keys * kv_h * d * el
              + lens.numel() * 4)
    if with_tables:
        nbytes += B * (smax // SLICE["bs"]) * 4
    flops = 4 * d * h * live_keys
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


#: the serve phase's 8 slots halfway through their decode: each request's
#: prompt plus half its budget (``SERVE_REQUESTS``)
SERVE_STEP_LENGTHS = [736, 832, 96, 1516, 928, 276, 1218, 158]


def time_main_path_shapes(gen, dev, cycles) -> dict:
    """The decode kernel at the shape v1 ``generate`` gives it (B 4 over
    257-288 keys of a 288-key cache) and the paged kernel at a serve
    decode step (``SERVE_STEP_LENGTHS`` in a 2048-key cache), bf16, each
    checked against its plain version there, then timed with its bound;
    with the kernels' split-K chunk."""
    import importlib

    from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                                 decode_attention_plain,
                                                 paged_decode_attention,
                                                 paged_decode_attention_plain)
    _, v1_lengths, v1_smax, _ = CHECKS[1]
    shapes = {
        "decode_attention": (
            "v1_time", v1_lengths, v1_smax, False,
            lambda s: decode_attention(s[0], s[1], s[2], s[6]),
            lambda s: decode_attention_plain(s[0], s[1], s[2], s[6])),
        "paged_decode_attention": (
            "serve_step_time", SERVE_STEP_LENGTHS, SLICE["smax"], True,
            lambda s: paged_decode_attention(*s[:1], *s[3:]),
            lambda s: paged_decode_attention_plain(*s[:1], *s[3:]))}
    chunk = importlib.import_module(
        "deepspeed_tpu_torch.ops.kernels.decode_attention").SPLIT_CHUNK
    out = {}
    for name, (key, lengths, smax, with_tables, kernel, plain) in \
            shapes.items():
        sets = [make_inputs(torch.bfloat16, lengths, smax, gen, dev)
                for _ in range(3)]
        check_close(f"{name} at {key}", kernel(sets[0]), plain(sets[0]),
                    torch.bfloat16)
        bound, by = decode_bound_ms(sets[0][0], sets[0][6], SLICE["kv_h"],
                                    smax, with_tables)
        out[name] = {key: dict(
            time_ms([lambda s=s: kernel(s) for s in sets], cycles),
            bound_ms=bound, bound_by=by,
            at=f"bf16, B {len(lengths)}, lengths {lengths}, cache of "
               f"{smax} keys"), "split_chunk": chunk}
    return out


#: OPT-1.3B's decode shape: multi-head (32 query and 32 kv heads, n_rep 1)
#: at head dim 64, pages of 16
OPT_HEADS = dict(h=32, kv_h=32, d=64, bs=16)


def opt_decode_rows(gen, dev, cycles) -> dict:
    """Decode #1 and paged #2 at OPT-1.3B's shape: each against its plain
    version, bf16 and fp32, at every ``CHECKS`` shape (B 8 over up to 2048
    ragged keys; v1's B 4 over 257-288 keys); then timed in bf16 at B 8
    with every sequence at 2048 keys beside its plain version, SDPA (for
    #1) and its bound (K and V bytes over 3.35 TB/s)."""
    from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                                 decode_attention_plain,
                                                 paged_decode_attention,
                                                 paged_decode_attention_plain)

    names = ("decode_attention", "paged_decode_attention")
    errs = {name: {} for name in names}
    for (case, lengths, smax, _), dtype in itertools.product(
            CHECKS, (torch.bfloat16, torch.float32)):
        q, k, v, kp, vp, tables, lens = make_inputs(dtype, lengths, smax,
                                                    gen, dev, OPT_HEADS)
        got = (decode_attention(q, k, v, lens),
               paged_decode_attention(q, kp, vp, tables, lens))
        want = (decode_attention_plain(q, k, v, lens),
                paged_decode_attention_plain(q, kp, vp, tables, lens))
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            key = f"opt_{case}_{str(dtype).split('.')[-1]}"
            errs[name][key] = check_close(f"{name} {key}", g, w, dtype)
    smax = SLICE["smax"]
    sets = [make_inputs(torch.bfloat16, [smax] * SLICE["B"], smax, gen, dev,
                        OPT_HEADS) for _ in range(3)]
    q0, k0, v0, *_, l0 = sets[0]
    mask = torch.ones(SLICE["B"], 1, 1, smax, dtype=torch.bool, device=dev)

    def sdpa(q, k, v, *_):
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask)[:, :, 0, :]

    lib_err = (sdpa(q0, k0, v0).float()
               - decode_attention_plain(q0, k0, v0, l0).float()).abs().max()
    calls = {
        "decode_attention": (
            lambda q, k, v, kp, vp, t, n: decode_attention(q, k, v, n),
            lambda q, k, v, kp, vp, t, n: decode_attention_plain(q, k, v, n),
            sdpa),
        "paged_decode_attention": (
            lambda q, k, v, kp, vp, t, n: paged_decode_attention(q, kp, vp,
                                                                 t, n),
            lambda q, k, v, kp, vp, t, n: paged_decode_attention_plain(
                q, kp, vp, t, n), None)}
    out = {}
    for name, (kernel, plain, library) in calls.items():
        bound, by = decode_bound_ms(q0, l0, OPT_HEADS["kv_h"], smax,
                                    name == "paged_decode_attention")
        out[name] = dict(
            kernel_time=time_ms([lambda s=s: kernel(*s) for s in sets],
                                cycles),
            plain_time=time_ms([lambda s=s: plain(*s) for s in sets],
                               cycles),
            library_time=(dict(time_ms([lambda s=s: library(*s)
                                        for s in sets], cycles),
                               max_abs_err_vs_plain=lib_err.item())
                          if library else None),
            library_call=("F.scaled_dot_product_attention(bool mask)"
                          if library else "none: no single PyTorch call "
                                          "attends through a block table"),
            bound_ms=bound, bound_by=by,
            max_abs_err=max(errs[name].values()),
            max_abs_err_by_case=errs[name], heads=OPT_HEADS,
            timed_at="bf16, B 8, every length 2048")
    return out


def phase_kernels(dev) -> dict:
    """One dict per kernel: its errors against its plain version, its
    times, its bound, and the launches this phase made."""
    from deepspeed_tpu_torch.ops.kernels import (decode_attention,
                                                 decode_attention_plain,
                                                 paged_decode_attention,
                                                 paged_decode_attention_plain)

    reset_launches(decode_attention, paged_decode_attention)
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {"decode_attention": {}, "paged_decode_attention": {}}
    slice_case = CHECKS[0][:3] + ((None,),)  # fp16 at the serving shape
    for (case, lengths, smax, windows), dtype in list(itertools.product(
            CHECKS, (torch.bfloat16, torch.float32))) + [
                (slice_case, torch.float16)]:
        q, k, v, kp, vp, tables, lens = make_inputs(dtype, lengths, smax,
                                                    gen, dev)
        for window in windows:
            pairs = {
                "decode_attention": (
                    decode_attention(q, k, v, lens, window=window),
                    decode_attention_plain(q, k, v, lens, window)),
                "paged_decode_attention": (
                    paged_decode_attention(q, kp, vp, tables, lens,
                                           window=window),
                    paged_decode_attention_plain(q, kp, vp, tables, lens,
                                                 window))}
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                require(got.dtype == dtype and got.shape == want.shape,
                        f"{name}: wrong dtype/shape")
                err = (got.float() - want.float()).abs()
                tol = TOL[dtype] * (1 + want.float().abs())
                require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                require(bool((err <= tol).all()),
                        f"{name} {case} {dtype} window={window}: max error "
                        f"{err.max().item()} over tolerance {TOL[dtype]}")
                key = f"{case}_{str(dtype).split('.')[-1]}_w{window}"
                errs[name][key] = err.max().item()

    # timing: bf16, every sequence at the full 2048 context, no window;
    # three input sets (3 x 67 MB of K/V) so no call finds its K/V in L2
    sets = [make_inputs(torch.bfloat16, [SLICE["smax"]] * SLICE["B"],
                        SLICE["smax"], gen, dev) for _ in range(3)]
    q0, k0, v0, *_, l0 = sets[0]
    cycles = sleep_cycles_per_ms()
    mask = torch.ones(SLICE["B"], 1, 1, SLICE["smax"], dtype=torch.bool,
                      device=dev)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0, :]

    lib_err = (sdpa(q0, k0, v0).float()
               - decode_attention_plain(q0, k0, v0, l0).float()).abs().max()
    def timed(fn, **extra) -> dict:
        """``fn(q, k, v, k_pool, v_pool, tables, lengths)`` timed over the
        input sets."""
        t = time_ms([lambda s=s: fn(*s) for s in sets], cycles)
        return dict(t, **extra)

    timing = {
        "decode_attention": dict(
            kernel_time=timed(lambda q, k, v, kp, vp, t, n:
                              decode_attention(q, k, v, n)),
            plain_time=timed(lambda q, k, v, kp, vp, t, n:
                             decode_attention_plain(q, k, v, n)),
            library_time=timed(lambda q, k, v, kp, vp, t, n: sdpa(q, k, v),
                               call="F.scaled_dot_product_attention("
                                    "enable_gqa=True, bool mask)",
                               max_abs_err_vs_plain=lib_err.item())),
        "paged_decode_attention": dict(
            kernel_time=timed(lambda q, k, v, kp, vp, t, n:
                              paged_decode_attention(q, kp, vp, t, n)),
            plain_time=timed(lambda q, k, v, kp, vp, t, n:
                             paged_decode_attention_plain(q, kp, vp, t, n)),
            library_time=None,
            library_call="none: no single PyTorch call attends through a "
                         "block table"),
    }
    launches = {"decode_attention": decode_attention.launches,
                "paged_decode_attention": paged_decode_attention.launches}
    for name, extra in time_main_path_shapes(gen, dev, cycles).items():
        timing[name].update(extra)
    for name, row in opt_decode_rows(gen, dev, cycles).items():
        timing[name + "_opt"] = row
    for name, with_tables in (("decode_attention", False),
                              ("paged_decode_attention", True)):
        bound, by = decode_bound_ms(q0, l0, SLICE["kv_h"], SLICE["smax"],
                                    with_tables)
        timing[name].update(
            bound_ms=bound, bound_by=by, launches_this_phase=launches[name],
            max_abs_err=max(errs[name].values()),
            max_abs_err_by_case=errs[name],
            checked_at={case: dict(B=len(lengths), smax=smax,
                                   lengths=lengths, windows=list(windows))
                        for case, lengths, smax, windows in CHECKS},
            heads=dict(h=SLICE["h"], kv_h=SLICE["kv_h"], d=SLICE["d"],
                       bs=SLICE["bs"]),
            tolerance={str(t).split(".")[-1]: v for t, v in TOL.items()},
            checked_fp16_at="slice, no window",
            timed_at="bf16, B 8, every length 2048, no window",
            tf32=torch.backends.cuda.matmul.allow_tf32)
    return timing


# -- phase 3 ---------------------------------------------------------------

#: (case, B, h, d, S, causal, window, segments): every shape the training
#: phases give the flash kernels (``headline``: bench.py's model, ``8b``:
#: Llama-3-8B widths, ``bert``: BERT-large's non-causal attention with a
#: pad tail a row), and the masks and lengths the kernels promise besides:
#: a window with packed segments, an S that is not a multiple of the 64-row
#: tile, and an S at which the TPU package streamed (S * d > 2M elements).
#: segments: False (none), "packed" (three sequences a row) or "pad" (1 on
#: real tokens, 0 on a pad tail of 0-``BERT_MAX_PAD`` tokens; row 0 none)
FLASH_CASES = [("headline", 8, 12, 64, 2048, True, None, False),
               ("8b", 1, 32, 128, 2048, True, None, False),
               ("bert", 8, 16, 64, 512, False, None, "pad"),
               ("window_segments", 2, 8, 128, 2048, True, 512, "packed"),
               ("ragged", 2, 4, 64, 1000, True, None, False),
               ("long", 1, 2, 128, 20480, True, None, False),
               ("70b", 2, 64, 128, 2048, True, None, False),
               ("sp", 1, 16, 128, 8192, True, None, False),
               ("tpsp", 1, 8, 128, 8192, True, 4096, False)]
#: bf16, the training phases' shapes (``70b``: train_infinity's streamed
#: layers, h 64 with K/V repeated from 8; ``sp``: train_sp's Ulysses
#: shape, the full S 8192 on 32/2 heads; ``tpsp``: train_tp_sp's, Mistral-
#: 7B's 32 heads over tp 2 x sp 2 at the full S 8192, its 4096 window)
FLASH_TIMED = ("headline", "8b", "bert", "70b", "sp", "tpsp")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BERT_MAX_PAD = 200


def pad_segments(B: int, S: int, gen, dev) -> torch.Tensor:
    """int32 ``[B, S]``: 1 on real tokens, 0 on a pad tail of 0 to
    ``BERT_MAX_PAD`` tokens a row (row 0 has none), BERT's padding as
    segment ids."""
    pads = torch.randint(0, BERT_MAX_PAD + 1, (B,), generator=gen,
                         device=dev)
    pads[0] = 0
    pos = torch.arange(S, device=dev)
    return (pos[None, :] < S - pads[:, None]).to(torch.int32).contiguous()


def flash_inputs(case, dtype, gen, dev):
    """q, k, v, do ``[B, S, h, d]`` and int32 segment ids (three packed
    sequences per row, cut at random points, or a pad tail) or None."""
    _, B, h, d, S, _, _, segments = case
    q, k, v, do = (torch.randn(B, S, h, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    seg = None
    if segments == "packed":
        cuts = torch.randint(1, S, (B, 2), generator=gen, device=dev)
        pos = torch.arange(S, device=dev)
        seg = (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(
            torch.int32).contiguous()
    elif segments == "pad":
        seg = pad_segments(B, S, gen, dev)
    return q, k, v, do, seg


def segment_pairs(seg: Optional[torch.Tensor], S: int, causal: bool,
                  window: Optional[int]) -> int:
    """Live (q, k) pairs of one head summed over the batch: the position
    mask's without segments, else those whose two tokens share a segment
    (non-causal, no window: the BERT case)."""
    from deepspeed_tpu_torch.ops.kernels.lattice import live_pairs

    if seg is None:
        return live_pairs(S, causal, window)
    require(not causal and window is None,
            "segment_pairs counts non-causal, unwindowed segments only")
    counts = torch.stack([(seg == s).sum(-1) for s in seg.unique()])
    return int((counts.long() ** 2).sum())


def attention_bounds(B: int, S: int, h: int, d: int, el: int, pairs: int,
                     names=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                     extra_bytes=(0, 0, 0)) -> dict:
    """Least time per kernel (forward, dq pass, dk/dv pass) for one call:
    ``pairs`` live (q, k) pairs (all heads and rows, counted from this run's
    mask) times the kernel's flops per pair (forward 4d: q·k and p·V; dq
    pass 6d: q·k, do·V, ds·K; dk/dv pass 8d: q·k, do·V, pᵀ·do, dsᵀ·q) over
    the peak rate of the inputs' type, against the bytes it must move (each
    input read once, each output written once, lse and delta fp32, plus
    ``extra_bytes`` of plan) over the memory rate."""
    n = B * S * h * d * el              # one [B, S, h, d] tensor
    stats = B * h * S * 4               # one fp32 [B, h, S] row statistic
    work = ((4 * d, 4 * n + stats), (6 * d, 5 * n + 2 * stats),
            (8 * d, 6 * n + 2 * stats))
    peak = PEAK_FLOPS[torch.bfloat16 if el == 2 else torch.float32]
    out = {}
    for name, (flops_per_pair, nbytes), extra in zip(names, work,
                                                     extra_bytes):
        t_ops = flops_per_pair * pairs / peak * 1e3
        t_bytes = (nbytes + extra) / PEAK_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


#: the flash kernels' check dtypes: bf16 and fp16 run the tensor-core
#: kernels, fp32 the fp32-FMA ones
FLASH_DTYPES = (torch.bfloat16, torch.float16, torch.float32)

#: the backward passes' random-``out`` regime (tests/test_torch_kernels.py
#: ``_regime_case``): B 1, S 640, h 2, causal, at each head dim and seed
REGIME_S, REGIME_H, REGIME_SEEDS = 640, 2, (0, 1, 2, 3)
REGIME_DEAD = (0, 63, 64, 300, REGIME_S - 1)


def regime_inputs(d: int, dtype, seed: int, dev) -> tuple:
    """q, k, v, do and a random ``out`` ``[1, S, h, d]``, lse = |N(0, 1)| +
    3 with the ``REGIME_DEAD`` rows at 1e30, from a generator on the card
    seeded with ``seed``.  delta = rowsum(dO∘out) is then as large as dP,
    so dS = P (dP − delta) is large: a backward pass that rounds dS to 16
    bits before its products misses the plain version's fp32 by more than
    2e-2 (PERF.md)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (1, REGIME_S, REGIME_H, d)
    q, k, v, do, out = (torch.randn(shape, generator=gen, device=dev)
                        .to(dtype) for _ in range(5))
    lse = torch.randn(1, REGIME_H, REGIME_S, generator=gen,
                      device=dev).abs() + 3.0
    lse[..., list(REGIME_DEAD)] = 1e30
    return q, k, v, do, out, lse


def hold_regime(kernel_dq, kernel_dkv, plain, errs: dict, label: str,
                dev) -> None:
    """The dq and dk/dv passes (``kernel_dq``/``kernel_dkv``/``plain`` take
    q, k, v, out, lse, do) on the random-``out`` regime, bf16 and fp16, d 64
    and 128, each ``REGIME_SEEDS`` seed, within ``TOL`` of the plain
    version; the dead rows' dq is 0.  Errors go to ``errs[name][key]``."""
    for d, dtype, seed in itertools.product(
            (64, 128), (torch.bfloat16, torch.float16), REGIME_SEEDS):
        q, k, v, do, out, lse = regime_inputs(d, dtype, seed, dev)
        dq = kernel_dq(q, k, v, out, lse, do)
        dk, dv = kernel_dkv(q, k, v, out, lse, do)
        want = plain(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        key = f"{label}_d{d}_seed{seed}_{str(dtype).split('.')[-1]}"
        require(bool((dq[:, list(REGIME_DEAD)] == 0).all()),
                f"{key}: a dead row's dq is not 0")
        for name, outputs in ((0, ((dq, want[0]),)),
                              (1, ((dk, want[1]), (dv, want[2])))):
            errs[name][key] = max(check_close(f"{key} pass {name}", g, w,
                                              dtype) for g, w in outputs)


#: the random-``out`` regime at the ``bert`` case: seeds, bf16 and fp16
BERT_REGIME_SEEDS = (0, 1)


def hold_bert_regime(errs: dict, dev) -> None:
    """The dq and dk/dv passes at the ``bert`` case (B 8, S 512, h 16, d
    64, non-causal, pad tails) on a random ``out`` and lse = |N(0, 1)| +
    3, bf16 and fp16, each ``BERT_REGIME_SEEDS`` seed, within ``TOL`` of
    the plain backward.  Errors go to ``errs[name][key]``."""
    from deepspeed_tpu_torch.ops.kernels import (flash_attention_bwd_plain,
                                                 flash_bwd_dkv, flash_bwd_dq)

    case = next(c for c in FLASH_CASES if c[0] == "bert")
    _, B, h, d, S, causal, window, _ = case
    for dtype, seed in itertools.product((torch.bfloat16, torch.float16),
                                         BERT_REGIME_SEEDS):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do, seg = flash_inputs(case, dtype, gen, dev)
        out = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        lse = torch.randn(B, h, S, generator=gen, device=dev).abs() + 3.0
        dq = flash_bwd_dq(q, k, v, out, lse, do, causal, window, seg)
        dk, dv = flash_bwd_dkv(q, k, v, out, lse, do, causal, window, seg)
        want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         window, seg)
        torch.cuda.synchronize()
        key = f"random_out_bert_seed{seed}_{str(dtype).split('.')[-1]}"
        errs["flash_bwd_dq"][key] = check_close(f"{key} dq", dq, want[0],
                                                dtype)
        errs["flash_bwd_dkv"][key] = max(
            check_close(f"{key} {n}", g, w, dtype)
            for n, g, w in (("dk", dk, want[1]), ("dv", dv, want[2])))
        del q, k, v, do, out, lse, dq, dk, dv, want


def phase_flash_kernels(dev) -> dict:
    """The three flash kernels against their plain versions at every
    ``FLASH_CASES`` shape, bf16, fp16 and fp32 (the backward passes start
    from the plain forward's out and lse, so each kernel is held alone),
    and the backward passes on the random-``out`` regime (``hold_regime``,
    and at the ``bert`` case ``hold_bert_regime``); then timed at the
    training shapes in bf16 beside the plain versions, SDPA (causal, or
    with the same-segment boolean mask) and the bound, and in fp16 beside
    SDPA."""
    from deepspeed_tpu_torch.ops.kernels import (flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain,
                                                 flash_bwd_dkv, flash_bwd_dq,
                                                 flash_fwd)
    from deepspeed_tpu_torch.ops.kernels.flash_attention import \
        attention_delta
    from deepspeed_tpu_torch.ops.masks import local_attention_mask

    gen = torch.Generator(device=dev).manual_seed(4321)
    errs = {name: {} for name in FLASH_KERNELS}
    for case, dtype in itertools.product(FLASH_CASES, FLASH_DTYPES):
        name, _, _, _, _, causal, window, _ = case
        q, k, v, do, seg = flash_inputs(case, dtype, gen, dev)
        out, lse = flash_fwd(q, k, v, causal, window, seg)
        want_out, want_lse = flash_attention_fwd_plain(q, k, v, causal,
                                                       window, seg)
        dq = flash_bwd_dq(q, k, v, want_out, want_lse, do, causal, window,
                          seg)
        dk, dv = flash_bwd_dkv(q, k, v, want_out, want_lse, do, causal,
                               window, seg)
        want = flash_attention_bwd_plain(q, k, v, want_out, want_lse, do,
                                         causal, window, seg)
        torch.cuda.synchronize()
        pairs = {"flash_fwd": ((out, want_out), (lse, want_lse)),
                 "flash_bwd_dq": ((dq, want[0]),),
                 "flash_bwd_dkv": ((dk, want[1]), (dv, want[2]))}
        key = f"{name}_{str(dtype).split('.')[-1]}"
        for kernel, outputs in pairs.items():
            worst = 0.0
            for got, ref in outputs:
                require(got.shape == ref.shape and got.dtype == ref.dtype,
                        f"{kernel} {key}: wrong dtype/shape")
                require(bool(torch.isfinite(got).all()),
                        f"{kernel} {key}: non-finite")
                err = (got.float() - ref.float()).abs()
                tol = TOL[dtype] * (1 + ref.float().abs())
                require(bool((err <= tol).all()),
                        f"{kernel} {key}: max error {err.max().item()} over "
                        f"tolerance {TOL[dtype]} x (1 + |plain|)")
                worst = max(worst, err.max().item())
            errs[kernel][key] = worst
        del q, k, v, do, out, lse, want_out, want_lse, dq, dk, dv, want
        torch.cuda.empty_cache()
    hold_regime(
        lambda q, k, v, o, l, do: flash_bwd_dq(q, k, v, o, l, do, True),
        lambda q, k, v, o, l, do: flash_bwd_dkv(q, k, v, o, l, do, True),
        lambda q, k, v, o, l, do: flash_attention_bwd_plain(q, k, v, o, l,
                                                            do, True),
        {0: errs["flash_bwd_dq"], 1: errs["flash_bwd_dkv"]}, "random_out",
        dev)
    hold_bert_regime(errs, dev)

    cycles = sleep_cycles_per_ms()
    timing = {name: {} for name in FLASH_KERNELS}
    for case in (c for c in FLASH_CASES if c[0] in FLASH_TIMED):
        name, B, h, d, S, causal, window, _ = case

        def timing_sets(dtype):
            """Three input sets: q, k, v, do, the plain forward's out and
            lse, delta, the segment ids and SDPA's boolean keep mask."""
            out = []
            pos = torch.arange(S, device=dev)
            for _ in range(3):
                q, k, v, do, seg = flash_inputs(case, dtype, gen, dev)
                o, lse = flash_attention_fwd_plain(q, k, v, causal, window,
                                                   seg)
                keep = (None if seg is None and window is None else
                        local_attention_mask(pos, pos, causal, window)[
                            None, None] if seg is None else
                        (seg[:, None, :, None] == seg[:, None, None, :]))
                out.append((q, k, v, do, o, lse, attention_delta(o, do),
                            seg, keep))
            return out

        sets = timing_sets(torch.bfloat16)

        def sdpa_fwd(q, k, v, *rest):
            keep = rest[-1]
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=keep, is_causal=keep is None)

        graphs = []
        for q, k, v, do, *rest in sets:
            leaves = [t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v)]
            graphs.append((leaves, F.scaled_dot_product_attention(
                *leaves, attn_mask=rest[-1], is_causal=rest[-1] is None),
                do.transpose(1, 2)))

        def sdpa_bwd(i):
            leaves, o, g = graphs[i]
            return torch.autograd.grad(o, leaves, g, retain_graph=True)

        lib_err = (sdpa_fwd(*sets[0]).transpose(1, 2).float()
                   - sets[0][4].float()).abs().max().item()
        run = {
            "flash_fwd": (lambda q, k, v, do, o, l, dl, sg, kp:
                          flash_fwd(q, k, v, causal, window, sg),
                          lambda q, k, v, do, o, l, dl, sg, kp:
                          flash_attention_fwd_plain(q, k, v, causal, window,
                                                    sg)),
            "flash_bwd_dq": (lambda q, k, v, do, o, l, dl, sg, kp:
                             flash_bwd_dq(q, k, v, o, l, do, causal, window,
                                          sg, delta=dl),
                             lambda q, k, v, do, o, l, dl, sg, kp:
                             flash_attention_bwd_plain(q, k, v, o, l, do,
                                                       causal, window, sg)),
            "flash_bwd_dkv": (lambda q, k, v, do, o, l, dl, sg, kp:
                              flash_bwd_dkv(q, k, v, o, l, do, causal,
                                            window, sg, delta=dl),
                              lambda q, k, v, do, o, l, dl, sg, kp:
                              flash_attention_bwd_plain(q, k, v, o, l, do,
                                                        causal, window,
                                                        sg))}
        seg0 = sets[0][7]
        pairs = h * segment_pairs(seg0, S, causal, window) * (
            B if seg0 is None else 1)
        seg_bytes = 0 if seg0 is None else seg0.numel() * 4
        bounds = attention_bounds(B, S, h, d, 2, pairs,
                                  extra_bytes=(seg_bytes,) * 3)
        half_sets = timing_sets(torch.float16)
        mask_call = ("is_causal=True" if seg0 is None and window is None
                     else f"attn_mask=causal window-{window} bool [1, 1, S, "
                     "S]" if seg0 is None
                     else "attn_mask=same-segment bool [B, 1, S, S]")
        for kernel, (fn, plain) in run.items():
            library = (sdpa_fwd if kernel == "flash_fwd" else None)
            timing[kernel][name] = dict(
                kernel_time=time_ms([lambda s=s: fn(*s) for s in sets],
                                    cycles),
                # 3 calls a rep: a plain call is 1-30 ms of device time
                plain_time=time_ms([lambda s=s: plain(*s) for s in sets],
                                   cycles, per_rep=3),
                library_time=time_ms(
                    [lambda s=s: sdpa_fwd(*s) for s in sets] if library
                    else [lambda i=i: sdpa_bwd(i) for i in range(3)],
                    cycles),
                library_call=(f"F.scaled_dot_product_attention({mask_call})"
                              if library else
                              "torch.autograd.grad of F.scaled_dot_product_"
                              f"attention({mask_call}): dq, dk and dv in "
                              "one backward"),
                library_max_abs_err_vs_plain=lib_err,
                bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1],
                live_pairs=pairs,
                shape=dict(B=B, h=h, d=d, S=S, causal=causal,
                           window=window),
                dtype="bfloat16",
                kernel_time_fp16=time_ms(
                    [lambda s=s: fn(*s) for s in half_sets], cycles),
                library_time_fp16=time_ms(
                    [lambda s=s: sdpa_fwd(*s) for s in half_sets], cycles)
                if library else None)
        del sets, graphs, half_sets
        torch.cuda.empty_cache()
    return {kernel: dict(
        max_abs_err=max(errs[kernel].values()),
        max_abs_err_by_case=errs[kernel],
        checked_at={c[0]: dict(zip(("B", "h", "d", "S", "causal", "window",
                                    "segments"), c[1:]))
                    for c in FLASH_CASES},
        random_out_regime=dict(B=1, S=REGIME_S, h=REGIME_H, d=(64, 128),
                               seeds=REGIME_SEEDS, dead_rows=REGIME_DEAD,
                               dtypes=("bfloat16", "float16"),
                               bert_case_seeds=BERT_REGIME_SEEDS)
        if kernel != "flash_fwd" else None,
        tolerance={str(t).split(".")[-1]: TOL[t] for t in FLASH_DTYPES},
        routes={"bfloat16": "flash_attention_mma.cu (mma.sync)",
                "float16": "flash_attention_mma.cu (mma.sync)",
                "float32": "flash_attention.cu (fp32 FMA)"},
        timed=timing[kernel], tf32=torch.backends.cuda.matmul.allow_tf32)
        for kernel in FLASH_KERNELS}


# -- the MoE and fused-Adam kernels -----------------------------------------

#: (case, T, C): the training phase's [1, 2048] and the serve phase's
#: prefill call (chunk 256 x 2), at Mixtral-8x7B's E 8, H 4096, top-2
MOE_CASES = [("train", 2048, 1024), ("serve_prefill", 512, 256)]
MOE_E, MOE_H, MOE_K = 8, 4096, 2
MOE_KERNELS = ("moe_dispatch", "moe_combine")
ADAM_KERNELS = ("multi_tensor_sqsum", "fused_adam")


def moe_inputs(T, C, dtype, gen, dev) -> tuple:
    """Tokens ``[T, H]``, an expert output ``[E, C, H]`` and a top-2
    routing with expert 0's logits raised by 1.5: expert 0 overflows
    (dropped assignments) while the others leave slots empty."""
    from deepspeed_tpu_torch.moe import top_k_gating_indices
    from deepspeed_tpu_torch.ops.kernels.moe_dispatch import \
        routing_to_indices
    logits = torch.randn(T, MOE_E, generator=gen, device=dev)
    logits[:, 0] += 1.5
    gi, _, _ = top_k_gating_indices(logits, MOE_K, C)
    src, flat = routing_to_indices(gi.expert_idx, gi.slot, gi.keep, MOE_E, C)
    tokens = torch.randn(T, MOE_H, generator=gen, device=dev).to(dtype)
    eo = torch.randn(MOE_E, C, MOE_H, generator=gen, device=dev).to(dtype)
    return tokens, eo, src, flat, gi.gate.t().contiguous()


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def moe_bounds(tokens, src, flat) -> dict:
    """Least time per kernel for this routing: dispatch reads each routed
    token once and writes every slot (empty ones as zeros) and reads the
    index; combine reads each kept assignment's row, the indices and gates,
    and writes every token's row, 2 flops per kept element."""
    T, H = tokens.shape
    el = tokens.element_size()
    slots = src.numel()
    routed = int(torch.unique(src[src >= 0]).numel())
    kept = int((flat < slots).sum())
    peak = PEAK_FLOPS[tokens.dtype]
    return {"moe_dispatch": bound((routed + slots) * H * el + slots * 4, 0,
                                  peak),
            "moe_combine": bound((kept + T) * H * el + flat.numel() * 8,
                                 2 * kept * H, peak)}


def phase_moe_kernels(dev) -> dict:
    """Dispatch and combine against their plain versions at every
    ``MOE_CASES`` shape, bf16 and fp32; then timed at the train shape in
    bf16 beside the plain versions, a library call (``index_select`` on a
    zero-row-padded token table; ``F.embedding_bag`` with the gates as
    per-sample weights on the zero-row-padded expert output, built outside
    the timed call) and the bound."""
    from deepspeed_tpu_torch.ops.kernels import (combine_reference,
                                                 dispatch_reference,
                                                 moe_combine_fwd,
                                                 moe_dispatch_fwd)

    gen = torch.Generator(device=dev).manual_seed(2468)
    errs = {name: {} for name in MOE_KERNELS}
    for (case, T, C), dtype in itertools.product(
            MOE_CASES, (torch.bfloat16, torch.float32)):
        tokens, eo, src, flat, gates = moe_inputs(T, C, dtype, gen, dev)
        require(bool((src < 0).any()) and bool((flat == MOE_E * C).any()),
                f"moe {case}: no empty slot or no dropped assignment")
        got = moe_dispatch_fwd(tokens, src)
        want = dispatch_reference(tokens, src)
        y = moe_combine_fwd(eo, flat, gates)
        want_y = combine_reference(eo, flat, gates)
        torch.cuda.synchronize()
        key = f"{case}_{str(dtype).split('.')[-1]}"
        require(got.dtype == dtype and torch.equal(got, want),
                f"moe_dispatch {key}: not equal to the plain version")
        errs["moe_dispatch"][key] = 0.0
        require(y.dtype == dtype and y.shape == want_y.shape,
                f"moe_combine {key}: wrong dtype/shape")
        require(bool(torch.isfinite(y).all()), f"moe_combine {key}: "
                                               "non-finite")
        err = (y.float() - want_y.float()).abs()
        require(bool((err <= TOL[dtype] * (1 + want_y.float().abs())).all()),
                f"moe_combine {key}: max error {err.max().item()} over "
                f"tolerance {TOL[dtype]} x (1 + |plain|)")
        errs["moe_combine"][key] = err.max().item()

    case, T, C = MOE_CASES[0]
    sets = []
    for _ in range(3):  # 3 x 84 MB: no call finds its rows in L2
        tokens, eo, src, flat, gates = moe_inputs(T, C, torch.bfloat16, gen,
                                                  dev)
        padded = torch.cat([tokens, tokens.new_zeros(1, MOE_H)])
        rows = torch.where(src >= 0, src, T).reshape(-1).long()
        eo_padded = torch.cat([eo.reshape(-1, MOE_H),
                               eo.new_zeros(1, MOE_H)])
        sets.append((tokens, eo, src, flat, gates, padded, rows, eo_padded,
                     flat.long(), gates.to(torch.bfloat16)))
    tokens, eo, src, flat, gates, padded, rows, eo_padded, fl, gb = sets[0]
    lib = {"moe_dispatch": lambda s: torch.index_select(s[5], 0, s[6]),
           "moe_combine": lambda s: F.embedding_bag(
               s[8], s[7], per_sample_weights=s[9], mode="sum")}
    lib_err = {
        "moe_dispatch": (lib["moe_dispatch"](sets[0]).reshape(eo.shape)
                         .float() - dispatch_reference(tokens, src).float()
                         ).abs().max().item(),
        "moe_combine": (lib["moe_combine"](sets[0]).float()
                        - combine_reference(eo, flat, gates).float()
                        ).abs().max().item()}
    run = {"moe_dispatch": (lambda s: moe_dispatch_fwd(s[0], s[2]),
                            lambda s: dispatch_reference(s[0], s[2])),
           "moe_combine": (lambda s: moe_combine_fwd(s[1], s[3], s[4]),
                           lambda s: combine_reference(s[1], s[3], s[4]))}
    bounds = moe_bounds(tokens, src, flat)
    cycles = sleep_cycles_per_ms()
    out = {}
    for name, (fn, plain) in run.items():
        out[name] = dict(
            kernel_time=time_ms([lambda s=s: fn(s) for s in sets], cycles),
            plain_time=time_ms([lambda s=s: plain(s) for s in sets], cycles),
            library_time=time_ms([lambda s=s: lib[name](s) for s in sets],
                                 cycles),
            library_call=("torch.index_select on the zero-row-padded tokens"
                          if name == "moe_dispatch" else
                          "F.embedding_bag(flat_idx, padded expert output, "
                          "per_sample_weights=gates, mode='sum')"),
            library_max_abs_err_vs_plain=lib_err[name],
            bound_ms=bounds[name][0], bound_by=bounds[name][1],
            max_abs_err=max(errs[name].values()),
            max_abs_err_by_case=errs[name],
            checked_at={c: dict(T=t, E=MOE_E, C=cc, H=MOE_H, k=MOE_K)
                        for c, t, cc in MOE_CASES},
            tolerance=("exact" if name == "moe_dispatch" else
                       {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16]}),
            timed_at=f"bf16, {case}: T {T}, E {MOE_E}, C {C}, H {MOE_H}",
            dropped_assignments=int((flat == MOE_E * C).sum()),
            empty_slots=int((src < 0).sum()))
    del sets, tokens, eo, src, flat, gates, padded, rows, eo_padded, fl, gb
    torch.cuda.empty_cache()
    out["moe_dispatch"]["crossover"] = moe_crossover(dev)
    out["moe_dispatch_ep"] = moe_ep_pattern(dev, gen, cycles)
    out["moe_dispatch_sp"] = moe_sp_pattern(dev, gen, cycles)
    return out


#: the expert-parallel pattern: train_moe_ep's global routing of 2 ranks'
#: 2048 tokens (C 2048), seen from rank 0
MOE_EP_TOKENS, MOE_EP_C = 2048, 2048
#: the expert x seq pattern: train_moe_ep_sp's global routing of its
#: [2, MOE_MESH_SEQ] batch at ep 2 x sp 2 (Mixtral-8x7B's capacity factor
#: 2: C = 2 x 4096 x 2 / 8 = 2048), seen from a rank's MOE_MESH_SEQ / 2
#: tokens; its global ids come from ``sharded_moe.global_token_ids``
MOE_SP_RANKS = 4


def moe_view_inputs(dtype, gen, dev, ids, T_glob: int, C: int) -> tuple:
    """One rank's view of a global routing of ``T_glob`` tokens
    (``sharded_moe.local_routing``), its own at global ``ids``: its
    tokens ``[T, H]``, ``src_idx`` with every other rank's slot empty, and
    its rows of ``flat_idx`` and the gates."""
    from deepspeed_tpu_torch.moe import top_k_gating_indices
    from deepspeed_tpu_torch.moe.sharded_moe import local_routing
    from deepspeed_tpu_torch.ops.kernels.moe_dispatch import \
        routing_to_indices
    logits = torch.randn(T_glob, MOE_E, generator=gen, device=dev)
    logits[:, 0] += 1.5
    gi, _, _ = top_k_gating_indices(logits, MOE_K, C)
    src, flat = routing_to_indices(gi.expert_idx, gi.slot, gi.keep, MOE_E, C)
    src, flat, gates = local_routing(src, flat, gi.gate.t().contiguous(),
                                     ids)
    tokens = torch.randn(ids.numel(), MOE_H, generator=gen, device=dev).to(
        dtype)
    eo = torch.randn(MOE_E, C, MOE_H, generator=gen, device=dev).to(dtype)
    return tokens, eo, src, flat, gates.contiguous()


def moe_ep_inputs(dtype, gen, dev, rank: int = 0) -> tuple:
    """Rank ``rank``'s view of train_moe_ep's routing."""
    T = MOE_EP_TOKENS
    return moe_view_inputs(dtype, gen, dev, torch.arange(
        rank * T, (rank + 1) * T, device=dev), MOE_EP * T, MOE_EP_C)


def moe_sp_inputs(dtype, gen, dev, rank: int = 0) -> tuple:
    """Rank ``rank``'s view of train_moe_ep_sp's routing over expert x
    seq: its chunk of its data coordinate's row."""
    from deepspeed_tpu_torch.moe.sharded_moe import global_token_ids
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.parallel.mesh import ProcessMesh
    mesh = ProcessMesh(MeshLayout(ep=2, sp=2), rank=rank)
    ids, _ = global_token_ids(mesh, (1, MOE_MESH_SEQ // 2, MOE_H))
    T = 2 * MOE_MESH_SEQ
    return moe_view_inputs(dtype, gen, dev, ids.to(dev), T,
                           MOE_K * T * 2 // MOE_E)


def moe_ep_pattern(dev, gen, cycles: float) -> dict:
    """#11 (and #12) at the expert-parallel pattern (:func:`moe_view_
    pattern` of :func:`moe_ep_inputs`, ranks 0 and 1)."""
    return moe_view_pattern(dev, gen, cycles, moe_ep_inputs, (0, 1),
                            f"rank 0 of {MOE_EP}: T {MOE_EP_TOKENS} of "
                            f"{MOE_EP * MOE_EP_TOKENS}, E {MOE_E}, C "
                            f"{MOE_EP_C}, H {MOE_H}")


def moe_sp_pattern(dev, gen, cycles: float) -> dict:
    """#11 (and #12) at the expert x seq pattern (:func:`moe_sp_inputs`,
    the first and the last of the ``MOE_SP_RANKS``)."""
    T = 2 * MOE_MESH_SEQ
    return moe_view_pattern(dev, gen, cycles, moe_sp_inputs,
                            (0, MOE_SP_RANKS - 1),
                            f"rank 0 of ep 2 x sp 2: T {T // MOE_SP_RANKS} "
                            f"of {T}, E {MOE_E}, C "
                            f"{MOE_K * T * 2 // MOE_E}, H {MOE_H}")


def moe_view_pattern(dev, gen, cycles: float, make, ranks: tuple,
                     timed_at: str) -> dict:
    """#11 (and #12) at one rank's view of a global routing (``make(dtype,
    gen, dev, rank)``), ``ranks`` in bf16 and fp32, against their plain
    versions (dispatch exact); #11 timed in bf16 at the first rank beside
    its plain version, ``index_select`` and its bound."""
    from deepspeed_tpu_torch.ops.kernels import (combine_reference,
                                                 dispatch_reference,
                                                 moe_combine_fwd,
                                                 moe_dispatch_fwd)
    errs, empty = {}, {}
    for rank, dtype in itertools.product(ranks, (torch.bfloat16,
                                                 torch.float32)):
        tokens, eo, src, flat, gates = make(dtype, gen, dev, rank)
        key = f"rank{rank}_{str(dtype).split('.')[-1]}"
        empty[key] = float((src < 0).float().mean())
        got = moe_dispatch_fwd(tokens, src)
        y = moe_combine_fwd(eo, flat, gates)
        want_y = combine_reference(eo, flat, gates).float()
        torch.cuda.synchronize()
        require(torch.equal(got, dispatch_reference(tokens, src)),
                f"moe_dispatch ({timed_at}) {key}: not equal to the plain "
                "version")
        err = (y.float() - want_y).abs()
        require(bool((err <= TOL[dtype] * (1 + want_y.abs())).all()),
                f"moe_combine ({timed_at}) {key}: max error "
                f"{err.max().item()}")
        errs[key] = err.max().item()
        del tokens, eo, src, flat, gates, got, y, want_y, err
    sets = []
    for _ in range(3):
        tokens, _, src, flat, _ = make(torch.bfloat16, gen, dev, ranks[0])
        T = tokens.shape[0]
        padded = torch.cat([tokens, tokens.new_zeros(1, MOE_H)])
        rows = torch.where(src >= 0, src, T).reshape(-1).long()
        sets.append((tokens, src, padded, rows))
    tokens, src, padded, rows = sets[0]
    E, C = src.shape
    lib_err = (torch.index_select(padded, 0, rows).reshape(
        E, C, MOE_H).float() - dispatch_reference(
        tokens, src).float()).abs().max().item()
    b = moe_bounds(tokens, src, flat)["moe_dispatch"]
    out = dict(
        kernel_time=time_ms([lambda s=s: moe_dispatch_fwd(s[0], s[1])
                             for s in sets], cycles),
        plain_time=time_ms([lambda s=s: dispatch_reference(s[0], s[1])
                            for s in sets], cycles),
        library_time=time_ms([lambda s=s: torch.index_select(s[2], 0, s[3])
                              for s in sets], cycles),
        library_call="torch.index_select on the zero-row-padded tokens",
        library_max_abs_err_vs_plain=lib_err,
        bound_ms=b[0], bound_by=b[1], max_abs_err=0.0,
        combine_max_abs_err_by_case=errs, empty_slot_share=empty,
        tolerance="exact", timed_at=f"bf16, {timed_at}")
    del sets, tokens, src, padded, rows
    torch.cuda.empty_cache()
    return out


#: token counts of the dense-vs-kernel crossover scan (top-2 of 8, capacity
#: factor 2, H 4096, bf16): T·E·C from 256 to 4.2 M
CROSSOVER_T = (8, 16, 32, 64, 128, 256, 512, 1024)


def moe_crossover(dev) -> list:
    """The MoE layer's two rungs without the experts, timed at each
    ``CROSSOVER_T``, whole (dense: ``top_k_gating`` and the two one-hot
    einsums; kernel: ``top_k_gating_indices``, the index form, dispatch and
    combine) and as data movement alone (the einsums on prebuilt masks
    against the two kernels on prebuilt indices; the same routing)."""
    from deepspeed_tpu_torch.moe import TopKGate
    from deepspeed_tpu_torch.ops.kernels import moe_combine_fwd, \
        moe_dispatch_fwd
    from deepspeed_tpu_torch.ops.kernels.moe_dispatch import \
        routing_to_indices

    gate = TopKGate(num_experts=MOE_E, k=MOE_K, capacity_factor=2.0)
    gen = torch.Generator(device=dev).manual_seed(97)
    cycles = sleep_cycles_per_ms()
    rows = []
    for T in CROSSOVER_T:
        C = gate.capacity(T)
        x = torch.randn(T, MOE_H, generator=gen, device=dev).to(
            torch.bfloat16)
        wg = torch.randn(MOE_H, MOE_E, generator=gen, device=dev)
        eo = torch.randn(MOE_E, C, MOE_H, generator=gen, device=dev).to(
            torch.bfloat16)

        def dense():
            combine, dispatch, _, _ = gate(wg, x)
            torch.einsum("tec,th->ech", dispatch.to(x.dtype), x)
            return torch.einsum("tec,ech->th", combine.to(x.dtype), eo)

        def kernels():
            gi, _, _ = gate.route(wg, x)
            src, flat = routing_to_indices(gi.expert_idx, gi.slot, gi.keep,
                                           MOE_E, C)
            moe_dispatch_fwd(x, src)
            return moe_combine_fwd(eo, flat, gi.gate.t())

        combine, dispatch, _, _ = gate(wg, x)
        masks = (dispatch.to(x.dtype), combine.to(x.dtype))
        gi, _, _ = gate.route(wg, x)
        src, flat = routing_to_indices(gi.expert_idx, gi.slot, gi.keep,
                                       MOE_E, C)
        gates = gi.gate.t().contiguous()

        def move_dense():
            torch.einsum("tec,th->ech", masks[0], x)
            return torch.einsum("tec,ech->th", masks[1], eo)

        def move_kernels():
            moe_dispatch_fwd(x, src)
            return moe_combine_fwd(eo, flat, gates)

        row = dict(T=T, C=C, tec=T * MOE_E * C)
        for name, fn in (("dense", dense), ("kernel", kernels),
                         ("move_dense", move_dense),
                         ("move_kernel", move_kernels)):
            t = time_ms([fn], cycles)
            row[name + "_ms"] = t["ms"]
            row[name + "_host_hidden"] = t["host_hidden"]
        rows.append(row)
    return rows


def mixtral_train_shapes(cfg) -> list:
    """The parameter shapes of a Mixtral model, in ``parameters()`` order
    (embedding, layers, final norm, head), without allocating them."""
    from deepspeed_tpu_torch.models.mixtral import MixtralDecoderLayer
    layer = [tuple(p.shape) for p in MixtralDecoderLayer(cfg,
                                                         "meta").parameters()]
    V, H = cfg.vocab_size, cfg.hidden_size
    return [(V, H)] + layer * cfg.num_layers + [(H,), (V, H)]


def adam_tensor(shape, seed: int, i: int, dev) -> tuple:
    """Parameter ``i``'s p and gradient (scale 1e-3), drawn again the same
    for the check; fresh moments are zeros."""
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + i)
    p = torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev).mul_(1e-3)
    return p, g


#: the Adam check's two steps: (count, gradient multiplier, config) — AdamW
#: from fresh moments, then Adam with L2 decay on the moments it left
ADAM_CHECK_STEPS = ((1, 0.5, dict(weight_decay=0.1, decoupled_wd=True)),
                    (2, 0.25, dict(weight_decay=0.1, decoupled_wd=False)))


def phase_adam_kernels(dev, shapes, seed: int) -> dict:
    """The gradient norm and two fused Adam steps over ``shapes`` (fp32, lr
    1e-4, the :data:`ADAM_CHECK_STEPS`: both weight-decay branches, a
    gradient multiplier on the device), against their plain versions: the
    norm within 1e-6 relative, and after each step the moments and the
    parameters bit-equal, tensor by tensor (the plain version's inputs are
    drawn again from the same seeds and stepped again); then timed beside
    the plain versions, the library's ``torch._foreach_norm`` /
    ``torch._fused_adamw_`` and the bounds (4 and 28 bytes an element)."""
    from deepspeed_tpu_torch.ops.kernels import (FusedAdamConfig,
                                                 MultiTensorPlan, fused_adam,
                                                 reference_adam,
                                                 reference_sqsum, tree_sqsum)

    lr = 1e-4
    steps = [(count, torch.full((), mult, device=dev), FusedAdamConfig(**kw))
             for count, mult, kw in ADAM_CHECK_STEPS]
    pg = [adam_tensor(s, seed, i, dev) for i, s in enumerate(shapes)]
    params, grads = [p for p, _ in pg], [g for _, g in pg]
    del pg
    ms = [torch.zeros_like(p) for p in params]
    vs = [torch.zeros_like(p) for p in params]
    n = sum(p.numel() for p in params)
    plan = MultiTensorPlan(params)
    sq = tree_sqsum(grads, plan)
    sq_again = tree_sqsum(grads, plan)
    sq_plain = reference_sqsum(grads)
    torch.cuda.synchronize()
    sq_err = abs(sq.item() - sq_plain.item())
    require(sq_err <= 1e-6 * abs(sq_plain.item()),
            f"multi_tensor_sqsum: {sq.item()} != plain {sq_plain.item()}")
    require(torch.equal(sq, sq_again), "multi_tensor_sqsum: not repeatable")
    adam_err = 0.0
    for k, (count, mult, cfg) in enumerate(steps):
        fused_adam(params, grads, ms, vs, count, lr, mult, cfg, plan)
        torch.cuda.synchronize()
        for i, s in enumerate(shapes):
            p0, g0 = adam_tensor(s, seed, i, dev)
            m0, v0 = torch.zeros_like(p0), torch.zeros_like(p0)
            for c, mu, cf in steps[:k + 1]:
                reference_adam([p0], [g0], [m0], [v0], c, lr, mu, cf)
            for what, got, want in (("m", ms[i], m0), ("v", vs[i], v0),
                                    ("p", params[i], p0)):
                err = (got - want).abs().max().item()
                adam_err = max(adam_err, err)
                require(torch.equal(got, want),
                        f"fused_adam: step {count} ({cfg}): tensor {i} {s}: "
                        f"{what} not bit-equal (max error {err})")
            del p0, g0, m0, v0
        torch.cuda.empty_cache()
    count, mult, cfg = steps[0]
    counts = [torch.ones((), device=dev) for _ in params]
    lib_err = abs(torch.stack(torch._foreach_norm(grads)).square().sum()
                  .item() - sq_plain.item())
    cycles = sleep_cycles_per_ms()
    timing = {
        "multi_tensor_sqsum": dict(
            kernel_time=time_ms([lambda: tree_sqsum(grads, plan)], cycles),
            plain_time=time_ms([lambda: reference_sqsum(grads)], cycles,
                               per_rep=3),
            library_time=time_ms([lambda: torch._foreach_norm(grads)],
                                 cycles),
            library_call="torch._foreach_norm(grads) (per-tensor norms)",
            library_abs_err_vs_plain=lib_err,
            max_abs_err=sq_err, relative_err=sq_err / sq_plain.item()),
        "fused_adam": dict(
            kernel_time=time_ms([lambda: fused_adam(
                params, grads, ms, vs, 3, lr, mult, cfg, plan)], cycles,
                per_rep=3),
            plain_time=time_ms([lambda: reference_adam(
                params, grads, ms, vs, 3, lr, mult, cfg)], cycles,
                per_rep=3),
            library_time=time_ms([lambda: torch._fused_adamw_(
                params, grads, ms, vs, [], counts, lr=lr, beta1=cfg.b1,
                beta2=cfg.b2, weight_decay=cfg.weight_decay, eps=cfg.eps,
                amsgrad=False, maximize=False)], cycles, per_rep=3),
            library_call="torch._fused_adamw_ over the same lists",
            max_abs_err=adam_err,
            checked="moments and parameters bit-equal after an AdamW "
                    "step and an L2 Adam step")}
    peak = PEAK_FLOPS[torch.float32]
    for name, nbytes, flops in (("multi_tensor_sqsum", 4 * n, 2 * n),
                                ("fused_adam", 28 * n, 17 * n)):
        b, by = bound(nbytes, flops, peak)
        timing[name].update(bound_ms=b, bound_by=by, elements=n,
                            tensors=len(shapes), dtype="float32",
                            tolerance=("1e-6 relative" if name ==
                                       "multi_tensor_sqsum" else "exact"))
    del params, grads, ms, vs, counts, steps, plan
    torch.cuda.empty_cache()
    return timing


# -- block-sparse attention ---------------------------------------------------

SPARSE_KERNELS = ("block_sparse_fwd", "block_sparse_bwd_dq",
                  "block_sparse_bwd_dkv")


def sparse_config(family: str, h: int, **kw):
    """A sparsity config of the port with ``num_heads=h``: a class of
    ``ops/sparse_attention.py``, or ``EmptyTail`` (the JAX tests' Fixed
    layout whose last 4 cell rows attend nothing)."""
    import importlib
    sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")
    if family != "EmptyTail":
        return getattr(sa, family)(num_heads=h, **kw)

    class EmptyTail(sa.FixedSparsityConfig):
        def _head_layout(self, seq_len, head):
            lay = super()._head_layout(seq_len, head)
            lay[-4:, :] = 0
            return lay
    return EmptyTail(num_heads=h, **kw)


#: (case, B, S, h, d, family, config, causal): the kernels' check grid —
#: every layout family, cells of 16 to 256 tokens, shared and per-head
#: layouts, causal and not, rows with no live key and keys nothing attends
#: (EmptyTail), an S that is not a multiple of the 64-row tile, and the
#: ``sparse`` phase's training shape (bench.py:1496-1506), which is timed
SPARSE_CHECKS = [
    ("bigbird_cb16_perhead", 2, 1024, 4, 64, "BigBirdSparsityConfig",
     dict(block=16, different_layout_per_head=True), True),
    ("bigbird_cb32", 2, 1024, 4, 128, "BigBirdSparsityConfig",
     dict(block=32), False),
    ("fixed_cb64", 1, 2048, 4, 64, "FixedSparsityConfig", dict(block=64),
     False),
    ("fixed_uni_cb16", 1, 1024, 4, 128, "FixedSparsityConfig",
     dict(block=16, attention="unidirectional"), True),
    ("longformer_cb128", 1, 2048, 4, 128, "BSLongformerSparsityConfig",
     dict(block=128), True),
    ("variable_cb256", 1, 4096, 2, 64, "VariableSparsityConfig",
     dict(block=256, num_local_blocks=2), True),
    ("bigbird_cb256_perhead", 1, 4096, 4, 128, "BigBirdSparsityConfig",
     dict(block=256, different_layout_per_head=True), False),
    ("empty_tail", 1, 256, 2, 64, "EmptyTail",
     dict(block=16, num_local_blocks=2, num_global_blocks=0), False),
    ("ragged_272", 2, 272, 4, 64, "BigBirdSparsityConfig",
     dict(block=16, different_layout_per_head=True), True),
    ("train", 2, 4096, 16, 64, "BigBirdSparsityConfig", dict(block=128),
     True),
]
SPARSE_TIMED = "train"
#: the random-``out`` regime's layouts (``hold_regime``, causal): cells
#: smaller than a tile (every walked tile masked) and cells of a tile
#: (wholly live tiles)
SPARSE_REGIME = {"bigbird_cb16_perhead": (
    "BigBirdSparsityConfig", dict(block=16, different_layout_per_head=True)),
    "fixed_cb64": ("FixedSparsityConfig", dict(block=64))}


def sparse_inputs(B, S, h, d, dtype, gen, dev) -> list:
    """q, k, v, do ``[B, S, h, d]``."""
    return [torch.randn(B, S, h, d, generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def sparse_plan(cfg, S: int, h: int, causal: bool) -> tuple:
    """(layout ``[H, nb, nb]``, the kernels' tile plan) of ``cfg``."""
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
        _norm_layout, tile_plan)
    layout = _norm_layout(cfg.make_layout(S), h)
    return layout, tile_plan(layout, cfg.block, S, causal)


def sparse_pairs(plan, B: int, h: int) -> int:
    """Live (q, k) token pairs of one call, over every batch row and head,
    counted from the layout's cells after causality."""
    per_head = plan.token_pairs()
    return int(B * (per_head.sum() if plan.heads == h else per_head[0] * h))


def plan_bytes(plan, column_major: bool = False) -> int:
    arrays = ((plan.col_ptr, plan.row_idx, plan.masks_t, plan.col_order)
              if column_major else
              (plan.row_ptr, plan.col_idx, plan.masks, plan.row_order))
    return sum(a.nbytes for a in arrays)


def walk_lengths(plan) -> dict:
    """The longest and the mean live list of the row walk (forward, dq
    pass) and of the column walk (dk/dv pass): the kernels' load balance."""
    rows, cols = np.diff(plan.row_ptr), np.diff(plan.col_ptr)
    return {"tiles_per_side": plan.nt, "live_tiles": plan.live_tiles,
            "max_row_tiles": int(rows.max()),
            "mean_row_tiles": float(rows.mean()),
            "max_col_tiles": int(cols.max()),
            "mean_col_tiles": float(cols.mean())}


def check_close(what: str, got, want, dtype) -> float:
    """``got`` within ``TOL[dtype] x (1 + |want|)`` of ``want``, finite, of
    its shape and dtype; returns the largest error."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: wrong dtype/shape")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    err = (got.float() - want.float()).abs()
    require(bool((err <= TOL[dtype] * (1 + want.float().abs())).all()),
            f"{what}: max error {err.max().item()} over tolerance "
            f"{TOL[dtype]} x (1 + |plain|)")
    return err.max().item()


def phase_sparse_kernels(dev) -> dict:
    """The three block-sparse kernels against their plain versions at every
    ``SPARSE_CHECKS`` case, bf16 and fp32, and fp16 on the first (the
    backward passes start from the plain forward's out and lse, so each
    kernel is held alone), and the backward passes on the random-``out``
    regime over the ``SPARSE_REGIME`` layouts; then timed at the training
    shape in bf16 beside the plain versions, SDPA with the boolean token
    mask, and the bound."""
    from deepspeed_tpu_torch.ops.kernels import (block_sparse_bwd_dkv,
                                                 block_sparse_bwd_dq,
                                                 block_sparse_bwd_plain,
                                                 block_sparse_fwd,
                                                 block_sparse_fwd_plain)
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import \
        token_mask
    from deepspeed_tpu_torch.ops.kernels.flash_attention import \
        attention_delta

    gen = torch.Generator(device=dev).manual_seed(8642)
    errs = {name: {} for name in SPARSE_KERNELS}
    for case, dtype in list(itertools.product(
            SPARSE_CHECKS, (torch.bfloat16, torch.float32))) + [
                (SPARSE_CHECKS[0], torch.float16)]:  # fp16 at one shape
        name, B, S, h, d, family, kw, causal = case
        cfg = sparse_config(family, h, **kw)
        layout, plan = sparse_plan(cfg, S, h, causal)
        q, k, v, do = sparse_inputs(B, S, h, d, dtype, gen, dev)
        out, lse = block_sparse_fwd(q, k, v, plan)
        want_out, want_lse = block_sparse_fwd_plain(q, k, v, layout,
                                                    cfg.block, causal)
        dq = block_sparse_bwd_dq(q, k, v, want_out, want_lse, do, plan)
        dk, dv = block_sparse_bwd_dkv(q, k, v, want_out, want_lse, do, plan)
        want = block_sparse_bwd_plain(q, k, v, want_out, want_lse, do,
                                      layout, cfg.block, causal)
        torch.cuda.synchronize()
        key = f"{name}_{str(dtype).split('.')[-1]}"
        for kernel, outputs in (
                ("block_sparse_fwd", ((out, want_out), (lse, want_lse))),
                ("block_sparse_bwd_dq", ((dq, want[0]),)),
                ("block_sparse_bwd_dkv", ((dk, want[1]), (dv, want[2])))):
            errs[kernel][key] = max(check_close(f"{kernel} {key}", g, w,
                                                dtype) for g, w in outputs)
        if family == "EmptyTail":  # the last 4 cells: no key, unattended
            require(bool((out[:, -64:] == 0).all())
                    and bool((lse[..., -64:] == 1e30).all())
                    and all(bool((t[:, -64:] == 0).all())
                            for t in (dq, dk, dv)),
                    f"{key}: a row with no key or an unattended key is "
                    "not zero")
        del q, k, v, do, out, lse, want_out, want_lse, dq, dk, dv, want
        torch.cuda.empty_cache()
    for label, (family, kw) in SPARSE_REGIME.items():
        cfg = sparse_config(family, REGIME_H, **kw)
        layout, plan = sparse_plan(cfg, REGIME_S, REGIME_H, True)
        hold_regime(
            lambda q, k, v, o, l, do: block_sparse_bwd_dq(q, k, v, o, l, do,
                                                          plan),
            lambda q, k, v, o, l, do: block_sparse_bwd_dkv(q, k, v, o, l, do,
                                                           plan),
            lambda q, k, v, o, l, do: block_sparse_bwd_plain(
                q, k, v, o, l, do, layout, cfg.block, True),
            {0: errs["block_sparse_bwd_dq"], 1: errs["block_sparse_bwd_dkv"]},
            f"random_out_{label}", dev)

    name, B, S, h, d, family, kw, causal = next(
        c for c in SPARSE_CHECKS if c[0] == SPARSE_TIMED)
    cfg = sparse_config(family, h, **kw)
    layout, plan = sparse_plan(cfg, S, h, causal)
    cb = cfg.block
    mask = token_mask(layout, cb, causal, S, device=dev)[None]
    sets, graphs = [], []
    for _ in range(3):  # 3 x 67 MB of q, k, v, do: past the 50 MB L2
        q, k, v, do = sparse_inputs(B, S, h, d, torch.bfloat16, gen, dev)
        out, lse = block_sparse_fwd_plain(q, k, v, layout, cb, causal)
        sets.append((q, k, v, do, out, lse, attention_delta(out, do)))
        leaves = [t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v)]
        graphs.append((leaves, do.transpose(1, 2)))

    def sdpa(q, k, v):  # [B, h, S, d] operands
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    held = [(leaves, sdpa(*leaves), g) for leaves, g in graphs]

    def sdpa_bwd(i):
        leaves, o, g = held[i]
        return torch.autograd.grad(o, leaves, g, retain_graph=True)

    def sdpa_fwd_bwd(i):
        leaves, g = graphs[i]
        return torch.autograd.grad(sdpa(*leaves), leaves, g)

    lib_err = (sdpa(*(t.transpose(1, 2) for t in sets[0][:3]))
               .transpose(1, 2).float() - sets[0][4].float()
               ).abs().max().item()
    run = {
        "block_sparse_fwd": (
            lambda s: block_sparse_fwd(s[0], s[1], s[2], plan),
            lambda s: block_sparse_fwd_plain(s[0], s[1], s[2], layout, cb,
                                             causal)),
        "block_sparse_bwd_dq": (
            lambda s: block_sparse_bwd_dq(s[0], s[1], s[2], s[4], s[5], s[3],
                                          plan, s[6]),
            lambda s: block_sparse_bwd_plain(s[0], s[1], s[2], s[4], s[5],
                                             s[3], layout, cb, causal)),
        "block_sparse_bwd_dkv": (
            lambda s: block_sparse_bwd_dkv(s[0], s[1], s[2], s[4], s[5],
                                           s[3], plan, s[6]),
            lambda s: block_sparse_bwd_plain(s[0], s[1], s[2], s[4], s[5],
                                             s[3], layout, cb, causal))}
    pairs = sparse_pairs(plan, B, h)
    bounds = attention_bounds(
        B, S, h, d, 2, pairs, SPARSE_KERNELS,
        (plan_bytes(plan), plan_bytes(plan), plan_bytes(plan, True)))
    cycles = sleep_cycles_per_ms()
    library = {
        "fwd": time_ms([lambda s=s: sdpa(*(t.transpose(1, 2)
                                           for t in s[:3]))
                        for s in sets], cycles),
        "bwd": time_ms([lambda i=i: sdpa_bwd(i) for i in range(3)], cycles),
        "fwd_bwd": time_ms([lambda i=i: sdpa_fwd_bwd(i) for i in range(3)],
                           cycles)}
    out = {}
    for kernel, (fn, plain) in run.items():
        fwd = kernel == "block_sparse_fwd"
        out[kernel] = dict(
            kernel_time=time_ms([lambda s=s: fn(s) for s in sets], cycles),
            plain_time=time_ms([lambda s=s: plain(s) for s in sets], cycles,
                               per_rep=5),
            library_time=library["fwd" if fwd else "bwd"],
            library_fwd_bwd_time=library["fwd_bwd"],
            library_call=("F.scaled_dot_product_attention(attn_mask=the "
                          "[1, 1, S, S] bool token mask)" if fwd else
                          "torch.autograd.grad of that call: dq, dk and dv "
                          "in one backward"),
            library_max_abs_err_vs_plain=lib_err,
            bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1],
            live_pairs=pairs, max_abs_err=max(errs[kernel].values()),
            max_abs_err_by_case=errs[kernel],
            checked_at={c[0]: dict(zip(("B", "S", "h", "d", "family",
                                        "config", "causal"), c[1:]))
                        for c in SPARSE_CHECKS},
            tolerance={str(t).split(".")[-1]: v for t, v in TOL.items()},
            checked_fp16_at=SPARSE_CHECKS[0][0],
            routes={"bfloat16": "block_sparse_attention_mma.cu (mma.sync)",
                    "float16": "block_sparse_attention_mma.cu (mma.sync)",
                    "float32": "block_sparse_attention.cu (fp32 FMA)"},
            random_out_regime=None if fwd else dict(
                B=1, S=REGIME_S, h=REGIME_H, d=(64, 128), seeds=REGIME_SEEDS,
                dead_rows=REGIME_DEAD, layouts=SPARSE_REGIME,
                dtypes=("bfloat16", "float16")),
            timed_at=f"bf16, {name}: B {B}, S {S}, h {h}, d {d}, {family} "
                     f"{kw}, causal {causal}", **walk_lengths(plan),
            tf32=torch.backends.cuda.matmul.allow_tf32)
    del sets, graphs, held, mask
    torch.cuda.empty_cache()
    return out


#: (case, B, S, h, d, family, config, causal, backward, dense timed): the
#: ``sparse`` phase's calls of ``sparse_attention(impl="auto")`` in bf16:
#: bench.py's training shape (1496-1506), its cb-16 (1378-1385) and S 8192
#: cb-64 (1427-1434) forwards, its S 8192 window sweep (1519-1533, timed
#: beside the port's causal flash attention and the dense masked path), a
#: per-head layout at Llama-3-8B's attention width, S 32768 (past the dense
#: limit), and the Fixed layout that is dense at the JAX blocks
SPARSE_PATH = [
    ("train", 2, 4096, 16, 64, "BigBirdSparsityConfig", dict(block=128),
     True, True, True),
    ("cb16_s4096", 1, 4096, 8, 64, "BigBirdSparsityConfig",
     dict(block=16, num_random_blocks=2, num_sliding_window_blocks=5),
     False, False, False),
    ("cb64_s8192", 1, 8192, 8, 64, "BigBirdSparsityConfig", dict(block=64),
     True, False, False),
] + [(f"win{w}_s8192", 1, 8192, 16, 64, "BigBirdSparsityConfig",
      dict(block=128, num_sliding_window_blocks=w), True, True, True)
     for w in (3, 7, 15)] + [
    ("8b_width_per_head", 1, 8192, 32, 128, "BigBirdSparsityConfig",
     dict(block=64, different_layout_per_head=True), True, True, False),
    ("bigbird_s32768", 1, 32768, 16, 64, "BigBirdSparsityConfig",
     dict(block=128), True, True, False),
    ("fixed_s4096", 1, 4096, 8, 64, "FixedSparsityConfig",
     dict(block=16, num_local_blocks=4, num_global_blocks=1), False, True,
     True),
]


def phase_sparse(dev) -> tuple:
    """``sparse_attention(impl="auto")`` forward (and backward through
    autograd) at every ``SPARSE_PATH`` case, the launch counts read from 0
    around them; each output (and gradient, on the kernel route) against the
    plain versions, in chunks of query rows; then each case timed, forward
    and forward plus backward, beside the dense masked path (the H100's
    crossover) and, in the window sweep, the port's flash attention."""
    import importlib
    from deepspeed_tpu_torch.ops.kernels import (block_sparse_bwd_plain,
                                                 block_sparse_fwd_plain,
                                                 block_sparse_kernel_attention,
                                                 flash_attention)
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import \
        config_entry
    sa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")

    gen = torch.Generator(device=dev).manual_seed(1357)
    rows, held = [], []
    reset_counts()
    for case in SPARSE_PATH:
        name, B, S, h, d, family, kw, causal, backward, _ = case
        cfg = sparse_config(family, h, **kw)
        q, k, v, do = sparse_inputs(B, S, h, d, torch.bfloat16, gen, dev)
        leaves = [t.requires_grad_() for t in (q, k, v)]
        before = read_counts()
        out = sa.sparse_attention(*leaves, cfg, causal=causal)
        grads = (torch.autograd.grad(out, leaves, do) if backward else ())
        torch.cuda.synchronize()
        after = read_counts()
        launches = {kn: after[kn] - before[kn] for kn in after}
        entry = config_entry(cfg, S, h, causal)
        kernel = entry.route.impl == "kernel"
        want = {kn: 0 for kn in after}
        if kernel:
            want.update(block_sparse_fwd=1,
                        block_sparse_bwd_dq=int(backward),
                        block_sparse_bwd_dkv=int(backward))
        require(launches == want, f"sparse {name}: launches {launches}, "
                                  f"want {want}")
        require(all(bool(torch.isfinite(g).all()) for g in grads),
                f"sparse {name}: a non-finite gradient")
        layout, cb = entry.layout, cfg.block
        with torch.no_grad():
            p_out, p_lse = block_sparse_fwd_plain(q, k, v, layout, cb, causal)
            err = {"out": check_close(f"sparse {name} out", out.detach(),
                                      p_out, torch.bfloat16)}
            if kernel and backward:
                for g, w, nm in zip(grads, block_sparse_bwd_plain(
                        q, k, v, p_out, p_lse, do, layout, cb, causal),
                        ("dq", "dk", "dv")):
                    err[nm] = check_close(f"sparse {name} {nm}", g, w,
                                          torch.bfloat16)
        plan = entry.plan
        pairs = (sparse_pairs(plan, B, h) if kernel else
                 sparse_pairs(sparse_plan(cfg, S, h, causal)[1], B, h))
        achievable = S * (S + 1) // 2 if causal else S * S
        rows.append(dict(
            case=name, B=B, S=S, h=h, d=d, family=family, config=kw,
            causal=causal, backward=backward, route=entry.route.impl,
            jax_blocks=[entry.route.block_q, entry.route.block_k],
            coarse_live_fraction=entry.route.live_fraction,
            token_live_fraction=pairs / (B * h * achievable),
            live_pairs=pairs, launches=launches, max_abs_err_vs_plain=err,
            **(walk_lengths(plan) if kernel else {})))
        held.append((case, cfg, [t.detach().requires_grad_()
                                 for t in (q, k, v)], do, entry))
        del out, grads, p_out, p_lse, leaves
        torch.cuda.empty_cache()
    total = read_counts()

    cycles = sleep_cycles_per_ms()
    flash_ms = {}
    for row, (case, cfg, leaves, do, entry) in zip(rows, held):
        name, B, S, h, d, family, kw, causal, backward, dense = case
        per_rep = 15 if S <= 4096 else (5 if S <= 8192 else 2)

        def fwd():
            with torch.no_grad():
                return sa.sparse_attention(*leaves, cfg, causal=causal)

        def fwd_bwd(fn=lambda *t: sa.sparse_attention(*t, cfg,
                                                      causal=causal)):
            return torch.autograd.grad(fn(*leaves), leaves, do)

        row["fwd_time"] = time_ms([fwd], cycles, per_rep=per_rep)
        if backward:
            row["fwd_bwd_time"] = time_ms([fwd_bwd], cycles, per_rep=per_rep)
        if dense:  # the other route at the same inputs: the crossover
            other = ((lambda *t: sa.sparse_attention(*t, cfg, causal=causal,
                                                     impl="dense"))
                     if entry.route.impl == "kernel" else
                     (lambda *t: block_sparse_kernel_attention(
                         *t, entry.layout, cfg.block, causal)))
            key = ("dense" if entry.route.impl == "kernel" else "kernel")
            row[f"{key}_fwd_bwd_time"] = time_ms(
                [lambda: fwd_bwd(other)], cycles, per_rep=per_rep)
        if name.startswith("win"):  # bench.py's vs_flash, one flash a shape
            if (B, S, h, d) not in flash_ms:
                flash_ms[(B, S, h, d)] = time_ms(
                    [lambda: fwd_bwd(lambda *t: flash_attention(
                        *t, causal=True))], cycles, per_rep=per_rep)
            row["flash_fwd_bwd_time"] = flash_ms[(B, S, h, d)]
            row["vs_flash"] = (flash_ms[(B, S, h, d)]["ms"]
                               / row["fwd_bwd_time"]["ms"])
        torch.cuda.empty_cache()
    del held
    torch.cuda.empty_cache()
    return rows, {kn: total[kn] for kn in SPARSE_KERNELS}


# -- phase 4 ---------------------------------------------------------------

SERVE_REQUESTS = [  # (prompt length, max_new_tokens, class); the first two
    (712, 48, "interactive"),   # start with the shared 512-token header
    (812, 40, "batch"),
    (64, 64, "interactive"),
    (1500, 32, "background"),
    (900, 56, "batch"),
    (256, 40, "background"),
    (1200, 36, "interactive"),
    (128, 60, "background"),
]


def serve(model, rng, *, cache_config, header_len, requests, **engine) -> dict:
    """Serve ``requests`` through ``build_serving_frontend``; the first two
    share a ``header_len`` header, and the second is submitted once the
    first's prefill is done so the prefix cache can hit.  ``tokens`` holds
    every request's tokens (the callers drop it from their lines)."""
    from deepspeed_tpu_torch import build_serving_frontend

    V = model.config.vocab_size
    header = rng.integers(0, V, header_len).tolist()
    prompts = []
    for i, (n, _, _) in enumerate(requests):
        body = rng.integers(0, V, n - (header_len if i < 2 else 0)).tolist()
        prompts.append((header if i < 2 else []) + body)
    fe = build_serving_frontend(model, cache_config=cache_config,
                                device=model.device, **engine)
    eng = fe.router.replicas[0].engine
    reset_counts()
    t0 = time.perf_counter()
    handles = {0: fe.submit(prompts[0], requests[0][1], requests[0][2])}
    for i in range(2, len(requests)):
        handles[i] = fe.submit(prompts[i], requests[i][1], requests[i][2])
    first = handles[0]
    while first.request is None or first.request.prefilled < len(prompts[0]):
        fe.pump()
    handles[1] = fe.submit(prompts[1], requests[1][1], requests[1][2])
    fe.run_until_idle()  # every engine step ends in a device-to-host copy
    wall = time.perf_counter() - t0
    launches = read_counts()
    results = {i: h.result() for i, h in handles.items()}
    for i, (n, budget, _) in enumerate(requests):
        require(len(results[i]) == budget,
                f"serve: request {i} returned {len(results[i])} of "
                f"{budget} tokens")
        require(all(0 <= t < V for t in results[i]),
                f"serve: request {i} produced ids outside the vocabulary")
    hit = fe.prefix_hit_rate()
    require(hit > 0, "serve: the shared header never hit the prefix cache")
    st = eng.stats
    ttft = sorted(h.ttft_ms for h in handles.values())
    generated = sum(len(r) for r in results.values())
    return {"wall_s": wall, "requests": len(requests),
            "prompt_tokens_prefilled": st["prefill_tokens"],
            "generated_tokens": generated,
            "prefix_hit_rate": hit,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)),
            "decode_steps": st["decode_steps"],
            "decode_bursts": st["decode_bursts"],
            "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
            "prefill_calls": st["prefill_calls"],
            "prefill_call_ms": st["prefill_s"] / st["prefill_calls"] * 1e3,
            "decode_tokens_per_s": st["decode_tokens"] / st["decode_s"],
            "prefill_tokens_per_s": st["prefill_tokens"] / st["prefill_s"],
            "total_tokens_per_s": (st["prefill_tokens"] + generated) / wall,
            "launches": launches,
            "tokens": [results[i] for i in range(len(requests))]}


#: decode bursts (of ``decode_burst`` steps each) under the profiler
TRACE_BURSTS = 3


def kernel_class(name: str) -> str:
    """The bucket of a device event of the serving trace."""
    low = name.lower()
    if "gqa_decode" in low:
        return "paged_attention"
    if any(t in low for t in ("gemm", "cutlass", "nvjet", "xmma", "cublas")):
        return "cublas"
    if low.startswith(("memcpy", "memset")):
        return "copies"
    return "other"


def trace_decode(model) -> dict:
    """One ``torch.profiler`` trace of the v2 engine's decode steps: the
    serve phase's pool and knobs, 8 slots of 512-token prompts, every
    prompt prefilled, one burst to warm up, then ``TRACE_BURSTS`` bursts
    traced.  Device time by class (the paged kernel, cuBLAS's GEMMs,
    copies, the rest) as shares of the device's busy time, and the
    device's idle share between the traced window's first and last device
    event (the host's launches leave the gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch import KVCacheConfig, build_engine_v2

    rng = np.random.default_rng(7)
    eng = build_engine_v2(model, cache_config=KVCacheConfig(
        num_blocks=1025, block_size=16, max_seq_len=2048),
        max_batch_slots=8, prefill_chunk=256, prefill_batch=2,
        decode_burst=8, device=model.device)
    for _ in range(8):
        eng.put(rng.integers(0, model.config.vocab_size, 512).tolist(),
                max_new_tokens=8 * (TRACE_BURSTS + 2))
    while eng.scheduler.waiting or eng.scheduler.prefilling:
        eng.step()
    eng.step()  # warm-up burst
    steps0 = eng.stats["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACE_BURSTS):
            eng.step()  # each burst ends in a device-to-host copy
        wall = time.perf_counter() - t0
    steps = eng.stats["decode_steps"] - steps0
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"decode_steps": steps, "slots": 8, "prompt_len": 512,
           "host_ms_per_step": wall / steps * 1e3,
           "device_events": len(events)}
    require(events, "serve_trace: the profiler recorded no device events")
    busy, end = 0.0, -np.inf
    for _, a, b in sorted(events, key=lambda x: x[1]):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = max(b for *_, b in events) - min(a for _, a, _ in events)
    by_class, by_name = {}, {}
    for name, a, b in events:
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0) \
            + (b - a)
        by_name[name] = by_name.get(name, 0) + (b - a)
    total = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda x: -x[1])[:8]
    return dict(out, device_span_ms_per_step=span / steps / 1e3,
                device_busy_ms_per_step=busy / steps / 1e3,
                device_idle_share=1.0 - busy / span,
                share_of_device_time={k: v / total
                                      for k, v in by_class.items()},
                ms_per_step_by_class={k: v / steps / 1e3
                                      for k, v in by_class.items()},
                top_kernels_ms_per_step={n[:80]: v / steps / 1e3
                                         for n, v in top})


# -- phase 5 ---------------------------------------------------------------

def generate_v1(model, ids: torch.Tensor, n_new: int) -> dict:
    """``init_inference(...).generate`` (over the model's tensor-parallel
    split, if it has one); ``tokens`` holds the generated ids."""
    from deepspeed_tpu_torch import init_inference

    eng = init_inference(model, tensor_parallel={"tp_size": model.tp},
                         device=model.device)
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=n_new)
    out_host = out.cpu()
    wall = time.perf_counter() - t0
    launches = read_counts()
    B, S = ids.shape
    require(tuple(out_host.shape) == (B, S + n_new), "generate: wrong shape")
    require(torch.equal(out_host[:, :S], ids.cpu()),
            "generate: the prompt was not kept")
    require(bool(((out_host >= 0) & (out_host < model.config.vocab_size))
                 .all()), "generate: ids outside the vocabulary")
    return {"wall_s": wall, "batch": B, "prompt_len": S, "new_tokens": n_new,
            "tokens_per_s": B * n_new / wall, "launches": launches,
            "tokens": out_host[:, S:].tolist()}


# -- phase 6 ---------------------------------------------------------------

#: the agree phase's narrow fp32 model; ``agree_moe`` adds the experts
AGREE_MODEL = dict(vocab_size=32000, hidden_size=512, intermediate_size=1408,
                   num_layers=4, num_heads=8, num_kv_heads=2, max_seq_len=512,
                   dtype=torch.float32)
AGREE_MOE = dict(num_experts=4, top_k=2, capacity_factor=2.0,
                 moe_dispatch_impl="pallas")


#: agree_opt's model: OPT-1.3B's widths in fp32, ``num_layers 24 -> 4``
AGREE_OPT_LAYERS = 4


def agree(dev, seed: int, moe: bool = False, opt: bool = False) -> dict:
    """v2 greedy == v1 greedy (both through the kernels on ``dev``) == the
    CPU plain path's v1 greedy, on a narrow fp32 model, with and without a
    sliding window (``moe``: a Mixtral on the kernel rung, without drops;
    ``opt``: OPT-1.3B's widths at ``AGREE_OPT_LAYERS`` layers, no
    window)."""
    from deepspeed_tpu_torch import (KVCacheConfig, LlamaConfig, LlamaModel,
                                     MixtralConfig, MixtralModel, OPTConfig,
                                     OPTModel, build_engine_v2,
                                     init_inference)

    rng = np.random.default_rng(seed + 1)
    cfg_cls, model_cls, extra = ((MixtralConfig, MixtralModel, AGREE_MOE)
                                 if moe else (LlamaConfig, LlamaModel, {}))
    kernels = ["decode_attention", "paged_decode_attention"] + (
        list(MOE_KERNELS) if moe else [])
    out = {}
    for window in ((None,) if opt else (None, 48)):
        if opt:
            model_cls = OPTModel
            cfg = OPTConfig.opt_1_3b(num_layers=AGREE_OPT_LAYERS,
                                     dtype=torch.float32)
        else:
            cfg = cfg_cls(**AGREE_MODEL, **extra, sliding_window=window)
        model = model_cls(cfg, device=dev, seed=seed + 2)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (5, 37, 100, 260)]
        n_new = 16
        reset_counts()
        v2 = build_engine_v2(model, cache_config=KVCacheConfig(
            num_blocks=128, block_size=16, max_seq_len=512),
            max_batch_slots=4, prefill_chunk=64, decode_burst=8,
            device=dev).generate(prompts, max_new_tokens=n_new)
        v1 = init_inference(model, device=dev)
        cpu_model = model_cls(cfg, device="cpu")
        cpu_model.load_state_dict(model.state_dict())
        v1_cpu = init_inference(cpu_model, device="cpu")
        for p, got in zip(prompts, v2):
            want = v1.generate([p], max_new_tokens=n_new)[0, len(p):].tolist()
            ref = v1_cpu.generate([p], max_new_tokens=n_new)[0, len(p):]
            require(got == want, f"agree (window={window}): v2 {got} != v1 "
                                 f"{want} for a prompt of {len(p)}")
            require(want == ref.tolist(),
                    f"agree (window={window}): {dev} v1 {want} != CPU v1 "
                    f"{ref.tolist()}")
        launches = {k: v for k, v in read_counts().items() if k in kernels}
        if dev.type == "cuda":
            require(all(launches.values()),
                    f"agree: a kernel was not launched: {launches}")
        out[f"window_{window}"] = {"prompts": len(prompts),
                                   "new_tokens": n_new, "launches": launches}
    return out


# -- phases 7-9 ------------------------------------------------------------

#: bench.py's headline training model (12 x 768, 12/12 heads of 64)
HEADLINE = dict(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                num_layers=12, num_heads=12, num_kv_heads=12,
                max_seq_len=2048)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 12, 8, 2048
#: the headline's hybrid generate (train): greedy new tokens of
#: ``HEADLINE_HYBRID_ROWS`` rows of the batch's first 128 tokens
HEADLINE_HYBRID_NEW, HEADLINE_HYBRID_ROWS = 16, 2
WIDE_LAYERS, WIDE_STEPS, WIDE_BATCH = 4, 5, 1
PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]


def ds_config(model, micro_batch: int, fused_adam: bool = False,
              stage: int = 0, offload: bool = False) -> dict:
    """bench.build_engine's ds_config: AdamW lr 1e-4, ZeRO ``stage`` (0 by
    default), the model's dtype; the groups the port accepts without effect
    stay in.  ``fused_adam`` turns on the two-kernel Adam step, ``offload``
    ZeRO-Offload (``offload_optimizer`` cpu)."""
    zero = {"stage": stage}
    if offload:
        zero["offload_optimizer"] = {"device": "cpu"}
    return {"train_micro_batch_size_per_gpu": micro_batch,
            "kernels": {"fused_adam": fused_adam},
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "zero_optimization": zero,
            "bf16": {"enabled": model.config.dtype == torch.bfloat16},
            "steps_per_print": 0,
            "telemetry": {"enabled": True, "jsonl": False,
                          "prometheus": False},
            "tuning": {"auto_apply": False}}


TRAIN_KERNELS = FLASH_KERNELS + MOE_KERNELS + ADAM_KERNELS


def train_launches() -> dict:
    return {k: v for k, v in read_counts().items() if k in TRAIN_KERNELS}


def train(model, steps: int, batch: int, seq: int, seed: int,
          fused_adam: bool = False, data: Optional[dict] = None,
          hybrid_new: int = 0) -> dict:
    """``initialize`` then ``steps`` ``train_step``s on one repeated batch
    (``data``, or random ids); each step timed with CUDA events (on a CPU
    model, with the host clock).  The training kernels' launch counts are
    read from zero around the steps.  MFU counts the parameters a token
    runs through (a Mixtral's top-k experts): (6 N + 12 L S H) flops a
    token over 989 TFLOP/s.  ``hybrid_new`` turns on the hybrid engine and,
    after the steps, generates that many greedy tokens
    (:func:`hybrid_generate`)."""
    from deepspeed_tpu_torch import initialize

    dev, cfg = model.device, model.config
    conf = ds_config(model, batch, fused_adam)
    if hybrid_new:
        conf["hybrid_engine"] = {"enabled": True}
    engine, *_ = initialize(model=model, config=conf, device=dev)
    if data is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        data = {"input_ids": torch.randint(0, cfg.vocab_size, (batch, seq),
                                           generator=gen, device=dev)}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks, metrics = [], []
    for _ in range(steps):
        if cuda:
            a, b = event_pair()
            a.record()
        else:
            t0 = time.perf_counter()
        metrics.append(engine.train_step(data))
        if cuda:
            b.record()
            marks.append((a, b))
        else:
            marks.append((time.perf_counter() - t0) * 1e3)
    if cuda:
        torch.cuda.synchronize()
        marks = [a.elapsed_time(b) for a, b in marks]
    launches = train_launches()
    losses = [float(m["loss"]) for m in metrics]
    step_ms = statistics.median(marks[1:]) if steps > 1 else marks[0]
    tokens = batch * seq
    n_params = cfg.num_params()
    n_active = getattr(cfg, "active_params", cfg.num_params)()
    flops = (6 * n_active + 12 * cfg.num_layers * seq * cfg.hidden_size) \
        * tokens
    require(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"train: loss did not fall over {steps} steps: {losses}")
    hybrid = (hybrid_generate(engine, model, data["input_ids"], hybrid_new)
              if hybrid_new else None)
    return {"hybrid": hybrid, "steps": steps, "batch": batch, "seq": seq, "params": n_params,
            "active_params": n_active, "fused_adam": fused_adam,
            "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": [cfg.num_heads, getattr(cfg, "num_kv_heads",
                                             cfg.num_heads)],
            "head_dim": cfg.hd,
            "dtype": str(cfg.dtype).split(".")[-1], "remat": cfg.remat,
            "attn_impl": cfg.attn_impl, "loss": losses,
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "lr": [m["lr"] for m in metrics],
            "step_ms": step_ms, "step_ms_all": marks,
            "first_step_ms": marks[0],
            "tokens_per_s": tokens / step_ms * 1e3,
            "model_flops_per_step": flops,
            "mfu": flops / (step_ms / 1e3) / PEAK_BF16,
            "mfu_formula": "(6 N + 12 L S H) flops a token x tokens / step "
                           "time / 989 TFLOP/s (bf16 peak)",
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else None),
            "launches": launches}


def hybrid_generate(engine, model, ids: torch.Tensor, n_new: int) -> dict:
    """The hybrid engine's greedy ``generate`` on the trained weights (the
    first ``HEADLINE_HYBRID_ROWS`` rows' first 128 tokens): decode #1
    ``L x (n_new - 1)`` times, and the tokens ``init_inference`` gives on
    the same module."""
    from deepspeed_tpu_torch import init_inference

    prompt = ids[:HEADLINE_HYBRID_ROWS, :128]
    require(type(engine).__name__ == "DeepSpeedHybridEngine",
            f"hybrid: initialize returned a {type(engine).__name__}")
    reset_counts()
    t0 = time.perf_counter()
    got = engine.generate(prompt, max_new_tokens=n_new).cpu()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = init_inference(model, device=model.device).generate(
        prompt, max_new_tokens=n_new).cpu()
    L = model.config.num_layers
    require(launches["decode_attention"] == L * (n_new - 1),
            f"hybrid: decode launched {launches['decode_attention']} times, "
            f"want {L} x {n_new - 1}")
    require(torch.equal(got, want), f"hybrid: tokens {got[:, 128:].tolist()} "
                                    f"!= init_inference's "
                                    f"{want[:, 128:].tolist()}")
    return {"prompt": list(prompt.shape), "new_tokens": n_new,
            "tokens": got[:, 128:].tolist(), "equal_to_init_inference": True,
            "launches": launches, "wall_s": wall}


def require_train_launches(what: str, t: dict, moe: bool = False) -> None:
    """Each training kernel launched as often as its formula says: per
    step, the flash forward once per layer and once more under remat (the
    layer is recomputed in the backward), each flash backward pass once per
    layer; for a Mixtral, dispatch and combine as often as the flash
    forward; under ``fused_adam`` the norm and the Adam kernels once a
    step; every other training kernel never."""
    L, steps = t["layers"], t["steps"]
    fwd = steps * L * (2 if t["remat"] else 1)
    want = {"flash_fwd": fwd, "flash_bwd_dq": steps * L,
            "flash_bwd_dkv": steps * L,
            "moe_dispatch": fwd if moe else 0,
            "moe_combine": fwd if moe else 0,
            "multi_tensor_sqsum": steps if t["fused_adam"] else 0,
            "fused_adam": steps if t["fused_adam"] else 0}
    require(t["launches"] == want,
            f"{what}: launches {t['launches']}, want {want}")


#: the train_agree phase's narrow fp32 GQA model (d 64, S 200: a tail
#: tile); its Mixtral case adds four experts (T 400 is on the kernel rung)
AGREE_TRAIN = dict(vocab_size=2048, hidden_size=256, intermediate_size=512,
                   num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
                   dtype=torch.float32, param_dtype=torch.float32,
                   attn_impl="flash")
AGREE_TRAIN_CASES = {  # name: (window, Mixtral, fused Adam)
    "window_None": (None, False, False), "window_96": (96, False, False),
    "mixtral_fused_adam": (None, True, True)}


def _agree_run(cfg, model_cls, where, weights, seed, ids, fused: bool,
               clip: float) -> tuple:
    from deepspeed_tpu_torch import initialize

    model = model_cls(cfg, device=where, seed=seed + 4)
    model.load_state_dict(weights)
    engine, *_ = initialize(model=model, config=dict(
        ds_config(model, 2, fused), optimizer={
            "type": "AdamW", "params": {"lr": 1e-3}},
        gradient_clipping=clip), device=where)
    reset_counts()
    ms = [engine.train_step({"input_ids": ids}) for _ in range(5)]
    return ([float(m["loss"]) for m in ms],
            [float(m["grad_norm"]) for m in ms], train_launches())


def _max_rel(got, want) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def train_agree(dev, seed: int) -> dict:
    """Five ``train_step``s of a narrow fp32 model through the kernels on
    ``dev`` give the loss and grad-norm sequences of the same steps on the
    CPU's plain path, to 1e-4: a GQA Llama with and without a window, and a
    Mixtral under ``kernels.fused_adam`` (with clipping), whose fused and
    unfused runs on ``dev`` also agree to 1e-6."""
    from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, MixtralConfig,
                                     MixtralModel)

    out = {}
    for name, (window, moe, fused) in AGREE_TRAIN_CASES.items():
        cfg_cls, model_cls = ((MixtralConfig, MixtralModel) if moe
                              else (LlamaConfig, LlamaModel))
        cfg = cfg_cls(**AGREE_TRAIN, sliding_window=window,
                      **(dict(num_experts=4, top_k=2) if moe else {}))
        ids = torch.from_numpy(np.random.default_rng(seed + 3).integers(
            0, cfg.vocab_size, (2, 200)))
        weights = {k: v.cpu() for k, v in  # the same initial weights
                   model_cls(cfg, device=dev, seed=seed + 4)
                   .state_dict().items()}
        clip = 1.0 if fused else 0.0
        loss, norm, launches = _agree_run(cfg, model_cls, dev, weights, seed,
                                          ids, fused, clip)
        ref_loss, ref_norm, _ = _agree_run(cfg, model_cls,
                                           torch.device("cpu"), weights,
                                           seed, ids, fused, clip)
        row = {"loss": loss, "cpu_loss": ref_loss, "grad_norm": norm,
               "cpu_grad_norm": ref_norm, "launches": launches}
        for what, got, want in (("loss", loss, ref_loss),
                                ("grad_norm", norm, ref_norm)):
            rel = _max_rel(got, want)
            require(rel <= 1e-4, f"train_agree ({name}): {what} {got} != "
                                 f"CPU {want} (rel {rel})")
        if fused:
            plain_loss, plain_norm, _ = _agree_run(cfg, model_cls, dev,
                                                   weights, seed, ids, False,
                                                   clip)
            row.update(unfused_loss=plain_loss, unfused_grad_norm=plain_norm)
            for what, got, want in (("loss", loss, plain_loss),
                                    ("grad_norm", norm, plain_norm)):
                rel = _max_rel(got, want)
                require(rel <= 1e-6, f"train_agree ({name}): fused {what} "
                                     f"{got} != unfused {want} (rel {rel})")
        if dev.type == "cuda":
            require_train_launches(f"train_agree ({name})", dict(
                layers=cfg.num_layers, steps=5, remat=cfg.remat,
                fused_adam=fused, launches=launches), moe=moe)
        out[name] = row
    return out


# -- the data-parallel slice --------------------------------------------------

ZERO_RANKS, ZERO_STEPS, ZERO_TIMEOUT = 2, 2, 900
#: train_zero's depth: 3 of the headline's 12 layers (cut to keep the
#: script inside its limit on slower hosts)
ZERO_LAYERS = 3
#: train_zero's runs: (label, ZeRO stage, fused Adam)
ZERO_RUNS = (("stage0", 0, False), ("stage1", 1, False),
             ("stage2", 2, False), ("stage3", 3, False),
             ("stage3_fused_adam", 3, True))
#: the ZeRO-Offload run of train_zero: stage 2, the host Adam over each
#: rank's chunk; its losses against one process's offload run
ZERO_OFFLOAD_RUN, ZERO_OFFLOAD_STAGE = "stage2_offload", 2
#: each stage's losses against stage 0's: the gradient sums and updates are
#: the same operations (two ranks: every sum has two terms), so they are
#: expected bit-equal
ZERO_STAGE_RTOL = 1e-6
ZERO_AGREE_LAYERS, ZERO_AGREE_STEPS, ZERO_AGREE_ROWS = 2, 3, 4
#: train_zero's ZeRO-Infinity run: AGREE_TRAIN in fp32, one [1, 256] row a
#: rank, the stash path (clipping), ZERO_INF_STEPS steps; held against one
#: process with a rank's row a microbatch
ZERO_INF_RUN, ZERO_INF_STEPS, ZERO_INF_CLIP = "infinity_dp2", 2, 1.0
ZERO_NOTE = ("2 ranks on card 0 over gloo, every collective through pinned "
             "host memory: a correctness and memory check, the step time "
             "on the host clock is not a DP speed")


def zero_state_bytes(engine) -> dict:
    """This rank's persistent fp32 training state: masters (whole, or this
    rank's chunk of a cut leaf at stage 3), Adam's m and v, and the
    gradients a step holds (whole at stages 0-1, this rank's chunk of a cut
    leaf at stages 2-3)."""
    opt = engine.optimizer
    masters = sum(p.numel() for p in engine.params)
    moments = sum(t.numel() for t in opt.m + opt.v)
    grads = sum(p.numel() if pl is None or engine.zero_stage < 2
                else int(np.prod(pl.chunk_shape))
                for p, pl in zip(engine.params, engine.placements))
    if engine.zero_stage < 3:  # stages 0-2 hold whole masters
        masters = sum(int(np.prod(pl.full_shape)) if pl is not None
                      else p.numel()
                      for p, pl in zip(engine.params, engine.placements))
    return {"masters": 4 * masters, "moments": 4 * moments,
            "grads": 4 * grads, "total": 4 * (masters + moments + grads)}


def zero_rank_setup():
    """In a rank: card 0, the gloo group through the host (NCCL refuses
    two ranks on one card)."""
    from deepspeed_tpu_torch import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_distributed(dist_backend="gloo", device=dev)
    return dev


def zero_batch(seed: int, vocab: int, rows: int, dev) -> torch.Tensor:
    """The global batch, the same on every rank."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, (rows, TRAIN_SEQ), generator=gen,
                         device=dev)


def zero_train_rank(rank: int, seed: int) -> dict:
    """One rank of train_zero: bench.py's headline on this rank's half of
    a ``[TRAIN_BATCH, 2048]`` global batch, ``ZERO_STEPS`` steps of every
    ``ZERO_RUNS`` entry (a fresh model from this rank's seed each: the
    engine broadcasts rank 0's), with the kernels' launches, the state
    bytes and the peak memory of each."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    dev = zero_rank_setup()
    cfg = headline_cfg(ZERO_LAYERS)
    micro = TRAIN_BATCH // ZERO_RANKS
    ids = zero_batch(seed, cfg.vocab_size, TRAIN_BATCH, dev)
    rows = ids[rank * micro:(rank + 1) * micro]
    out = {}
    for label, stage, fused in ZERO_RUNS:
        gc.collect()  # the previous run's model and engine
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = LlamaModel(cfg, device=dev, seed=seed + rank)
        engine, *_ = initialize(model=model, config=ds_config(
            model, micro, fused, stage), device=dev)
        reset_counts()
        metrics, marks = [], []
        for _ in range(ZERO_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(engine.train_step({"input_ids": rows}))
            torch.cuda.synchronize()
            marks.append((time.perf_counter() - t0) * 1e3)
        out[label] = {
            "stage": stage, "fused_adam": fused,
            "loss": [float(m["loss"]) for m in metrics],
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "launches": train_launches(),
            "state_bytes": zero_state_bytes(engine),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "host_step_ms": marks,
            "cut_leaves": sum(p is not None for p in engine.placements),
            "leaves": len(engine.params)}
        del model, engine, metrics
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaModel(cfg, device=dev, seed=seed + rank)
    shapes = [tuple(p.shape) for p in model.parameters()]
    engine, *_ = initialize(model=model, config=ds_config(
        model, micro, stage=ZERO_OFFLOAD_STAGE, offload=True), device=dev)
    reset_counts()
    metrics = [engine.train_step({"input_ids": rows})
               for _ in range(ZERO_STEPS)]
    out[ZERO_OFFLOAD_RUN] = {
        "stage": ZERO_OFFLOAD_STAGE, "offload": "cpu",
        "loss": [float(m["loss"]) for m in metrics],
        "launches": train_launches(),
        "host_state_bytes": engine.offload_opt.state_bytes,
        "host_state_bytes_predicted": predicted_offload_bytes(
            shapes, ZERO_RANKS),
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del model, engine, metrics
    out[ZERO_INF_RUN] = zero_infinity_run(seed, dev, rank)
    out["agree"] = zero_agree_rank(rank, seed)  # train_zero_agree
    return out


def zero_inf_ids(seed: int, dev) -> torch.Tensor:
    """train_zero's Infinity batch: one ``[1, 256]`` row a rank."""
    return zero_batch(seed + 9, AGREE_TRAIN["vocab_size"], ZERO_RANKS,
                      dev)[:, :AGREE_TRAIN["max_seq_len"]]


def zero_infinity_run(seed: int, dev, rank: Optional[int]) -> dict:
    """``AGREE_TRAIN`` in fp32 under ``offload_param`` (cpu tier, the stash
    path: clipping): on rank ``rank``'s row at dp 2, or (``rank`` None) in
    one process on both rows, a row a microbatch (gas 2)."""
    from deepspeed_tpu_torch import LlamaConfig, initialize

    cfg = LlamaConfig(**AGREE_TRAIN)
    ids = zero_inf_ids(seed, dev)
    one = rank is None
    engine, *_ = initialize(
        model=stream_model(cfg, seed + 4 + (rank or 0), dev),
        config=infinity_config(1, torch.float32, gas=ZERO_RANKS if one
                               else 1, clip=ZERO_INF_CLIP), device=dev)
    rows = ids if one else ids[rank:rank + 1]
    sw = engine.infinity.swapper
    reset_counts()
    ms = [engine.train_step({"input_ids": rows})
          for _ in range(ZERO_INF_STEPS)]
    out = {"loss": [float(m["loss"]) for m in ms],
           "grad_norm": [float(m["grad_norm"]) for m in ms],
           "launches": train_launches(), "n_elems": sw.n_elems,
           "n_pad": sw.n_pad, "n_plane": sw.n_plane,
           "host_plane_bytes": sw.host_plane_bytes()}
    del engine, sw
    free_host_cache()
    return out


def offload_one_process(seed: int, dev) -> list:
    """The headline with ``offload_optimizer`` in one process on the whole
    global batch (rank 0's weights), a rank's rows a microbatch: the
    losses train_zero's offload ranks must give.  The split matters under
    the bf16 wire: each microbatch's weight gradient is rounded to bf16
    before the fp32 sum, as each rank's is before the reduce-scatter."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    model = LlamaModel(headline_cfg(ZERO_LAYERS), device=dev, seed=seed)
    engine, *_ = initialize(model=model, config=dict(ds_config(
        model, TRAIN_BATCH // ZERO_RANKS, offload=True),
        gradient_accumulation_steps=ZERO_RANKS), device=dev)
    ids = zero_batch(seed, model.config.vocab_size, TRAIN_BATCH, dev)
    losses = [float(engine.train_step({"input_ids": ids})["loss"])
              for _ in range(ZERO_STEPS)]
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def zero_family_launch(dev, seed: int) -> dict:
    """The launch train_zero, train_ckpt's ZeRO part, train_moe_ep,
    train_bert_zero and train_zeropp share (``ZERO_RANKS`` = ``MOE_EP``
    ranks on card 0 over gloo): each rank runs :func:`zero_train_rank`,
    :func:`ckpt_zero_rank`, :func:`moe_ep_rank`, :func:`bert_zero_rank`
    and :func:`zeropp_rank` in turn; the one-process runs of
    train_zero_agree, train_zeropp_agree and train_moe_ep_agree run here
    first."""
    import os

    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build()  # here, so the ranks do not both run nvcc
    zero_want = zero_agree_one_process(dev, seed)
    zeropp_want = zeropp_agree_run(seed, dev, None)
    torch.cuda.empty_cache()
    moe_in = moe_ep_agree_inputs(dev, seed)
    root = ckpt_root()
    _SHARED_DIRS.extend([root, moe_in["save_dir"]])
    zdir = os.path.join(root, "zero")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(shared_rank, ZERO_RANKS, ([
        ("zero", zero_train_rank, (seed,)),
        ("ckpt", ckpt_zero_rank, (seed, zdir)),
        ("moe_ep", moe_ep_rank, (seed, moe_in["save_dir"])),
        ("bert_zero", bert_zero_rank, (seed,)),
        ("zeropp", zeropp_rank, (seed,))],),
        timeout=ZERO_TIMEOUT + MOE_EP_TIMEOUT)
    return {"ranks": ranks, "wall": time.perf_counter() - t0,
            "zero_agree_want": zero_want, "moe_agree_in": moe_in,
            "zeropp_agree_want": zeropp_want, "ckpt_dir": zdir}


def phase_train_zero(dev, seed: int) -> dict:
    """train_zero and train_zero_agree (from the launch of ``ZERO_RANKS``
    ranks on card 0 over gloo they share with train_ckpt, train_moe_ep and
    train_bert_zero, :func:`zero_family_launch`), each rank running the headline at micro-batch 4
    (global ``[8, 2048]``) at ZeRO stages 0-3 and stage 3 with
    ``kernels.fused_adam``, at ``ZERO_LAYERS`` of its 12 layers: finite,
    falling losses, equal on both ranks; each run's losses equal stage 0's
    (within ``ZERO_STAGE_RTOL``); per rank and step 2 L flash forwards, L
    dq and L dk/dv passes, and under fused Adam the norm and Adam kernels
    once; then the agreement (:func:`check_zero_agree`, its one-process
    run before the launch)."""
    got = shared_launch("zero", lambda: zero_family_launch(dev, seed))
    ranks, wall = [r["zero"] for r in got["ranks"]], got["wall"]
    agree_want = got["zero_agree_want"]
    base = ranks[0]["stage0"]["loss"]
    rel = {}
    for label, stage, fused in ZERO_RUNS:
        for r, res in enumerate(ranks):
            row = res[label]
            losses = row["loss"]
            require(all(np.isfinite(losses)),
                    f"train_zero {label} rank {r}: non-finite loss {losses}")
            require(losses[-1] < losses[0], f"train_zero {label} rank {r}: "
                                            f"loss did not fall: {losses}")
            require(losses == ranks[0][label]["loss"],
                    f"train_zero {label}: rank {r}'s losses {losses} != "
                    f"rank 0's {ranks[0][label]['loss']}")
            require_train_launches(f"train_zero {label} rank {r}", dict(
                layers=ZERO_LAYERS, steps=ZERO_STEPS, remat=True,
                fused_adam=fused, launches=row["launches"]))
        rel[label] = _max_rel(ranks[0][label]["loss"], base)
        require(rel[label] <= ZERO_STAGE_RTOL,
                f"train_zero {label}: losses {ranks[0][label]['loss']} != "
                f"stage 0's {base} (rel {rel[label]})")
    peaks = [ranks[0][label]["peak_mem_bytes"] for label, _, _ in ZERO_RUNS]
    require(peaks[3] < peaks[0], f"train_zero: rank 0's peak at stage 3 "
                                 f"({peaks[3]} B) is not below stage 0's "
                                 f"({peaks[0]} B)")
    one = offload_one_process(seed, torch.device("cuda", 0))
    for r, res in enumerate(ranks):
        row = res[ZERO_OFFLOAD_RUN]
        require(row["host_state_bytes"] == row["host_state_bytes_predicted"],
                f"train_zero offload rank {r}: host state "
                f"{row['host_state_bytes']} B, the rank's chunk is "
                f"{row['host_state_bytes_predicted']} B")
        require(row["loss"] == ranks[0][ZERO_OFFLOAD_RUN]["loss"],
                f"train_zero offload: rank {r}'s losses differ from rank 0's")
        require_train_launches(f"train_zero offload rank {r}", dict(
            layers=ZERO_LAYERS, steps=ZERO_STEPS, remat=True,
            fused_adam=False, launches=row["launches"]))
    off_rel = _max_rel(ranks[0][ZERO_OFFLOAD_RUN]["loss"], one)
    require(off_rel <= ZERO_STAGE_RTOL,
            f"train_zero offload: 2 ranks' losses "
            f"{ranks[0][ZERO_OFFLOAD_RUN]['loss']} != one process's {one} "
            f"(rel {off_rel})")
    inf_one = zero_infinity_run(seed, torch.device("cuda", 0), None)
    inf = ranks[0][ZERO_INF_RUN]
    for r, res in enumerate(ranks):
        row = res[ZERO_INF_RUN]
        require(row["loss"] == inf["loss"] and
                row["grad_norm"] == inf["grad_norm"],
                f"train_zero infinity: rank {r}'s losses {row['loss']} / "
                f"grad norms {row['grad_norm']} != rank 0's")
        require(row["n_plane"] * ZERO_RANKS == row["n_pad"] and
                row["host_plane_bytes"] * ZERO_RANKS
                == inf_one["host_plane_bytes"] * row["n_pad"]
                // row["n_elems"],
                f"train_zero infinity rank {r}: planes {row['n_plane']} of "
                f"{row['n_pad']}, {row['host_plane_bytes']} B against one "
                f"process's {inf_one['host_plane_bytes']} B")
        require_stream_launches(f"train_zero infinity rank {r}",
                                row["launches"],
                                AGREE_TRAIN["num_layers"], ZERO_INF_STEPS)
    inf_rel = {k: _max_rel(inf[k], inf_one[k]) for k in ("loss",
                                                         "grad_norm")}
    for k, e in inf_rel.items():
        require(e <= INF_AGREE_RTOL,
                f"train_zero infinity: 2 ranks' {k} {inf[k]} != one "
                f"process's {inf_one[k]} (rel {e} > {INF_AGREE_RTOL})")
    agree = check_zero_agree([r.pop("agree") for r in ranks], agree_want)
    return {"ranks": ranks, "loss_rel_to_stage0": rel,
            "peak_mem_bytes_rank0": peaks, "launch_wall_s": wall,
            "agree": agree, "offload_one_process_loss": one,
            "offload_rel_to_one_process": off_rel,
            "infinity_one_process": inf_one,
            "infinity_rel_to_one_process": inf_rel}


def zero_agree_rank(rank: int, seed: int) -> dict:
    """One rank of train_zero_agree: the fp32 4-layer headline-width model
    on this rank's rows, at stages 0 and 3."""
    from deepspeed_tpu_torch import initialize

    dev = zero_rank_setup()
    cfg, ids = zero_agree_inputs(seed, dev)
    n = ZERO_AGREE_ROWS // ZERO_RANKS
    out = {}
    for stage in (0, 3):
        model = zero_agree_model(cfg, seed + rank, dev)
        engine, *_ = initialize(model=model, config=ds_config(
            model, n, stage=stage), device=dev)
        ms = [engine.train_step({"input_ids": ids[rank * n:(rank + 1) * n]})
              for _ in range(ZERO_AGREE_STEPS)]
        out[stage] = {"loss": [float(m["loss"]) for m in ms],
                      "grad_norm": [float(m["grad_norm"]) for m in ms]}
        del model, engine
    return out


def zero_agree_inputs(seed: int, dev) -> tuple:
    from deepspeed_tpu_torch import LlamaConfig

    cfg = LlamaConfig(**dict(HEADLINE, num_layers=ZERO_AGREE_LAYERS),
                      dtype=torch.float32, param_dtype=torch.float32,
                      attn_impl="flash")
    return cfg, zero_batch(seed + 5, cfg.vocab_size, ZERO_AGREE_ROWS, dev)


def zero_agree_model(cfg, seed: int, dev):
    from deepspeed_tpu_torch import LlamaModel
    return LlamaModel(cfg, device=dev, seed=seed)


def zero_agree_one_process(dev, seed: int) -> dict:
    """train_zero_agree's one-process run on the whole global batch."""
    from deepspeed_tpu_torch import initialize

    cfg, ids = zero_agree_inputs(seed, dev)
    model = zero_agree_model(cfg, seed, dev)
    engine, *_ = initialize(model=model, config=ds_config(
        model, ZERO_AGREE_ROWS), device=dev)
    ms = [engine.train_step({"input_ids": ids})
          for _ in range(ZERO_AGREE_STEPS)]
    want = {"loss": [float(m["loss"]) for m in ms],
            "grad_norm": [float(m["grad_norm"]) for m in ms]}
    del model, engine, ms
    torch.cuda.empty_cache()
    return want


def check_zero_agree(ranks: list, want: dict) -> dict:
    """train_zero_agree: two ranks on card 0 over gloo at stages 0 and 3
    (``ranks``, each rank's :func:`zero_agree_rank`) give the one-process
    run's loss and grad-norm sequences (``want``) on the same global
    batch, to 1e-4 (fp32, headline width, 2 layers)."""
    rel = {}
    for r, res in enumerate(ranks):
        for stage, got in res.items():
            for what in ("loss", "grad_norm"):
                rel[f"rank{r}_stage{stage}_{what}"] = e = _max_rel(
                    got[what], want[what])
                require(e <= 1e-4, f"train_zero_agree rank {r} stage "
                                   f"{stage}: {what} {got[what]} != one "
                                   f"process's {want[what]} (rel {e})")
    return {"one_process": want, "ranks": ranks, "max_rel": rel,
            "layers": ZERO_AGREE_LAYERS, "rows": ZERO_AGREE_ROWS,
            "steps": ZERO_AGREE_STEPS}


# -- ZeRO++: qwZ, qgZ and hpZ -------------------------------------------------

#: train_zeropp (in train_zero's launch): Llama-3-8B widths at
#: ZEROPP_LAYERS of 32, one [1, TRAIN_SEQ] row a rank on ZERO_RANKS ranks
#: of card 0 over gloo, bf16 on fp32 masters, AdamW under
#: kernels.fused_adam, flash, remat, ZEROPP_STEPS steps a run: (label,
#: stage, ZeRO++ keys); the exact stage 3 is the comparator
ZEROPP_LAYERS, ZEROPP_STEPS = 2, 2
ZEROPP_RUNS = (("stage3", 3, {}),
               ("stage3_qwz_qgz", 3, {"zero_quantized_weights": True,
                                      "zero_quantized_gradients": True}),
               ("stage2_qgz", 2, {"zero_quantized_gradients": True}))
#: the quantized runs' losses against the exact run's: JAX's own ZeRO++
#: bound (tests/unit/runtime/test_zeropp.py:77, 122, 215)
ZEROPP_RTOL = 5e-2
#: the persistence threshold of the runs (the config's default): every
#: matrix is cut and quantized, the norms stay whole
ZEROPP_THRESHOLD = 100_000
#: train_hpz (in train_tp_sp's launch): the same model on HPZ_RANKS ranks
#: at ep HPZ_EP x dp 2, one row a rank, hpZ over the data axis beside
#: stage 3 without it on the same ranks (within ZERO_STAGE_RTOL); both
#: runs move the int8 wire of qwZ and qgZ (hpZ composes with them, and
#: four ranks' bf16 gathers and fp32 reduce-scatters through the host
#: take 22 s a step, a third of the script's added time)
HPZ_RANKS, HPZ_EP = 4, 2
_QWZ_QGZ = {"zero_quantized_weights": True, "zero_quantized_gradients": True}
HPZ_RUNS = (("stage3_qwz_qgz", _QWZ_QGZ),
            ("stage3_hpz_qwz_qgz", dict(_QWZ_QGZ,
                                        zero_hpz_partition_size=2)))
#: train_zeropp_agree: AGREE_TRAIN in fp32 under qwZ at stage 3 on the two
#: ranks against qwZ in one process, ZERO_AGREE_STEPS steps (train_zero_
#: agree's bound, 1e-4); qgZ at a world of one is the identity
ZEROPP_NOTE = ("ranks on card 0 over gloo, every collective through pinned "
               "host memory: the bytes are the wire's, the step time on "
               "the host clock is not a speed")


def zeropp_model_config():
    from deepspeed_tpu_torch import LlamaConfig
    return LlamaConfig.llama3_8b(num_layers=ZEROPP_LAYERS,
                                 dtype=torch.bfloat16,
                                 param_dtype=torch.float32,
                                 attn_impl="flash")


def zeropp_config(model, stage: int, keys: dict, micro: int = 1) -> dict:
    cfg = ds_config(model, micro, fused_adam=True, stage=stage)
    cfg["zero_optimization"].update(
        keys, stage3_param_persistence_threshold=ZEROPP_THRESHOLD)
    return cfg


def zeropp_wire_want(model, stage: int, keys: dict, world: int,
                     data: Optional[int] = None) -> dict:
    """The bytes of a step's collectives by ``verb/dtype`` from the shapes
    alone (``comm.wire_counts``' units: an all-gather's result, a
    reduce-scatter's and an all-to-all's input, twice an all-reduce's
    tensor), for ``model``'s leaves under remat (a layer's weights read
    twice a step, the embedding and the head once), one microbatch,
    ``world`` data-parallel ranks and ``data`` (hpZ: the ranks a master
    is cut over)."""
    from deepspeed_tpu_torch.runtime.zero import dp_shardable_dim
    from deepspeed_tpu_torch.runtime.zero.qwz import GROUP, qwz_axis

    q_w = keys.get("zero_quantized_weights", False)
    q_g = keys.get("zero_quantized_gradients", False)
    data = data or world
    el = torch.finfo(model.config.dtype).bits // 8
    want: dict = {}

    def add(key: str, n: int) -> None:
        want[key] = want.get(key, 0) + int(n)

    def two_hop(n: int) -> None:
        n_pad = -(-n // (world * GROUP)) * world * GROUP
        for verb in ("all_to_all", "all_gather"):
            add(f"{verb}/int8", n_pad)
            add(f"{verb}/float32", n_pad // GROUP * 4)

    for name, p in model.named_parameters():
        n, shape = p.numel(), tuple(p.shape)
        reads = 2 if name.startswith("layers.") else 1
        cut = (dp_shardable_dim(shape, world) if n > ZEROPP_THRESHOLD
               else None)
        if stage < 3 or cut is None:
            if q_g:
                two_hop(n)
            elif stage == 2 and cut is not None:
                add("reduce_scatter/float32", 4 * n)
            else:
                add("all_reduce/float32", 8 * n)
            continue
        axis = qwz_axis(*model.qwz_view(name), ZEROPP_THRESHOLD) \
            if q_w else None
        if axis is not None:
            add("all_gather/int8", n * reads)
            straddle = cut == axis.dim and (shape[cut] // data) % axis.run
            add("all_reduce/float32" if straddle else "all_gather/float32",
                n // axis.run * 4 * (2 if straddle else 1) * reads)
        else:
            add(f"all_gather/{str(model.config.dtype)[6:]}", el * n * reads)
        if q_g:
            per = -(-(n // world) // GROUP) * GROUP
            add("all_to_all/int8", world * per)
            add("all_to_all/float32", world * per // GROUP * 4)
        else:
            add("reduce_scatter/float32", 4 * n)
        if data < world:  # hpZ: the updated pieces into each master chunk
            add("all_gather/float32", 4 * n // data)
    if stage == 2:  # the updated chunks into the whole masters
        add("all_gather/float32", sum(
            4 * p.numel() for p in model.parameters()
            if p.numel() > ZEROPP_THRESHOLD
            and dp_shardable_dim(tuple(p.shape), world) is not None))
    add("all_reduce/float32", 16)  # the loss and the norm's partial sum
    return want


def zeropp_run(cfg, seed: int, dev, rows, stage: int, keys: dict,
               world: int, mesh=None) -> dict:
    """One run: ``initialize`` at ``stage`` with ``keys``, ZEROPP_STEPS
    steps on ``rows``: losses, launches, state and peak bytes, host step
    times, the last step's bytes by verb and dtype beside the count from
    the shapes."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaModel(cfg, device=dev, seed=seed)
    data = world // HPZ_EP if keys.get("zero_hpz_partition_size") else None
    wire_want = zeropp_wire_want(model, stage, keys, world, data)
    state_want = predicted_state_bytes(
        [tuple(p.shape) for p in model.parameters()], stage, world, data,
        ZEROPP_THRESHOLD)
    engine, *_ = initialize(model=model, config=zeropp_config(
        model, stage, keys), device=dev, mesh=mesh)
    reset_counts()
    metrics, marks = [], []
    for _ in range(ZEROPP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(engine.train_step({"input_ids": rows}))
        torch.cuda.synchronize()
        marks.append((time.perf_counter() - t0) * 1e3)
    out = {"stage": stage, **keys,
           "loss": [float(m["loss"]) for m in metrics],
           "grad_norm": [float(m["grad_norm"]) for m in metrics],
           "launches": train_launches(),
           "state_bytes": zero_state_bytes(engine),
           "state_bytes_predicted": state_want,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "host_step_ms": marks, "wire": dict(engine.last_wire),
           "wire_predicted": wire_want,
           "cut_leaves": sum(p is not None for p in engine.placements)}
    del model, engine, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zeropp_agree_inputs(seed: int, dev) -> tuple:
    from deepspeed_tpu_torch import LlamaConfig
    return (LlamaConfig(**AGREE_TRAIN),
            zero_batch(seed + 13, AGREE_TRAIN["vocab_size"], ZERO_RANKS,
                       dev)[:, :AGREE_TRAIN["max_seq_len"]])


def zeropp_agree_run(seed: int, dev, rank: Optional[int]) -> dict:
    """AGREE_TRAIN in fp32 under qwZ: at stage 3 on rank ``rank``'s row, or
    (``rank`` None) in one process on both rows."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    cfg, ids = zeropp_agree_inputs(seed, dev)
    model = LlamaModel(cfg, device=dev, seed=seed + 4 + (rank or 0))
    one = rank is None
    engine, *_ = initialize(model=model, config=zeropp_config(
        model, 0 if one else 3, {"zero_quantized_weights": True},
        ZERO_RANKS if one else 1), device=dev)
    rows = ids if one else ids[rank:rank + 1]
    ms = [engine.train_step({"input_ids": rows})
          for _ in range(ZERO_AGREE_STEPS)]
    out = {"loss": [float(m["loss"]) for m in ms],
           "grad_norm": [float(m["grad_norm"]) for m in ms],
           "quantized_leaves": sum(p.ds_qwz is not None
                                   for p in engine.params)}
    del model, engine
    return out


def zeropp_rank(rank: int, seed: int) -> dict:
    """One rank of train_zeropp (train_zero's launch): every ZEROPP_RUNS
    entry on this rank's row of a ``[ZERO_RANKS, TRAIN_SEQ]`` global batch
    (a fresh model from this rank's seed each: the engine broadcasts rank
    0's), then the fp32 qwZ agreement."""
    dev = zero_rank_setup()
    cfg = zeropp_model_config()
    ids = zero_batch(seed + 11, cfg.vocab_size, ZERO_RANKS, dev)
    out = {label: zeropp_run(cfg, seed + rank, dev, ids[rank:rank + 1],
                             stage, keys, ZERO_RANKS)
           for label, stage, keys in ZEROPP_RUNS}
    out["agree"] = zeropp_agree_run(seed, dev, rank)
    return out


def hpz_rank(rank: int, seed: int, dev) -> dict:
    """One rank of train_hpz (train_tp_sp's launch): HPZ_RUNS on an ep
    HPZ_EP x dp mesh, this rank's row of a ``[HPZ_RANKS, TRAIN_SEQ]``
    global batch."""
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.utils import groups

    cfg = zeropp_model_config()
    ids = zero_batch(seed + 12, cfg.vocab_size, HPZ_RANKS, dev)
    out = {}
    for label, keys in HPZ_RUNS:
        mesh = groups.initialize_mesh(MeshLayout.infer(HPZ_RANKS, ep=HPZ_EP))
        out[label] = zeropp_run(cfg, seed + rank, dev, ids[rank:rank + 1],
                                3, keys, HPZ_RANKS, mesh)
        groups.reset_mesh()
    return out


def check_zeropp_runs(what: str, ranks: list, runs: tuple,
                      tol: float) -> dict:
    """Every run of ``runs`` on every rank: finite, falling losses equal
    on the ranks; the launch formula (flash, and the norm and Adam kernels
    once a step); the state bytes and the last step's bytes by verb and
    dtype equal to the count from the shapes; each run's losses within
    ``tol`` of the first run's (the exact one)."""
    base = ranks[0][runs[0][0]]["loss"]
    rel = {}
    for run in runs:
        label = run[0]
        for r, res in enumerate(ranks):
            row = res[label]
            losses = row["loss"]
            require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                    f"{what} {label} rank {r}: losses {losses}")
            require(losses == ranks[0][label]["loss"],
                    f"{what} {label}: rank {r}'s losses {losses} != rank "
                    f"0's {ranks[0][label]['loss']}")
            require_train_launches(f"{what} {label} rank {r}", dict(
                layers=ZEROPP_LAYERS, steps=ZEROPP_STEPS, remat=True,
                fused_adam=True, launches=row["launches"]))
            require(row["state_bytes"]["total"] ==
                    row["state_bytes_predicted"],
                    f"{what} {label} rank {r}: state "
                    f"{row['state_bytes']['total']} B, predicted "
                    f"{row['state_bytes_predicted']} B")
            require(row["wire"] == row["wire_predicted"],
                    f"{what} {label} rank {r}: bytes a step {row['wire']}, "
                    f"from the shapes {row['wire_predicted']}")
        rel[label] = e = _max_rel(ranks[0][label]["loss"], base)
        require(e <= tol, f"{what} {label}: losses "
                          f"{ranks[0][label]['loss']} against the exact "
                          f"{base} (rel {e} > {tol})")
    return rel


def time_zeropp_quantizer(dev, elements: int) -> dict:
    """The plain-PyTorch int8 round trip (``quant_runs`` then
    ``dequant_runs``, groups of 256) of a ``QUANT_TIMED`` bf16 weight in
    fp32, CUDA events over 5 calls after a warm-up; ``step_ms_estimate``
    scales it to ``elements`` round-tripped a step."""
    from deepspeed_tpu_torch.runtime.zero.qwz import (GROUP, dequant_runs,
                                                      quant_runs)

    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(QUANT_TIMED, generator=gen, device=dev).to(
        torch.bfloat16)

    def round_trip():
        q, s = quant_runs(w.float(), GROUP)
        return dequant_runs(q, s, GROUP)
    round_trip()
    start, end = event_pair()
    start.record()
    for _ in range(5):
        round_trip()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    del w
    return {"shape": list(QUANT_TIMED), "ms": ms,
            "elements_a_step": elements,
            "step_ms_estimate": ms * elements / int(np.prod(QUANT_TIMED))}


def phase_train_zeropp(dev, seed: int) -> dict:
    """train_zeropp and train_zeropp_agree (train_zero's launch, its
    ``zeropp`` body): :func:`check_zeropp_runs` with ZEROPP_RTOL; the
    quantized run moves int8 where the exact one moves bf16 gathers and
    fp32 reduce-scatters; then qwZ on two ranks against one process."""
    got = shared_launch("zero", lambda: zero_family_launch(dev, seed))
    ranks = [r["zeropp"] for r in got["ranks"]]
    rel = check_zeropp_runs("train_zeropp", ranks, ZEROPP_RUNS, ZEROPP_RTOL)
    exact, quant = ranks[0]["stage3"]["wire"], \
        ranks[0]["stage3_qwz_qgz"]["wire"]
    require("all_gather/bfloat16" not in quant and
            "reduce_scatter/float32" not in quant and
            quant.get("all_gather/int8", 0) > 0 and
            quant.get("all_to_all/int8", 0) > 0,
            f"train_zeropp: the quantized run's wire {quant}")
    want = got["zeropp_agree_want"]
    agree_rel = {}
    for r, res in enumerate(ranks):
        for what in ("loss", "grad_norm"):
            agree_rel[f"rank{r}_{what}"] = e = _max_rel(
                res["agree"][what], want[what])
            require(e <= 1e-4, f"train_zeropp_agree rank {r}: {what} "
                               f"{res['agree'][what]} != one process's "
                               f"{want[what]} (rel {e})")
    cfg = zeropp_model_config()
    # a step round-trips every gathered element (qwZ) and every gradient
    # element (qgZ) once
    q = ranks[0]["stage3_qwz_qgz"]["wire"]
    quantizer = time_zeropp_quantizer(dev, q["all_gather/int8"]
                                      + q["all_to_all/int8"])
    return {"ranks": [{k: v for k, v in x.items() if k != "agree"}
                      for x in ranks], "quantizer": quantizer,
            "loss_rel_to_exact": rel, "params": cfg.num_params(),
            "wire_exact": exact, "wire_quantized": quant,
            "agree": {"one_process": want,
                      "ranks": [x["agree"] for x in ranks],
                      "max_rel": agree_rel, "steps": ZERO_AGREE_STEPS,
                      "tolerance": 1e-4}}


def check_hpz(ranks: list) -> dict:
    """train_hpz: :func:`check_zeropp_runs` on the four ranks with
    ZERO_STAGE_RTOL (hpZ changes no number, under qwZ and qgZ too)."""
    got = [r["hpz"] for r in ranks]
    rel = check_zeropp_runs("train_hpz", got, HPZ_RUNS, ZERO_STAGE_RTOL)
    return {"ranks": got, "loss_rel_to_stage3": rel,
            "params": zeropp_model_config().num_params()}


def emit_zeropp(phase: str, out: dict, runs: tuple, ranks: int,
                **extra) -> None:
    for run in runs:
        label = run[0]
        emit(dict(phase=phase, run=label, model="llama3_8b widths",
                  layers=ZEROPP_LAYERS, params=out["params"], ranks=ranks,
                  global_batch=[ranks, TRAIN_SEQ], dtype="bfloat16",
                  fused_adam=True, steps=ZEROPP_STEPS,
                  reduced=[f"num_layers 32 -> {ZEROPP_LAYERS}",
                           f"cards {ranks} -> 1, NCCL -> gloo"],
                  comm=ZEROPP_NOTE, card=nvidia_smi_line(), **extra,
                  **{f"rank{r}": x[label]
                     for r, x in enumerate(out["ranks"])}))


# -- the checkpoint slice ------------------------------------------------------

#: the token dataset the loader reads: ``CKPT_SAMPLES`` rows of ``TRAIN_SEQ``
#: tokens from the seed (eight global batches of ``TRAIN_BATCH``)
CKPT_SAMPLES = 64
#: the unbroken run's steps; the broken one saves after ``CKPT_SAVE_AT``
CKPT_STEPS, CKPT_SAVE_AT, CKPT_ASYNC_ON, CKPT_ZERO_STEPS = 6, 3, 2, 2
#: a rank file's size may exceed its predicted tensor payload by this much
#: (pickle and zip headers); a view saved with its whole storage would be
#: twice the payload
CKPT_BYTES_SLACK = 0.02
CURRICULUM = {"enabled": True, "min_difficulty": 256, "max_difficulty": 2048,
              "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 4,
                                  "difficulty_step": 256}}
CURRICULUM_STEPS = 4


class TokenDataset:
    """``CKPT_SAMPLES`` samples of ``TRAIN_SEQ`` random token ids from
    ``seed``, indexable as the loader reads them."""

    def __init__(self, seed: int, vocab: int):
        self.ids = np.random.default_rng(seed).integers(
            0, vocab, (CKPT_SAMPLES, TRAIN_SEQ), dtype=np.int64)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> dict:
        return {"input_ids": self.ids[i]}


def ckpt_root():
    """A fresh directory under ``build/`` beside this script."""
    import tempfile
    from pathlib import Path

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    return tempfile.mkdtemp(prefix="ckpt_smoke_", dir=build)


def headline_cfg(num_layers: int = HEADLINE["num_layers"]):
    """The headline's training config (bf16 on fp32 masters, flash), at
    ``num_layers`` of its layers."""
    from deepspeed_tpu_torch import LlamaConfig
    return LlamaConfig(**dict(HEADLINE, num_layers=num_layers),
                       dtype=torch.bfloat16, param_dtype=torch.float32,
                       attn_impl="flash")


def predicted_rank_bytes(shapes: list, dp: int) -> list:
    """Each rank file's tensor payload for parameters of ``shapes`` under
    ZeRO-3 over ``dp`` ranks (at stage 0 one rank writes all): fp32
    master, m and v, 12 bytes an element; a cut leaf's chunk on every rank,
    a whole leaf on rank 0 (the placement rule, ``runtime/zero/
    sharder.py``)."""
    from deepspeed_tpu_torch.runtime.config import ZeroConfig
    from deepspeed_tpu_torch.runtime.zero import ZeroShardingPolicy

    policy = ZeroShardingPolicy.from_config(ZeroConfig(stage=3), dp)
    out = [0] * dp
    for shape in shapes:
        n = int(np.prod(shape))
        if policy.shard_dim(shape) is None:
            out[0] += n
        else:
            out = [x + n // dp for x in out]
    return [12 * x for x in out]


def ckpt_engine(seed: int, dev, data, stage: int = 0, fused: bool = False,
                **over) -> tuple:
    """A fresh headline model from ``seed`` behind ``initialize`` with the
    dataset as ``training_data``: (engine, loader)."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    model = LlamaModel(headline_cfg(), device=dev, seed=seed)
    micro = TRAIN_BATCH // (ZERO_RANKS if stage else 1)
    engine, _, loader, _ = initialize(
        model=model, config=dict(ds_config(model, micro, fused, stage),
                                 **over), device=dev, training_data=data)
    return engine, loader


def ckpt_steps(engine, it, n: int) -> list:
    return [float(engine.train_step(next(it))["loss"]) for _ in range(n)]


def state_digests(engine, places=None) -> dict:
    """sha256 of each leaf's fp32 master, m and v as this engine holds them
    (a chunk under ZeRO), or of the chunks ``places`` names (per leaf:
    placement values or None) cut from this engine's whole tensors."""
    import hashlib

    from deepspeed_tpu_torch.runtime.checkpointing import (box_of,
                                                           placement_values)
    opt = engine.optimizer
    out = {}
    for i, (name, pl) in enumerate(zip(engine.param_names,
                                       engine.placements)):
        if places is not None and name not in places:
            continue
        want = places[name] if places is not None else placement_values(pl)
        row = {}
        for key, t in (("master", engine._masters()[i]), ("m", opt.m[i]),
                       ("v", opt.v[i])):
            if places is not None and want is not None:
                for d, (lo, hi) in enumerate(box_of(want["full_shape"],
                                                    want)):
                    t = t.narrow(d, lo, hi - lo)
            row[key] = hashlib.sha256(
                t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
        out[name] = {"placement": want, **row}
    return out


def rank_file_bytes(tag_dir: str) -> list:
    import glob
    import os
    return [os.path.getsize(p) for p in
            sorted(glob.glob(os.path.join(tag_dir, "dp_rank_*.pt")))]


def require_bytes(what: str, got: list, want: list) -> list:
    rel = [g / w - 1 for g, w in zip(got, want)]
    require(len(got) == len(want) and all(abs(r) <= CKPT_BYTES_SLACK
                                          for r in rel),
            f"{what}: rank files {got} B, predicted payload {want} B")
    return rel


def ckpt_zero_rank(rank: int, seed: int, save_dir: str) -> dict:
    """One rank of train_ckpt's ZeRO part: the headline at stage 3 with
    fused Adam over this rank's rows of the loader, ``CKPT_ZERO_STEPS``
    steps, then a save; returns the losses, launches, the save's time and
    the digests of this rank's slices."""
    dev = zero_rank_setup()
    data = TokenDataset(seed, HEADLINE["vocab_size"])
    engine, loader = ckpt_engine(seed + 10 + rank, dev, data, stage=3,
                                 fused=True)
    reset_counts()
    losses = ckpt_steps(engine, iter(loader), CKPT_ZERO_STEPS)
    launches = train_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tag_dir = engine.save_checkpoint(save_dir, client_state={
        "consumed_samples": CKPT_ZERO_STEPS * TRAIN_BATCH})
    save_s = time.perf_counter() - t0
    return {"loss": losses, "launches": launches, "save_s": save_s,
            "tag_dir": tag_dir, "count": engine.optimizer.count,
            "digests": state_digests(engine)}


def phase_train_ckpt(dev, seed: int) -> dict:
    """train_ckpt: checkpoints and the dataloader on bench.py's headline
    (every step fed by ``initialize(training_data=...)``):

    1. one process, stage 0: losses 4-6 of an unbroken run equal, bit for
       bit, those of a run saved (sync) at step 3 and resumed in a fresh
       engine on a model from another seed with the loader re-pointed by
       ``resume_from_samples``; an async save, 2 more steps, and a fresh
       engine loads the state as it was at the save, bit for bit;
    2. two gloo ranks on card 0 (train_zero's launch) at stage 3 with
       fused Adam save after 2 steps; one process at stage 0 with plain AdamW loads it: masters,
       m and v equal the ranks' slices bit for bit (sha256), the count
       too; 2 more steps are finite and falling; ``zero_to_fp32`` counts
       every parameter;
    3. a seqlen curriculum (256 to 2048 over 4 steps in steps of 256): the
       batch lengths follow it and flash launches at each length as the
       formula says.

    Each rank file is within ``CKPT_BYTES_SLACK`` of its predicted
    payload; the checkpoints are deleted after the phase."""
    import os
    import shutil

    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint

    t_phase = time.perf_counter()
    cfg = headline_cfg()
    n_params = cfg.num_params()
    data = TokenDataset(seed, cfg.vocab_size)
    root = ckpt_root()
    try:
        # 1. sync resume, bit for bit
        engine, loader = ckpt_engine(seed, dev, data)
        shapes = [tuple(p.shape) for p in engine.params]
        pred0, pred3 = (predicted_rank_bytes(shapes, 1),
                        predicted_rank_bytes(shapes, ZERO_RANKS))
        out = {"params": n_params, "predicted_bytes": {
            "stage0": pred0, "stage3_2ranks": pred3}}
        free = shutil.disk_usage(root).free
        require(free > 2 * pred0[0], f"train_ckpt: {free} B free under "
                                     f"{root}, a checkpoint takes {pred0[0]} B")
        reset_counts()
        unbroken = ckpt_steps(engine, iter(loader), CKPT_STEPS)
        t = dict(layers=cfg.num_layers, steps=CKPT_STEPS, remat=cfg.remat,
                 fused_adam=False, launches=train_launches())
        require_train_launches("train_ckpt (unbroken)", t)
        del engine, loader
        engine, loader = ckpt_engine(seed, dev, data)
        first = ckpt_steps(engine, iter(loader), CKPT_SAVE_AT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tag_dir = engine.save_checkpoint(
            os.path.join(root, "sync"), client_state={
                "consumed_samples": CKPT_SAVE_AT * TRAIN_BATCH})
        save_s = time.perf_counter() - t0
        sync_bytes = rank_file_bytes(tag_dir)
        del engine, loader
        gc.collect()
        engine, loader = ckpt_engine(seed + 1, dev, data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, client = engine.load_checkpoint(os.path.join(root, "sync"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loader.resume_from_samples(client["consumed_samples"])
        resumed = ckpt_steps(engine, iter(loader), CKPT_STEPS - CKPT_SAVE_AT)
        require(first == unbroken[:CKPT_SAVE_AT] and
                resumed == unbroken[CKPT_SAVE_AT:],
                f"train_ckpt: resumed losses {first} + {resumed} != the "
                f"unbroken run's {unbroken}")
        out["sync"] = {
            "loss_unbroken": unbroken, "loss_saved_run": first,
            "loss_resumed": resumed, "bit_equal": True,
            "rank_file_bytes": sync_bytes,
            "bytes_rel_to_prediction": require_bytes(
                "train_ckpt sync", sync_bytes, pred0),
            "save_s": save_s, "load_s": load_s,
            "save_gb_per_s": sync_bytes[0] / save_s / 1e9,
            "load_gb_per_s": sync_bytes[0] / load_s / 1e9}
        del engine, loader
        shutil.rmtree(os.path.join(root, "sync"))

        # 1b. async: the snapshot is the state at the save
        over = {"checkpoint": {"checkpoint_engine": {"type": "async"}}}
        engine, loader = ckpt_engine(seed, dev, data, **over)
        it = iter(loader)
        ckpt_steps(engine, it, CKPT_SAVE_AT)
        saved = ([p.detach().clone() for p in engine.params]
                 + [t.clone() for t in engine.optimizer.m + engine.optimizer.v])
        count = engine.optimizer.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.save_checkpoint(os.path.join(root, "async"))
        block_s = time.perf_counter() - t0
        on = ckpt_steps(engine, it, CKPT_ASYNC_ON)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.checkpoint_engine.wait()
        wait_s = time.perf_counter() - t0
        require(not torch.equal(saved[0], engine.params[0]),
                "train_ckpt async: the steps after the save changed nothing")
        del engine, loader
        engine, _ = ckpt_engine(seed + 2, dev, data, **over)
        engine.load_checkpoint(os.path.join(root, "async"))
        now = (list(engine.params) + engine.optimizer.m + engine.optimizer.v)
        equal = all(torch.equal(a, b) for a, b in zip(saved, now))
        require(equal and engine.optimizer.count == count,
                "train_ckpt async: the loaded state is not the state at the "
                "save")
        out["async"] = {"loss_after_save": on, "bit_equal": True,
                        "save_blocking_s": block_s, "wait_s": wait_s,
                        "rank_file_bytes": rank_file_bytes(os.path.join(
                            root, "async", f"global_step{CKPT_SAVE_AT}"))}
        del engine, saved, now
        shutil.rmtree(os.path.join(root, "async"))
        gc.collect()
        torch.cuda.empty_cache()

        # 2. stage 3 on two ranks (train_zero's launch) -> stage 0 in one
        # process
        got = shared_launch("zero", lambda: zero_family_launch(dev, seed))
        ranks, wall = [r["ckpt"] for r in got["ranks"]], got["wall"]
        zdir = got["ckpt_dir"]
        for r, res in enumerate(ranks):
            require(res["loss"] == ranks[0]["loss"] and
                    all(np.isfinite(res["loss"])),
                    f"train_ckpt zero rank {r}: losses {res['loss']}")
            require_train_launches(f"train_ckpt zero rank {r}", dict(
                layers=cfg.num_layers, steps=CKPT_ZERO_STEPS, remat=True,
                fused_adam=True, launches=res["launches"]))
        zbytes = rank_file_bytes(ranks[0]["tag_dir"])
        engine, loader = ckpt_engine(seed + 5, dev, data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, client = engine.load_checkpoint(zdir)
        torch.cuda.synchronize()
        zload_s = time.perf_counter() - t0
        for r, res in enumerate(ranks):
            places = {n: d["placement"] for n, d in res["digests"].items()
                      if d["placement"] is not None or r == 0}
            got = state_digests(engine, places)
            bad = [n for n in places if got[n] != res["digests"][n]]
            require(not bad, f"train_ckpt zero: rank {r}'s slices of {bad[:3]} "
                             "differ after the reshard")
        require(engine.optimizer.count == ranks[0]["count"],
                f"train_ckpt zero: count {engine.optimizer.count} != "
                f"{ranks[0]['count']}")
        # the next global batch, twice: the loss must fall on it
        loader.resume_from_samples(client["consumed_samples"])
        batch = next(iter(loader))
        more = [float(engine.train_step(batch)["loss"]) for _ in range(2)]
        require(all(np.isfinite(more)) and more[1] < more[0],
                f"train_ckpt zero: the resumed losses {more} are not finite "
                "and falling")
        del engine, loader
        gc.collect()
        torch.cuda.empty_cache()
        sd = get_fp32_state_dict_from_zero_checkpoint(zdir)
        counted = sum(v.numel() for v in sd.values())
        del sd
        require(counted == n_params, f"train_ckpt zero_to_fp32: {counted} "
                                     f"parameters, want {n_params}")
        out["zero"] = {
            "ranks": ZERO_RANKS, "comm": ZERO_NOTE,
            "loss": ranks[0]["loss"], "loss_resumed_stage0": more,
            "launches_per_rank": [x["launches"] for x in ranks],
            "rank_file_bytes": zbytes,
            "bytes_rel_to_prediction": require_bytes(
                "train_ckpt zero", zbytes, pred3),
            "save_s": [x["save_s"] for x in ranks], "load_s": zload_s,
            "load_gb_per_s": sum(zbytes) / zload_s / 1e9,
            "reshard_bit_equal": True, "zero_to_fp32_params": counted,
            "launch_wall_s": wall}
        shutil.rmtree(zdir)

        # 3. the seqlen curriculum
        engine, loader = ckpt_engine(seed, dev, data,
                                     curriculum_learning=CURRICULUM)
        lo, hi = CURRICULUM["min_difficulty"], CURRICULUM["max_difficulty"]
        q = CURRICULUM["schedule_config"]["difficulty_step"]
        total = CURRICULUM["schedule_config"]["total_curriculum_step"]
        want = [max(lo, min(hi, int(lo + (hi - lo) * min(s / total, 1.0))
                            // q * q)) for s in range(CURRICULUM_STEPS)]
        lengths, losses, per_step = [], [], []
        it = iter(loader)
        for step in range(CURRICULUM_STEPS):
            batch = next(it)
            lengths.append(int(batch["input_ids"].shape[1]))
            reset_counts()
            losses.append(float(engine.train_step(batch)["loss"]))
            per_step.append(train_launches())
            require_train_launches(f"train_ckpt curriculum step {step}", dict(
                layers=cfg.num_layers, steps=1, remat=cfg.remat,
                fused_adam=False, launches=per_step[-1]))
        require(lengths == want, f"train_ckpt curriculum: lengths {lengths}, "
                                 f"the schedule says {want}")
        require(all(np.isfinite(losses)),
                f"train_ckpt curriculum: losses {losses}")
        out["curriculum"] = {"lengths": lengths, "loss": losses,
                             "launches_per_step": per_step}
        out["wall_s"] = time.perf_counter() - t_phase
        del engine, loader
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- the tensor-parallel slice ------------------------------------------------

#: (case, shape): the quantizer's checks (the CPU tests' cases: bench.py's
#: shape, a rank-3 input, a zero row, a row holding one value 1e4 times
#: the rest, rows whose bytes are no multiple of 16) and its timed shape, a
#: Llama-3-8B FFN weight (what qwZ would quantize)
QUANT_CHECKS = [("bench", (512, 256)), ("rank3", (4, 256, 96)),
                ("zero_row", (512, 256)), ("outlier", (512, 256)),
                ("ragged", (4, 100, 96)), ("llama3_8b_ffn", (14336, 4096))]
QUANT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
QUANT_TIMED = (14336, 4096)
#: tensor size of the TP phases; their ranks share card 0 over gloo
TP = 2
TP_TIMEOUT = 900
#: serve_tp's depth: 1 of Llama-3-8B's 32 layers (gloo's host copies set
#: the phase's time; cut to keep the script inside its limit on slower
#: hosts)
SERVE_TP_LAYERS = 1
#: serve_tp's OPT-1.3B depth: 2 of its 24 layers (the script's length)
OPT_TP_LAYERS = 2
#: serve_tp's requests (prompt length, max_new_tokens, class); the first
#: two start with a shared 256-token header
SERVE_TP_REQUESTS = [(320, 32, "interactive"), (448, 32, "batch"),
                     (64, 32, "interactive"), (512, 32, "background"),
                     (200, 32, "batch"), (128, 32, "background")]
SERVE_TP_HEADER = 256
#: the serve phase's engine knobs, per rank
SERVE_ENGINE = dict(max_batch_slots=8, prefill_chunk=256, prefill_batch=2,
                    decode_burst=8)
#: agree_tp: Llama-3-8B widths at 2 of 32 layers, these prompts, 16 tokens
AGREE_TP_LAYERS, AGREE_TP_PROMPTS, AGREE_TP_NEW = 2, (37, 100, 260), 16
#: agree_moe_tp: Mixtral-8x7B widths at 1 of 32 layers
AGREE_MOE_TP_LAYERS = 1
#: in bf16, how much further from the fp32 logits the ``tp=2`` logits may
#: lie than the ``tp=1`` ones: the partial sums add roundings of bf16's own
#: size (random-weight logits carry ~5e-2 of bf16 error against fp32)
BF16_TP_SLACK = 1.5
TP_NOTE = "gloo through the host, two ranks on one card: not a TP speed"


def quant_input(case, shape, dtype, gen, dev):
    x = torch.randn(shape, generator=gen, device=dev)
    if case == "zero_row":
        x[3] = 0.0
    if case == "outlier":
        x[5] = 1e-2
        x[5, 17] = 1e2
    return x.to(dtype)


def phase_quant_kernels(dev, seed: int) -> dict:
    """The int8 quantizer against its plain version, exactly, at every
    ``QUANT_CHECKS`` shape in fp32, bf16 and fp16; timed at a Llama-3-8B
    FFN weight in bf16 beside its plain version and its bound (bytes:
    each element read once, a code byte per element and a scale per row
    written); then its path: every weight matrix of a seeded one-layer
    Llama-3-8B quantized through the op entry, the counts read from 0
    around it, each round trip within bench.py's bound (max|w| / 127 ·
    1.01)."""
    from deepspeed_tpu_torch import LlamaConfig, LlamaModel
    from deepspeed_tpu_torch.ops.kernels import (dequantize_int8,
                                                 quantize_int8,
                                                 quantize_int8_plain)
    gen = torch.Generator(device=dev).manual_seed(2468)
    errs = {}
    for (case, shape), dtype in itertools.product(QUANT_CHECKS,
                                                  QUANT_DTYPES):
        x = quant_input(case, shape, dtype, gen, dev)
        (q, s), (wq, ws) = quantize_int8(x), quantize_int8_plain(x)
        torch.cuda.synchronize()
        require(q.dtype == torch.int8 and q.shape == x.shape
                and s.shape == x.shape[:-1], f"quant_kernels {case}: wrong "
                "dtype/shape")
        require(torch.equal(q, wq) and torch.equal(s, ws),
                f"quant_kernels {case} {dtype}: codes or scales differ from "
                "the plain version")
        errs[f"{case}_{str(dtype).split('.')[-1]}"] = max(
            (q.int() - wq.int()).abs().max().item(),
            (s - ws).abs().max().item())
    launches = quantize_int8.launches
    sets = [quant_input("timed", QUANT_TIMED, torch.bfloat16, gen, dev)
            for _ in range(2)]  # 117 MB each: no call finds its input in L2
    cycles = sleep_cycles_per_ms()
    R, C = QUANT_TIMED
    bound_ms, by = bound(R * C * (2 + 1) + 4 * R, 4 * R * C,
                         PEAK_FLOPS[torch.float32])
    out = dict(
        kernel_time=time_ms([lambda x=x: quantize_int8(x) for x in sets],
                            cycles),
        plain_time=time_ms([lambda x=x: quantize_int8_plain(x)
                            for x in sets], cycles),
        library_time=None,
        library_call="none: no single PyTorch call computes per-row absmax "
                     "scales and int8 codes",
        bound_ms=bound_ms, bound_by=by, launches_this_phase=launches,
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance="exact", checked_at=dict(QUANT_CHECKS),
        timed_at=f"bf16 {list(QUANT_TIMED)} (a Llama-3-8B FFN weight)")
    del sets
    model = LlamaModel(LlamaConfig.llama3_8b(num_layers=1), device=dev,
                       seed=seed)
    reset_counts()
    worst, n_bytes = 0.0, 0
    with torch.no_grad():
        for name, w in model.named_parameters():
            if w.dim() != 2:
                continue
            q, s = quantize_int8(w)
            err = (dequantize_int8(q, s) - w.float()).abs().max().item()
            lim = w.float().abs().max().item() / 127.0 * 1.01
            require(err <= lim, f"quant path: {name} round trip error {err} "
                                f"over {lim}")
            worst = max(worst, err / lim)
            n_bytes += w.numel() * w.element_size()
    torch.cuda.synchronize()
    out["path"] = {"what": "every weight matrix of a one-layer Llama-3-8B "
                           "(bf16), quantized and dequantized",
                   "launches": read_counts(), "bytes_quantized": n_bytes,
                   "worst_error_over_bound": worst}
    require(out["path"]["launches"]["quantize_int8"] == 9,
            f"quant path: {out['path']['launches']['quantize_int8']} "
            "launches for 9 weight matrices")
    del model
    torch.cuda.empty_cache()
    return out


def tp_shard(q, k_pool, v_pool, rank: int):
    """Rank ``rank``'s contiguous head block of q and of the pools."""
    h, kv = q.shape[1] // TP, k_pool.shape[2] // TP
    return (q[:, rank * h:(rank + 1) * h].contiguous(),
            k_pool[:, :, rank * kv:(rank + 1) * kv].contiguous(),
            v_pool[:, :, rank * kv:(rank + 1) * kv].contiguous())


def phase_tp_kernels(dev) -> dict:
    """#2b in one process: each rank's head block (``TP`` 2) of the paged
    kernel's serving shapes (B 8, 32/8 heads, d 128, 2048 keys, ragged,
    windows None and 512), bf16 and fp32, through
    ``paged_decode_attention_tp``: bit-equal to those heads of the
    unsharded kernel, and within tolerance of the shard's plain version;
    then rank 0's call timed beside its plain version and its bound (half
    of #2's bytes)."""
    from deepspeed_tpu_torch.ops.kernels import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_attention_tp)
    from deepspeed_tpu_torch.parallel import MeshLayout, ProcessMesh
    meshes = [ProcessMesh(MeshLayout(tp=TP), rank=r) for r in range(TP)]
    h = SLICE["h"] // TP
    gen = torch.Generator(device=dev).manual_seed(4321)
    _, lengths, smax, windows = CHECKS[0]
    reset_launches(paged_decode_attention_tp)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, _, _, kp, vp, tables, lens = make_inputs(dtype, lengths, smax,
                                                    gen, dev)
        for window in windows:
            whole = paged_decode_attention(q, kp, vp, tables, lens,
                                           window=window)
            for r in range(TP):
                qs, ks, vs = tp_shard(q, kp, vp, r)
                got = paged_decode_attention_tp(qs, ks, vs, tables, lens,
                                                meshes[r], window=window)
                torch.cuda.synchronize()
                what = (f"paged_decode_attention_tp rank {r} "
                        f"{str(dtype).split('.')[-1]} window={window}")
                require(torch.equal(got, whole[:, r * h:(r + 1) * h]),
                        f"{what}: not the unsharded kernel's heads")
                errs[what] = check_close(what, got, paged_decode_attention_plain(
                    qs, ks, vs, tables, lens, window), dtype)
    launches = paged_decode_attention_tp.launches
    sets = []
    for _ in range(3):  # 3 x 34 MB of K/V shards: each call finds them cold
        q, _, _, kp, vp, tables, lens = make_inputs(
            torch.bfloat16, [smax] * SLICE["B"], smax, gen, dev)
        sets.append((*tp_shard(q, kp, vp, 0), tables, lens))
    cycles = sleep_cycles_per_ms()
    q0, *_, l0 = sets[0]
    bound_ms, by = decode_bound_ms(q0, l0, SLICE["kv_h"] // TP, smax, True)
    out = dict(
        kernel_time=time_ms([lambda s=s: paged_decode_attention_tp(
            *s, meshes[0]) for s in sets], cycles),
        plain_time=time_ms([lambda s=s: paged_decode_attention_plain(*s)
                            for s in sets], cycles),
        library_time=None,
        library_call="none: no single PyTorch call attends through a block "
                     "table",
        bound_ms=bound_ms, bound_by=by, launches_this_phase=launches,
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        bit_equal_to_unsharded=True, tp=TP,
        heads_per_rank=dict(h=h, kv_h=SLICE["kv_h"] // TP),
        tolerance={"float32": TOL[torch.float32],
                   "bfloat16": TOL[torch.bfloat16]},
        timed_at="bf16, B 8, every length 2048, no window, rank 0's 16/4 "
                 "heads")
    del sets
    torch.cuda.empty_cache()
    return {"paged_decode_attention_tp": out}


def tp_rank_model(seed: int, dtype, num_layers: int, moe: bool = False,
                  opt: bool = False):
    """In a rank: card 0, the gloo group through the host, the ``TP``-way
    mesh, and this rank's split of a seeded Llama-3-8B (``moe``: of a
    Mixtral-8x7B, ``opt``: of an OPT-1.3B; the whole weights are drawn, so
    the split is the one-rank model's slice)."""
    from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, MixtralConfig,
                                     MixtralModel, OPTConfig, OPTModel,
                                     init_distributed)
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.utils import groups

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_distributed(dist_backend="gloo", device=dev)
    mesh = groups.initialize_mesh(MeshLayout.infer(tp=TP))
    if opt:
        return OPTModel(OPTConfig.opt_1_3b(num_layers=num_layers,
                                           dtype=dtype), device=dev,
                        seed=seed, mesh=mesh)
    if moe:
        return MixtralModel(MixtralConfig.mixtral_8x7b(
            num_layers=num_layers, dtype=dtype), device=dev, seed=seed,
            mesh=mesh)
    cfg = LlamaConfig.llama3_8b(num_layers=num_layers, dtype=dtype)
    return LlamaModel(cfg, device=dev, seed=seed, mesh=mesh)


def serving_tp_rank(rank: int, seed: int, prompts, opt_prompts) -> dict:
    """One rank of serve_tp, generate_tp and agree_tp (one launch):
    Llama-3-8B widths at ``SERVE_TP_LAYERS``, bf16, served through
    ``build_serving_frontend(mesh=...)`` (``pump()`` on this rank) and
    generated through ``init_inference``, then OPT-1.3B the same way, then
    the agreement runs (:func:`agree_tp_rank`) on ``prompts`` and
    ``opt_prompts``."""
    from deepspeed_tpu_torch import KVCacheConfig

    model = tp_rank_model(seed, torch.bfloat16, SERVE_TP_LAYERS)
    rng = np.random.default_rng(seed + 7)  # the same requests on every rank
    s = serve(model, rng, cache_config=KVCacheConfig(
        num_blocks=1025, block_size=16, max_seq_len=2048),
        header_len=SERVE_TP_HEADER, requests=SERVE_TP_REQUESTS,
        mesh=model.mesh, **SERVE_ENGINE)
    s["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ids = torch.from_numpy(rng.integers(0, model.config.vocab_size,
                                        (V1_BATCH, V1_PROMPT)))
    out = {"serve": s, "generate": generate_v1(model, ids, V1_NEW)}
    del model
    torch.cuda.empty_cache()
    # OPT-1.3B at tp 2: each rank's 16 of 32 heads (d 64)
    model = tp_rank_model(seed, torch.bfloat16, OPT_TP_LAYERS, opt=True)
    rng = np.random.default_rng(seed + 7)
    out["serve_opt"] = serve(model, rng, cache_config=KVCacheConfig(
        num_blocks=1025, block_size=16, max_seq_len=2048),
        header_len=SERVE_TP_HEADER, requests=SERVE_TP_REQUESTS,
        mesh=model.mesh, **SERVE_ENGINE)
    ids = torch.from_numpy(rng.integers(0, model.config.vocab_size,
                                        (V1_BATCH, V1_PROMPT)))
    out["generate_opt"] = generate_v1(model, ids, V1_NEW)
    out["opt_heads_a_rank"] = model.num_local_heads
    del model
    torch.cuda.empty_cache()
    out["agree"] = agree_tp_rank(rank, seed, prompts, AGREE_TP_NEW,
                                 opt_prompts=opt_prompts)
    return out


def serving_tp_launch(dev, seed: int) -> dict:
    """The launch serve_tp and serve_moe_tp share (``TP`` ranks on card 0
    over gloo): each rank runs :func:`serving_tp_rank`, then
    :func:`serving_moe_tp_rank`; the agreements' ``tp=1`` runs here
    first."""
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build()  # here, so the ranks do not both run nvcc
    agree_in = {"llama": agree_tp_inputs(dev, seed),
                "moe": agree_tp_inputs(dev, seed, moe=True)}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(shared_rank, TP, ([
        ("serve_tp", serving_tp_rank, (seed, agree_in["llama"]["prompts"],
                                       agree_in["llama"]["opt_prompts"])),
        ("serve_moe_tp", serving_moe_tp_rank,
         (seed, agree_in["moe"]["prompts"]))],), timeout=2 * TP_TIMEOUT)
    return {"ranks": ranks, "wall": time.perf_counter() - t0,
            "agree_in": agree_in}


def phase_serving_tp(dev, seed: int) -> dict:
    """serve_tp, generate_tp and agree_tp, from the launch of ``TP`` ranks
    on card 0 over gloo (``launcher.local``) they share with serve_moe_tp
    (:func:`serving_tp_launch`); every budget returned (``serve``), both ranks'
    tokens equal, ``paged_decode_attention_tp`` ``L`` times a decode step
    and the decode kernel ``L x 31`` times on each rank, the unsharded paged
    kernel never; the agreement as :func:`check_agree_tp`."""
    got = shared_launch("serving_tp", lambda: serving_tp_launch(dev, seed))
    ranks, wall = [r["serve_tp"] for r in got["ranks"]], got["wall"]
    agree_in = got["agree_in"]["llama"]
    for r, res in enumerate(ranks):
        for s_key, g_key, L in (("serve", "generate", SERVE_TP_LAYERS),
                                ("serve_opt", "generate_opt",
                                 OPT_TP_LAYERS)):
            require_serving_tp(r, res[s_key], res[g_key], L, s_key)
        from deepspeed_tpu_torch import OPTConfig
        require(res["opt_heads_a_rank"] == OPTConfig.opt_1_3b().num_heads
                // TP,
                f"serve_tp opt rank {r}: {res['opt_heads_a_rank']} heads")
    for key in ("serve", "generate", "serve_opt", "generate_opt"):
        require(all(res[key]["tokens"] == ranks[0][key]["tokens"]
                    for res in ranks), f"{key}_tp: the ranks' tokens differ")
    agree = check_agree_tp([r.pop("agree") for r in ranks], agree_in)
    return {"ranks": ranks, "launch_wall_s": wall,
            "agree": dict(agree, launch_wall_s=wall)}


def require_serving_tp(r: int, serve_res: dict, gen_res: dict, L: int,
                       what: str) -> None:
    """#2b ``L`` times a decode step and no unsharded kernel in the
    serve; the decode kernel ``L x (V1_NEW - 1)`` times and no paged one
    in the generate."""
    la, lg = serve_res["launches"], gen_res["launches"]
    steps = serve_res["decode_steps"]
    require(la["paged_decode_attention_tp"] == L * steps,
            f"{what}_tp rank {r}: paged_decode_attention_tp launched "
            f"{la['paged_decode_attention_tp']} times, want {L} x "
            f"{steps} decode steps")
    require(la["paged_decode_attention"] == 0 and
            la["decode_attention"] == 0,
            f"{what}_tp rank {r}: an unsharded decode kernel ran: {la}")
    require(lg["decode_attention"] == L * (V1_NEW - 1),
            f"{what}_tp rank {r}: generate's decode kernel launched "
            f"{lg['decode_attention']} times, want {L} x {V1_NEW - 1}")
    require(lg["paged_decode_attention"] == 0 and
            lg["paged_decode_attention_tp"] == 0,
            f"{what}_tp rank {r}: a paged kernel ran in generate: {lg}")


def logit_rel_err(got, want) -> float:
    """Largest ``|got - want| / (1 + |want|)``."""
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def agree_tp_run(model, prompts, n_new: int) -> dict:
    """v2 and v1 greedy tokens of ``prompts`` and the first prompt's
    last-token logits (``prefill``), with the launches they made."""
    from deepspeed_tpu_torch import (KVCacheConfig, build_engine_v2,
                                     init_inference)
    reset_counts()
    v2 = build_engine_v2(model, cache_config=KVCacheConfig(
        num_blocks=128, block_size=16, max_seq_len=512), max_batch_slots=4,
        prefill_chunk=64, decode_burst=8, device=model.device,
        mesh=model.mesh).generate(prompts, max_new_tokens=n_new)
    v1 = init_inference(model, tensor_parallel={"tp_size": model.tp},
                        device=model.device)
    v1_tokens = [v1.generate([p], max_new_tokens=n_new)[0, len(p):].tolist()
                 for p in prompts]
    ids = torch.tensor([prompts[0]], device=model.device)
    logits, _ = model.prefill(ids, model.init_cache(1, ids.shape[1]))
    return {"v2": v2, "v1": v1_tokens, "logits": logits.cpu().numpy(),
            "launches": read_counts()}


AGREE_TP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def agree_tp_rank(rank: int, seed: int, prompts, n_new: int,
                  moe: bool = False, opt_prompts=None) -> dict:
    out = {}
    for name, dtype in AGREE_TP_DTYPES.items():
        model = tp_rank_model(seed, dtype, agree_tp_layers(moe), moe)
        out[name] = agree_tp_run(model, prompts, n_new)
        del model
        torch.cuda.empty_cache()
    if opt_prompts is not None:  # fp32 OPT-1.3B widths
        model = tp_rank_model(seed, torch.float32, AGREE_OPT_LAYERS,
                              opt=True)
        out["opt_float32"] = agree_tp_run(model, opt_prompts, n_new)
        del model
        torch.cuda.empty_cache()
    return out


def agree_tp_layers(moe: bool) -> int:
    return AGREE_MOE_TP_LAYERS if moe else AGREE_TP_LAYERS


def agree_tp_inputs(dev, seed: int, moe: bool = False) -> dict:
    """agree_tp's (``moe``: agree_moe_tp's) prompts and its ``tp=1`` runs
    in this process, before the ranks run the ``tp=2`` side in their
    serving launch (:func:`check_agree_tp` holds the two together)."""
    from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, MixtralConfig,
                                     MixtralModel)

    what = "agree_moe_tp" if moe else "agree_tp"
    layers = agree_tp_layers(moe)
    cfg = (MixtralConfig.mixtral_8x7b if moe else LlamaConfig.llama3_8b)(
        num_layers=layers)
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in AGREE_TP_PROMPTS]
    ref = {}
    for name, dtype in AGREE_TP_DTYPES.items():
        model = (MixtralModel if moe else LlamaModel)(
            dataclasses.replace(cfg, dtype=dtype), device=dev, seed=seed)
        ref[name] = agree_tp_run(model, prompts, AGREE_TP_NEW)
        require(ref[name]["launches"]["paged_decode_attention"] > 0 and
                ref[name]["launches"]["decode_attention"] > 0,
                f"{what} tp=1 {name}: a decode kernel did not run")
        del model
        torch.cuda.empty_cache()
    opt_prompts = None
    if not moe:  # OPT-1.3B widths at AGREE_OPT_LAYERS, fp32, tp 1 here
        from deepspeed_tpu_torch import OPTConfig, OPTModel
        ocfg = OPTConfig.opt_1_3b(num_layers=AGREE_OPT_LAYERS,
                                  dtype=torch.float32)
        opt_prompts = [rng.integers(0, ocfg.vocab_size, n).tolist()
                       for n in AGREE_TP_PROMPTS]
        model = OPTModel(ocfg, device=dev, seed=seed)
        ref["opt_float32"] = agree_tp_run(model, opt_prompts, AGREE_TP_NEW)
        del model
        torch.cuda.empty_cache()
    return {"moe": moe, "prompts": prompts, "opt_prompts": opt_prompts,
            "ref": ref}


def check_agree_tp(ranks: list, inputs: dict) -> dict:
    """Llama-3-8B widths at ``AGREE_TP_LAYERS`` layers (``moe``:
    Mixtral-8x7B widths at ``AGREE_MOE_TP_LAYERS``), the same seed at
    ``tp`` 1 (``inputs["ref"]``, this process) and 2 (``ranks``, each
    rank's :func:`agree_tp_rank`): in fp32 the ``tp=2`` v2 and v1 greedy
    tokens equal the ``tp=1`` ones and the first logits agree to 1e-4
    relative to 1 + |ref|.  In bf16 the two partial sums round
    differently, so tokens may differ (the agreement is reported) and the
    logits are held to the fp32 ``tp=1`` logits: the ``tp=2`` ones may lie
    at most ``BF16_TP_SLACK`` times as far from them as the bf16 ``tp=1``
    ones do.  Both ranks must agree bit for bit.  A Mixtral's prefill runs
    the dispatch and combine kernels on every rank's ``I/tp`` expert
    columns; fp32 OPT's tokens equal and its logits agree as the Llama's."""
    moe, ref, opt_prompts = inputs["moe"], inputs["ref"], \
        inputs["opt_prompts"]
    what = "agree_moe_tp" if moe else "agree_tp"
    layers = agree_tp_layers(moe)
    out = {}
    for name, dtype in AGREE_TP_DTYPES.items():
        got, want = ranks[0][name], ref[name]
        for other in ranks[1:]:
            require(other[name]["v2"] == got["v2"]
                    and other[name]["v1"] == got["v1"]
                    and np.array_equal(other[name]["logits"], got["logits"]),
                    f"{what} {name}: the ranks differ")
        la = got["launches"]
        require(la["paged_decode_attention_tp"] > 0 and
                la["decode_attention"] > 0 and
                la["paged_decode_attention"] == 0 and
                (not moe or la["moe_dispatch"] > 0 and la["moe_combine"] > 0),
                f"{what} tp={TP} {name}: launches {la}")
        rel = logit_rel_err(got["logits"], want["logits"])
        exact = ref["float32"]["logits"]
        if dtype == torch.float32:
            require(rel <= TOL[dtype], f"{what} fp32: first logits differ "
                                       f"by {rel} relative, over {TOL[dtype]}")
        else:
            own, tp_err = (logit_rel_err(want["logits"], exact),
                           logit_rel_err(got["logits"], exact))
            require(tp_err <= BF16_TP_SLACK * own,
                    f"{what} bf16: tp={TP} logits lie {tp_err} from the fp32 "
                    f"ones, tp=1's {own}")

        def agreement(a, b):
            pairs = [(x, y) for p, q in zip(a, b) for x, y in zip(p, q)]
            return sum(x == y for x, y in pairs) / len(pairs)

        out[name] = {"max_rel_logit_err": rel,
                     "vs_fp32_tp1": logit_rel_err(got["logits"], exact),
                     "tp1_vs_fp32_tp1": logit_rel_err(want["logits"], exact),
                     "v2_token_agreement": agreement(got["v2"], want["v2"]),
                     "v1_token_agreement": agreement(got["v1"], want["v1"]),
                     "tp1_v2_equals_v1": want["v2"] == want["v1"],
                     "launches_tp": la, "launches_tp1": want["launches"]}
        if dtype == torch.float32:
            require(got["v2"] == want["v2"] and got["v1"] == want["v1"],
                    f"{what} fp32: tp={TP} tokens differ from tp=1's")
    if opt_prompts is not None:
        got, want = ranks[0]["opt_float32"], ref["opt_float32"]
        for other in ranks[1:]:
            require(other["opt_float32"]["v2"] == got["v2"] and
                    other["opt_float32"]["v1"] == got["v1"],
                    f"{what} opt: the ranks differ")
        la = got["launches"]
        require(la["paged_decode_attention_tp"] > 0 and
                la["decode_attention"] > 0 and
                la["paged_decode_attention"] == 0,
                f"{what} opt tp={TP}: launches {la}")
        rel = logit_rel_err(got["logits"], want["logits"])
        require(rel <= TOL[torch.float32],
                f"{what} opt fp32: first logits differ by {rel} relative")
        require(got["v2"] == want["v2"] and got["v1"] == want["v1"] and
                want["v2"] == want["v1"],
                f"{what} opt fp32: tp={TP} tokens differ from tp=1's")
        out["opt_float32"] = {
            "model": OPT_NAME, "reduced": [
                f"num_layers 24 -> {AGREE_OPT_LAYERS}"],
            "max_rel_logit_err": rel, "tokens_equal": True,
            "launches_tp": la, "launches_tp1": want["launches"]}
    return {"model": "mixtral_8x7b" if moe else "llama3_8b",
            "reduced": [f"num_layers 32 -> {layers}"],
            "prompts": list(AGREE_TP_PROMPTS), "new_tokens": AGREE_TP_NEW,
            "comm": TP_NOTE, **out}


# -- the expert-parallel slice -------------------------------------------------

MOE_EP, MOE_EP_STEPS, MOE_EP_TIMEOUT = 2, 2, 900
#: train_moe_ep's depth: 1 of Mixtral-8x7B's 32 layers (train_moe's 2 ->
#: 1, the script's length)
MOE_EP_LAYERS = 1
MOE_EP_NOTE = ("2 ranks on card 0 over gloo, every collective (the experts' "
               "exchange included) through pinned host memory: a "
               "correctness and memory check, the step time on the host "
               "clock is not an EP speed")
#: train_moe_ep_agree: Mixtral-8x7B widths at 1 layer in fp32, one global
#: batch of 4 rows of 512 tokens, 2 rows a rank at ep 2
MOE_AGREE_LAYERS, MOE_AGREE_ROWS, MOE_AGREE_SEQ, MOE_AGREE_STEPS = \
    1, 4, 512, 2
#: (label, ep, dp, ZeRO stage) of the agreement, run in train_moe_ep's
#: launch.  ep 2 x dp 2 is held against JAX by the CPU tests only: on one
#: card its four gloo ranks took 25 s a step (the expert stacks' fp32
#: collectives over ``data`` through the host), 88 of the phase's 128 s on
#: an H100 80GB HBM3 at 700 W
MOE_AGREE_RUN = ("ep2", MOE_EP, 1, 0)
#: the checkpoint check's narrow fp32 Mixtral (train_agree's widths, the
#: 8 experts and top-2 of Mixtral-8x7B): its save stays small
MOE_CKPT_MODEL = dict(AGREE_TRAIN, num_experts=8, top_k=2)
#: serve_moe_tp: Mixtral-8x7B at 1 of 32 layers, bf16, two ranks (cut as
#: serve_tp)
MOE_TP_LAYERS = 1


def ep_mesh(ep: int, dp: int):
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.utils import groups
    return groups.initialize_mesh(MeshLayout.infer(ep * dp, ep=ep, dp=dp))


def ep_rank_params(cfg, ep: int) -> int:
    """A rank's parameters of a Mixtral whose experts are split over
    ``ep``: every parameter less the other ranks' experts."""
    per_expert = 3 * cfg.hidden_size * cfg.intermediate_size
    return cfg.num_params() - cfg.num_layers * (
        cfg.num_experts - cfg.num_experts // ep) * per_expert


def moe_ep_train_rank(rank: int, seed: int) -> dict:
    """One rank of train_moe_ep: Mixtral-8x7B widths, ``MOE_EP_LAYERS``
    layers, this rank's 4 of the 8 experts, its ``[1, 2048]`` row of the
    global batch, ``MOE_EP_STEPS`` steps with fused Adam; then the layers'
    summed ``l_aux`` of a no-grad pass over its row."""
    from deepspeed_tpu_torch import MixtralConfig, MixtralModel, initialize

    dev = zero_rank_setup()
    mesh = ep_mesh(MOE_EP, 1)
    cfg = MixtralConfig.mixtral_8x7b(
        num_layers=MOE_EP_LAYERS, dtype=torch.bfloat16,
        param_dtype=torch.float32, attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    model = MixtralModel(cfg, device=dev, seed=seed, mesh=mesh)
    engine, *_ = initialize(model=model, config=dict(
        ds_config(model, 1, fused_adam=True),
        moe={"expert_parallel_size": MOE_EP}), device=dev, mesh=mesh)
    rows = zero_batch(seed, cfg.vocab_size, MOE_EP, dev)[rank:rank + 1]
    reset_counts()
    metrics, marks = [], []
    for _ in range(MOE_EP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(engine.train_step({"input_ids": rows}))
        torch.cuda.synchronize()
        marks.append((time.perf_counter() - t0) * 1e3)
    launches = train_launches()
    with torch.no_grad():
        _, aux = model.hidden_states(rows)
    layer = model._moe_layer
    return {"loss": [float(m["loss"]) for m in metrics],
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "l_aux": float(aux), "capacity": layer.last_capacity,
            "rung": layer.last_impl, "launches": launches,
            "params": sum(p.numel() for p in engine.params),
            "state_bytes": zero_state_bytes(engine),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "host_step_ms": marks}


def moe_ep_rank(rank: int, seed: int, save_dir: str) -> dict:
    """One rank of train_moe_ep and train_moe_ep_agree (one launch)."""
    out = moe_ep_train_rank(rank, seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the agreement's own peak
    out["agree"] = moe_agree_rank(rank, seed, *MOE_AGREE_RUN, save_dir)
    return out


def phase_train_moe_ep(dev, seed: int) -> dict:
    """train_moe_ep and train_moe_ep_agree (from train_zero's launch of
    ``MOE_EP`` ranks on card 0 over gloo), each rank holding 4 of Mixtral-8x7B's 8 experts
    (2 layers, bf16 on fp32 masters, fused Adam, ``[1, 2048]`` a rank):
    finite, falling losses equal on both ranks; one ``l_aux`` on both (the
    gate routes the global batch); per rank and step dispatch and combine
    2 L times, flash as its formula, Σg² and Adam once; each rank's state
    to the byte of the prediction (16 bytes a parameter it holds); then
    the agreement (:func:`check_moe_ep_agree`, its one-process run before
    the launch)."""
    from deepspeed_tpu_torch import MixtralConfig

    got = shared_launch("zero", lambda: zero_family_launch(dev, seed))
    ranks, wall = [r["moe_ep"] for r in got["ranks"]], got["wall"]
    agree_in = got["moe_agree_in"]
    cfg = MixtralConfig.mixtral_8x7b(num_layers=MOE_EP_LAYERS)
    want_params = ep_rank_params(cfg, MOE_EP)
    for r, res in enumerate(ranks):
        losses = res["loss"]
        require(all(np.isfinite(losses)),
                f"train_moe_ep rank {r}: non-finite loss {losses}")
        require(losses[-1] < losses[0],
                f"train_moe_ep rank {r}: loss did not fall: {losses}")
        require(losses == ranks[0]["loss"] and
                res["l_aux"] == ranks[0]["l_aux"] and
                res["capacity"] == ranks[0]["capacity"],
                f"train_moe_ep: rank {r}'s losses {losses}, l_aux "
                f"{res['l_aux']} differ from rank 0's {ranks[0]['loss']}, "
                f"{ranks[0]['l_aux']}")
        require(res["rung"] == "pallas", f"train_moe_ep rank {r}: the MoE "
                                         f"layer took the {res['rung']} rung")
        require_train_launches(f"train_moe_ep rank {r}", dict(
            layers=MOE_EP_LAYERS, steps=MOE_EP_STEPS, remat=True,
            fused_adam=True, launches=res["launches"]), moe=True)
        require(res["params"] == want_params and
                res["state_bytes"]["total"] == 16 * want_params,
                f"train_moe_ep rank {r}: {res['params']} parameters, "
                f"{res['state_bytes']['total']} state bytes; predicted "
                f"{want_params}, {16 * want_params}")
    peak = sum(res["peak_mem_bytes"] for res in ranks)
    require(peak < torch.cuda.get_device_properties(0).total_memory,
            f"train_moe_ep: the ranks' peaks add to {peak} B")
    agree = check_moe_ep_agree(dev, seed, [r.pop("agree") for r in ranks],
                               agree_in)
    return {"ranks": ranks, "predicted_params_a_rank": want_params,
            "params_one_process": cfg.num_params(),
            "predicted_state_bytes_a_rank": 16 * want_params,
            "peak_mem_bytes_sum": peak, "wall_s": wall,
            "agree": dict(agree, launch_wall_s=wall)}


def moe_agree_inputs(seed: int, dev) -> tuple:
    from deepspeed_tpu_torch import MixtralConfig

    cfg = MixtralConfig.mixtral_8x7b(
        num_layers=MOE_AGREE_LAYERS, dtype=torch.float32,
        param_dtype=torch.float32, attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    ids = torch.randint(0, cfg.vocab_size, (MOE_AGREE_ROWS, MOE_AGREE_SEQ),
                        generator=gen, device=dev)
    return cfg, ids


def moe_agree_steps(cfg, ids, dev, seed: int, mesh=None, ep: int = 1,
                    stage: int = 0) -> dict:
    """``MOE_AGREE_STEPS`` steps of the fp32 Mixtral on ``ids`` (this
    rank's rows): losses and grad norms."""
    from deepspeed_tpu_torch import MixtralModel, initialize

    model = MixtralModel(cfg, device=dev, seed=seed, mesh=mesh)
    engine, *_ = initialize(model=model, config=dict(
        ds_config(model, ids.shape[0], stage=stage),
        moe={"expert_parallel_size": ep}), device=dev, mesh=mesh)
    ms = [engine.train_step({"input_ids": ids})
          for _ in range(MOE_AGREE_STEPS)]
    return {"loss": [float(m["loss"]) for m in ms],
            "grad_norm": [float(m["grad_norm"]) for m in ms]}


def leaf_digests(engine) -> dict:
    """sha256 of each leaf's fp32 master, m and v as this rank holds them,
    with the box of the whole leaf they fill."""
    import hashlib

    from deepspeed_tpu_torch.runtime.checkpointing import (_held_boxes,
                                                           leaf_shape)
    opt, out = engine.optimizer, {}
    boxes, masters = _held_boxes(engine), engine._masters()
    for i, name in enumerate(engine.param_names):
        row = {key: hashlib.sha256(t.detach().contiguous().cpu().numpy()
                                   .tobytes()).hexdigest()
               for key, t in (("master", masters[i]), ("m", opt.m[i]),
                              ("v", opt.v[i]))}
        row["box"] = boxes[i][1]
        row["full_shape"] = leaf_shape(engine, i)
        out[name] = row
    return out


def boxed_digests(engine, name: str, box) -> dict:
    """sha256 of ``box`` of leaf ``name``'s master, m and v in an engine
    that holds the leaf whole."""
    import hashlib

    i = engine.param_names.index(name)
    out = {}
    for key, t in (("master", engine.params[i]),
                   ("m", engine.optimizer.m[i]),
                   ("v", engine.optimizer.v[i])):
        for d, (lo, hi) in enumerate(box):
            t = t.narrow(d, lo, hi - lo)
        out[key] = hashlib.sha256(t.detach().contiguous().cpu().numpy()
                                  .tobytes()).hexdigest()
    return out


def moe_ckpt_engine(dev, seed: int, mesh=None, ep: int = 1):
    from deepspeed_tpu_torch import MixtralConfig, MixtralModel, initialize

    model = MixtralModel(MixtralConfig(**MOE_CKPT_MODEL), device=dev,
                         seed=seed, mesh=mesh)
    engine, *_ = initialize(model=model, config=dict(
        ds_config(model, 1), moe={"expert_parallel_size": ep}),
        device=dev, mesh=mesh)
    return engine


def moe_agree_rank(rank: int, seed: int, label: str, ep: int, dp: int,
                   stage: int, save_dir) -> dict:
    """One rank of train_moe_ep_agree: this rank's rows of the global
    batch at ``ep x dp``; with ``save_dir``, then the narrow Mixtral's two
    steps on this rank's row and a save, with the digests of its slices."""
    dev = zero_rank_setup()
    mesh = ep_mesh(ep, dp)
    cfg, ids = moe_agree_inputs(seed, dev)
    n = MOE_AGREE_ROWS // (ep * dp)
    # every rank draws the seed's whole weights and keeps its slice
    t0 = time.perf_counter()
    out = moe_agree_steps(cfg, ids[rank * n:(rank + 1) * n], dev, seed,
                          mesh, ep, stage)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["steps_wall_s"] = time.perf_counter() - t0
    if save_dir is not None:
        engine = moe_ckpt_engine(dev, seed + 20 + rank, mesh, ep)
        gen = torch.Generator(device=dev).manual_seed(seed + rank)
        for _ in range(2):
            engine.train_step({"input_ids": torch.randint(
                0, MOE_CKPT_MODEL["vocab_size"], (1, 128), generator=gen,
                device=dev)})
        engine.save_checkpoint(save_dir)
        out["digests"] = leaf_digests(engine)
    return out


def moe_ep_agree_inputs(dev, seed: int) -> dict:
    """train_moe_ep_agree's one-process run and the ranks' save
    directory."""
    cfg, ids = moe_agree_inputs(seed, dev)
    t0 = time.perf_counter()
    want = moe_agree_steps(cfg, ids, dev, seed)
    return {"want": want, "save_dir": ckpt_root(),
            "one_process_wall_s": time.perf_counter() - t0}


def check_moe_ep_agree(dev, seed: int, ranks: list, inputs: dict) -> dict:
    """train_moe_ep_agree: fp32 Mixtral-8x7B widths at one layer on one
    global batch of ``[4, 512]``: ep 2 (``ranks``, 2 rows each, ZeRO 0) on
    card 0 over gloo give the one process's losses and grad norms to 1e-4.
    The ep-2 ranks then saved the narrow fp32 Mixtral (8 experts) after
    two steps; one process loads it: every rank's slice of masters, m and
    v bit-equal (sha256)."""
    import shutil

    want, save_dir = inputs["want"], inputs["save_dir"]
    label = MOE_AGREE_RUN[0]
    rel = {}
    for r, got in enumerate(ranks):
        for what in ("loss", "grad_norm"):
            rel[f"{label}_rank{r}_{what}"] = e = _max_rel(got[what],
                                                          want[what])
            require(e <= 1e-4, f"train_moe_ep_agree {label} rank {r}: "
                               f"{what} {got[what]} != one process's "
                               f"{want[what]} (rel {e})")
    engine = moe_ckpt_engine(dev, seed + 99)
    engine.load_checkpoint(save_dir)
    checked = 0
    for r, got in enumerate(ranks):
        for name, row in got.pop("digests").items():
            mine = boxed_digests(engine, name, row["box"])
            require(all(mine[k] == row[k] for k in mine),
                    f"train_moe_ep_agree: rank {r}'s {name} (box "
                    f"{row['box']}) differs after the load")
            checked += 1
    require(engine.optimizer.count == 2, "train_moe_ep_agree: the loaded "
                                         "step count is not 2")
    shutil.rmtree(save_dir, ignore_errors=True)
    return {"one_process": want, "runs": {label: ranks}, "max_rel": rel,
            "checkpoint": {"slices_bit_equal": checked,
                           "model": "narrow fp32 Mixtral (H 256, 8 experts)"},
            "layers": MOE_AGREE_LAYERS,
            "global_batch": [MOE_AGREE_ROWS, MOE_AGREE_SEQ],
            "one_process_wall_s": inputs["one_process_wall_s"]}


def serving_moe_tp_rank(rank: int, seed: int, prompts) -> dict:
    """One rank of serve_moe_tp, generate_moe_tp and agree_moe_tp (one
    launch): Mixtral-8x7B at ``MOE_TP_LAYERS`` layers, bf16, its ``I/tp``
    expert columns and half the heads, behind
    ``build_serving_frontend(mesh=...)`` with the serve_moe phase's knobs
    and requests, then ``init_inference``; then the agreement runs
    (:func:`agree_tp_rank`) on ``prompts``."""
    from deepspeed_tpu_torch import KVCacheConfig

    model = tp_rank_model(seed, torch.bfloat16, MOE_TP_LAYERS, moe=True)
    rng = np.random.default_rng(seed)
    s = serve(model, rng, cache_config=KVCacheConfig(
        num_blocks=1025, block_size=16, max_seq_len=2048), header_len=512,
        requests=SERVE_REQUESTS, mesh=model.mesh, **SERVE_ENGINE)
    s["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ids = torch.from_numpy(rng.integers(0, model.config.vocab_size,
                                        (V1_BATCH, V1_PROMPT)))
    out = {"serve": s, "generate": generate_v1(model, ids, V1_NEW)}
    del model
    torch.cuda.empty_cache()
    out["agree"] = agree_tp_rank(rank, seed, prompts, AGREE_TP_NEW, moe=True)
    return out


def phase_serving_moe_tp(dev, seed: int) -> dict:
    """serve_moe_tp, generate_moe_tp and agree_moe_tp, from serve_tp's
    launch (:func:`serving_tp_launch`); every budget returned, both ranks' tokens equal; on each rank #2b
    ``L`` times a decode step, dispatch and combine ``L`` times a prefill
    call (never in a decode burst: the dense rung), and in generate the
    decode kernel ``L x 31`` times and dispatch and combine ``L`` times;
    the agreement as :func:`check_agree_tp`."""
    got = shared_launch("serving_tp", lambda: serving_tp_launch(dev, seed))
    ranks, wall = [r["serve_moe_tp"] for r in got["ranks"]], got["wall"]
    agree_in = got["agree_in"]["moe"]
    L = MOE_TP_LAYERS
    for r, res in enumerate(ranks):
        la, lg = res["serve"]["launches"], res["generate"]["launches"]
        steps, calls = (res["serve"]["decode_steps"],
                        res["serve"]["prefill_calls"])
        require(la["paged_decode_attention_tp"] == L * steps and
                la["paged_decode_attention"] == 0 and
                la["decode_attention"] == 0,
                f"serve_moe_tp rank {r}: paged launches {la}, want #2b "
                f"{L} x {steps} decode steps and no unsharded kernel")
        for kernel in MOE_KERNELS:
            require(la[kernel] == L * calls and lg[kernel] == L,
                    f"moe tp rank {r}: {kernel} launched {la[kernel]} times "
                    f"in serve (want {L} x {calls} prefill calls) and "
                    f"{lg[kernel]} in generate (want {L})")
        require(lg["decode_attention"] == L * (V1_NEW - 1) and
                lg["paged_decode_attention_tp"] == 0,
                f"generate_moe_tp rank {r}: decode launches {lg}")
    for key in ("serve", "generate"):
        require(all(res[key]["tokens"] == ranks[0][key]["tokens"]
                    for res in ranks),
                f"{key}_moe_tp: the ranks' tokens differ")
    agree = check_agree_tp([r.pop("agree") for r in ranks], agree_in)
    return {"ranks": ranks, "launch_wall_s": wall,
            "agree": dict(agree, launch_wall_s=wall)}


# -- main ------------------------------------------------------------------

# -- the ladder-model slice: BERT, ResNet, OPT ------------------------------

#: train_bert: BERT-large at full width and depth, ``[8, 512]`` a step
BERT_STEPS, BERT_BATCH, BERT_SEQ = 8, 8, 512
#: the share of real tokens that carry an MLM label
BERT_MLM_RATE = 0.15
#: train_bert_zero: BERT-large widths at ``num_layers 24 -> 1`` on two gloo
#: ranks (the script's length), the global ``[8, 512]``
#: batch, ZeRO stages 0-2 (BASELINE config 2's ZeRO-1/2),
#: ``BERT_ZERO_STEPS`` steps each
BERT_ZERO_LAYERS, BERT_ZERO_STEPS = 1, 2
BERT_ZERO_RUNS = (("stage0", 0), ("stage1", 1), ("stage2", 2))
#: train_resnet: ResNet-56 on one fixed ``[128, 32, 32, 3]`` batch of seeded
#: images, 10 classes, Adam lr 1e-3
RESNET_STEPS, RESNET_BATCH = 12, 128
#: serve_opt / generate_opt: OPT-1.3B at full width and depth, bf16
OPT_NAME = "opt_1_3b"


def bert_batch(vocab: int, rows: int, seed: int, dev) -> dict:
    """An MLM batch from ``seed`` (the same on every rank): random ids,
    a pad tail a row (``pad_segments``: 0-200 pads, row 0 none) as the
    attention mask, token type 0 then 1 from the middle of the sequence,
    and ``BERT_MLM_RATE`` of the real tokens labelled (a random id; -100
    elsewhere and on pads)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, vocab, (rows, BERT_SEQ), generator=gen,
                        device=dev)
    mask = pad_segments(rows, BERT_SEQ, gen, dev)
    types = (torch.arange(BERT_SEQ, device=dev) >= BERT_SEQ // 2).to(
        torch.int32).expand(rows, BERT_SEQ).contiguous()
    picked = (torch.rand(rows, BERT_SEQ, generator=gen, device=dev)
              < BERT_MLM_RATE) & mask.bool()
    targets = torch.randint(0, vocab, (rows, BERT_SEQ), generator=gen,
                            device=dev)
    labels = torch.where(picked, targets, torch.full_like(targets, -100))
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types, "labels": labels}


def bert_config(**kw):
    from deepspeed_tpu_torch import BertConfig
    return BertConfig.bert_large(dtype=torch.bfloat16,
                                 param_dtype=torch.float32,
                                 attn_impl="flash", **kw)


def phase_train_bert(dev, seed: int) -> dict:
    """train_bert: BERT-large (24 x 1024, 16 heads of 64, S 512) at
    ``[8, 512]`` a step, bf16 on fp32 masters, non-causal flash with the
    pads as segment ids, AdamW lr 1e-4, ZeRO 0, remat, ``BERT_STEPS``
    steps: a finite, falling loss and the flash launches of the formula."""
    from deepspeed_tpu_torch import BertModel

    t0 = time.perf_counter()
    model = BertModel(bert_config(), device=dev, seed=seed)
    data = bert_batch(model.config.vocab_size, BERT_BATCH, seed + 1, dev)
    t = train(model, BERT_STEPS, BERT_BATCH, BERT_SEQ, seed, data=data)
    require_train_launches("train_bert", t)
    t.update(real_tokens=int(data["attention_mask"].sum()),
             mlm_labels=int((data["labels"] != -100).sum()),
             wall_s=time.perf_counter() - t0)
    del model
    torch.cuda.empty_cache()
    return t


def predicted_state_bytes(shapes: list, stage: int, dp: int,
                          data: Optional[int] = None,
                          threshold: int = 100_000) -> int:
    """A rank's fp32 training state under the placement rule
    (``runtime/zero/sharder.py``, persistence ``threshold``): masters
    whole below stage 3 (under hpZ a cut leaf's ``1/data`` chunk); Adam's
    m and v a cut leaf's chunk from stage 1; gradients a cut leaf's chunk
    from stage 2; a leaf the rule keeps whole is whole in each."""
    from deepspeed_tpu_torch.runtime.config import ZeroConfig
    from deepspeed_tpu_torch.runtime.zero import ZeroShardingPolicy

    policy = ZeroShardingPolicy.from_config(ZeroConfig(
        stage=stage, stage3_param_persistence_threshold=threshold), dp)
    total = 0
    for shape in shapes:
        n = int(np.prod(shape))
        cut = policy.shard_dim(tuple(shape)) is not None
        chunk = n // dp if cut else n
        master = n // (data or dp) if cut else n
        total += 4 * ((master if stage >= 3 else n)
                      + 2 * (chunk if stage >= 1 else n)
                      + (chunk if stage >= 2 else n))
    return total


def bert_zero_rank(rank: int, seed: int) -> dict:
    """One rank of train_bert_zero: this rank's half of the global
    ``[BERT_BATCH, 512]`` MLM batch, ``BERT_ZERO_STEPS`` steps of every
    ``BERT_ZERO_RUNS`` stage (a fresh model from this rank's seed each:
    the engine broadcasts rank 0's)."""
    from deepspeed_tpu_torch import BertModel, initialize

    dev = zero_rank_setup()
    cfg = bert_config(num_layers=BERT_ZERO_LAYERS)
    micro = BERT_BATCH // ZERO_RANKS
    data = bert_batch(cfg.vocab_size, BERT_BATCH, seed + 1, dev)
    rows = {k: v[rank * micro:(rank + 1) * micro] for k, v in data.items()}
    out = {}
    for label, stage in BERT_ZERO_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = BertModel(cfg, device=dev, seed=seed + rank)
        shapes = [tuple(p.shape) for p in model.parameters()]
        engine, *_ = initialize(model=model, config=ds_config(
            model, micro, stage=stage), device=dev)
        reset_counts()
        metrics, marks = [], []
        for _ in range(BERT_ZERO_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(engine.train_step(rows))
            torch.cuda.synchronize()
            marks.append((time.perf_counter() - t0) * 1e3)
        out[label] = {
            "stage": stage, "loss": [float(m["loss"]) for m in metrics],
            "grad_norm": [float(m["grad_norm"]) for m in metrics],
            "launches": train_launches(),
            "state_bytes": zero_state_bytes(engine),
            "predicted_state_bytes": predicted_state_bytes(
                shapes, stage, ZERO_RANKS),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "host_step_ms": marks,
            "cut_leaves": sum(p is not None for p in engine.placements),
            "leaves": len(engine.params)}
        del model, engine, metrics
    return out


def phase_train_bert_zero(dev, seed: int) -> dict:
    """train_bert_zero: two ranks on card 0 over gloo (train_zero's
    launch) at ZeRO 0, 1 and 2:
    finite, falling losses, equal on both ranks and each stage's equal to
    stage 0's (``ZERO_STAGE_RTOL``); each rank's state bytes equal to the
    byte of the placement rule; per rank and step 2 L flash forwards and L
    of each backward pass."""
    got = shared_launch("zero", lambda: zero_family_launch(dev, seed))
    ranks, wall = [r["bert_zero"] for r in got["ranks"]], got["wall"]
    base = ranks[0]["stage0"]["loss"]
    rel = {}
    for label, stage in BERT_ZERO_RUNS:
        for r, res in enumerate(ranks):
            row = res[label]
            losses = row["loss"]
            what = f"train_bert_zero {label} rank {r}"
            require(all(np.isfinite(losses)), f"{what}: loss {losses}")
            require(losses[-1] < losses[0],
                    f"{what}: loss did not fall: {losses}")
            require(losses == ranks[0][label]["loss"],
                    f"{what}: losses {losses} != rank 0's")
            require(row["state_bytes"]["total"]
                    == row["predicted_state_bytes"],
                    f"{what}: {row['state_bytes']['total']} state bytes, "
                    f"predicted {row['predicted_state_bytes']}")
            require_train_launches(what, dict(
                layers=BERT_ZERO_LAYERS, steps=BERT_ZERO_STEPS, remat=True,
                fused_adam=False, launches=row["launches"]))
        rel[label] = _max_rel(ranks[0][label]["loss"], base)
        require(rel[label] <= ZERO_STAGE_RTOL,
                f"train_bert_zero {label}: losses {ranks[0][label]['loss']}"
                f" != stage 0's {base} (rel {rel[label]})")
    return {"ranks": ranks, "loss_rel_to_stage0": rel,
            "launch_wall_s": wall}


def phase_train_resnet(dev, seed: int) -> dict:
    """train_resnet: ResNet-56 (855,578 parameters) on one fixed ``[128,
    32, 32, 3]`` batch of seeded images with 10 random classes, bf16 on
    fp32 masters, Adam lr 1e-3, ZeRO 0, ``RESNET_STEPS`` steps timed with
    CUDA events: a finite, falling loss, the step time and images/s.  The
    model is plain PyTorch (cuDNN convolutions): no kernel of the port
    runs, and none may launch."""
    from deepspeed_tpu_torch import ResNetConfig, ResNetModel, initialize

    t0 = time.perf_counter()
    cfg = ResNetConfig.resnet56(dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    model = ResNetModel(cfg, device=dev, seed=seed)
    engine, *_ = initialize(model=model, config={
        "train_micro_batch_size_per_gpu": RESNET_BATCH, "steps_per_print": 0,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": 0}, "bf16": {"enabled": True}},
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = {"images": torch.randn(RESNET_BATCH, cfg.image_size,
                                   cfg.image_size, 3, generator=gen,
                                   device=dev),
             "labels": torch.randint(0, cfg.num_classes, (RESNET_BATCH,),
                                     generator=gen, device=dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks, losses = [], []
    for _ in range(RESNET_STEPS):
        a, b = event_pair()
        a.record()
        losses.append(engine.train_step(batch)["loss"])
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    marks = [a.elapsed_time(b) for a, b in marks]
    losses = [float(x) for x in losses]
    launches = read_counts()
    require(all(np.isfinite(losses)), f"train_resnet: loss {losses}")
    require(losses[-1] < losses[0],
            f"train_resnet: loss did not fall: {losses}")
    require(not any(launches.values()),
            f"train_resnet: a port kernel ran: {launches}")
    step_ms = statistics.median(marks[1:])
    return {"model": "resnet56", "params": cfg.num_params(),
            "batch": [RESNET_BATCH, cfg.image_size, cfg.image_size, 3],
            "steps": RESNET_STEPS, "dtype": "bfloat16", "loss": losses,
            "step_ms": step_ms, "step_ms_all": marks,
            "first_step_ms": marks[0],
            "images_per_s": RESNET_BATCH / step_ms * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wall_s": time.perf_counter() - t0}


# -- the offload and Infinity slice -------------------------------------------

#: train_infinity: Llama-3-70B widths, 3 of its 80 layers (more than the
#: trunk's two device buffers), [2, 2048], 2 steps
INF_LAYERS, INF_BATCH, INF_STEPS = 3, 2, 2
#: the trunk's two device buffers at 70B widths: 2 x 855,654,400 x 2 B
INF_PEAK_PARAM_BYTES = 3_422_617_600
#: train_infinity_nvme: Llama-3-8B widths at 3 layers, a ring of 2 slots
#: (so it still evicts), gas 2 with clipping (the stash path), 2 steps on
#: each tier
NVME_LAYERS, NVME_STEPS, NVME_GAS, NVME_SLOTS = 3, 2, 2, 2
#: train_infinity_agree: Llama-3-8B widths at 2 layers, fp32, 2 steps (the
#: script's length)
INF_AGREE_LAYERS, INF_AGREE_STEPS, INF_AGREE_RTOL = 2, 2, 2e-4
#: train_offload: Llama-3-8B widths at WIDE_LAYERS, 3 steps
OFFLOAD_STEPS = 3
INF_NOTE = ("host-bound by design: the trunk's layers cross PCIe each "
            "pass and the C++ Adam runs on the host")


def meminfo() -> dict:
    """The host's ``MemTotal`` and ``MemAvailable`` in bytes."""
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, rest = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(rest.split()[0]) * 1024
    return out


def host_cache_emptier():
    """PyTorch's call that returns cached pinned host blocks to the OS, or
    None where this build has none."""
    return (getattr(torch.cuda.memory, "empty_host_cache", None)
            or getattr(torch._C, "_host_emptyCache", None))


def free_host_cache() -> None:
    """Return an earlier phase's cached blocks, on the card and pinned on
    the host."""
    gc.collect()
    torch.cuda.empty_cache()
    empty = host_cache_emptier()
    if empty is not None:
        empty()


def layer_params(cfg) -> int:
    """One decoder layer's parameters."""
    H, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.hd
    return (H * cfg.num_heads * hd * 2 + 2 * H * cfg.num_kv_heads * hd
            + 3 * H * I + 2 * H)


def infinity_host_need(cfg, layers: int) -> int:
    """Host bytes the cpu tier needs at ``layers``: every layer's planes
    (bf16 wire, fp32 master, m, v: 14 B an element), one layer's source
    while it is filled, the fp32 resident leaves before they move to the
    card, the pinned gradient staging (2 layers of bf16) and the worker's
    fp32 gradient plane."""
    n = layer_params(cfg)
    resident = cfg.num_params() - cfg.num_layers * n
    return layers * 14 * n + 4 * n + 4 * resident + 2 * 2 * n + 4 * n


def infinity_config(micro: int, dtype=torch.bfloat16, gas: int = 1,
                    clip: float = 0.0, nvme_path: Optional[str] = None,
                    buffer_count: int = 4, pipelined: bool = True) -> dict:
    """ZeRO-3 with ``offload_param`` (cpu, or nvme under ``nvme_path``) and
    ``offload_optimizer`` cpu; AdamW lr 1e-4, as ``ds_config``."""
    param = ({"device": "nvme", "nvme_path": nvme_path,
              "buffer_count": buffer_count} if nvme_path else
             {"device": "cpu", "buffer_count": buffer_count})
    opt = {"device": "cpu"}
    if not pipelined:
        opt.update(pipeline_read=False, pipeline_write=False)
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas, "gradient_clipping": clip,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "bf16": {"enabled": dtype == torch.bfloat16},
            "steps_per_print": 0,
            "zero_optimization": {"stage": 3, "offload_param": param,
                                  "offload_optimizer": opt}}


def stream_model(cfg, seed: int, dev):
    """A model whose parameters live in host memory, drawn with the card's
    generator (the weights of ``LlamaModel(cfg, device=dev, seed=seed)``)."""
    from deepspeed_tpu_torch import LlamaModel
    return LlamaModel(cfg, device="cpu", seed=seed, init_device=dev)


def streamed_steps(engine, ids, steps: int) -> dict:
    """``steps`` streamed steps on one batch; each step's host-clock time
    (``train_step`` ends with a device synchronize) and its swapper byte
    counts."""
    sw = engine.infinity.swapper
    out = {k: [] for k in ("loss", "grad_norm", "step_s")}
    io = []
    for _ in range(steps):
        before = dict(sw.io_bytes)
        t0 = time.perf_counter()
        m = engine.train_step({"input_ids": ids})
        out["step_s"].append(time.perf_counter() - t0)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        io.append({k: sw.io_bytes[k] - before[k] for k in before})
    out["io_bytes_per_step"] = io[-1]
    return out


def state_copy(engine) -> list:
    """Host copies of the resident leaves and every layer's fp32 masters."""
    sw = engine.infinity.swapper
    return [p.detach().cpu() for p in engine.params] + [
        t for i in range(sw.L) for t in sw.layer_master_tree(i).values()]


def same_state(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def require_stream_launches(what: str, launches: dict, layers: int,
                            steps: int, gas: int = 1) -> dict:
    """Per microbatch each layer's forward twice (streamed, then again in
    the backward) and its backward once; no other training kernel."""
    want = {k: 0 for k in TRAIN_KERNELS}
    want.update(flash_fwd=2 * layers * gas * steps,
                flash_bwd_dq=layers * gas * steps,
                flash_bwd_dkv=layers * gas * steps)
    require(launches == want, f"{what}: launches {launches}, want {want}")
    return want


def device_idle_share(step) -> dict:
    """One call of ``step`` under ``torch.profiler`` (device events only):
    the device's busy time and its idle share over the call's host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    require(events, "the profiler recorded no device events")
    busy, end = 0.0, -np.inf
    for a, b in events:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"host_s": wall, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e6 / wall,
            "device_events": len(events)}


def phase_train_infinity(dev, seed: int) -> dict:
    """train_infinity: ZeRO-Infinity through ``initialize`` at Llama-3-70B
    widths, the trunk in the cpu tier: finite falling losses, the trunk's
    device buffers exactly ``INF_PEAK_PARAM_BYTES``, no trunk parameter on
    the card, the peak allocation under the resident state plus the
    activations and under 80 GB, the flash launches of the formula; the
    step on the host clock, the device's idle share in one profiled step,
    host memory and threads."""
    from deepspeed_tpu_torch import LlamaConfig, initialize
    from deepspeed_tpu_torch.ops.adam.cpu_adam import num_threads

    free_host_cache()
    full = LlamaConfig.llama3_70b()
    mem0 = meminfo()
    layers = INF_LAYERS
    need = infinity_host_need(full, layers)
    require(need <= 0.9 * mem0["MemAvailable"],
            f"train_infinity: {layers} layers need {need} B of host memory, "
            f"{mem0['MemAvailable']} B available")
    cfg = LlamaConfig.llama3_70b(num_layers=layers, dtype=torch.bfloat16,
                                 param_dtype=torch.float32, attn_impl="flash")
    t0 = time.perf_counter()
    model = stream_model(cfg, seed, dev)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = initialize(model=model, config=infinity_config(INF_BATCH),
                            device=dev)
    setup_s = time.perf_counter() - t0
    inf = engine.infinity
    sw = inf.swapper
    n_layer = sw.n_elems
    require(n_layer == layer_params(cfg), "train_infinity: layer plane size")
    buf_bytes = sum(b.numel() * b.element_size() for b in sw._dev)
    require(buf_bytes == inf.peak_device_param_bytes()
            == INF_PEAK_PARAM_BYTES,
            f"train_infinity: trunk device buffers {buf_bytes} B, want "
            f"{INF_PEAK_PARAM_BYTES}")
    on_card = [n for n, p in model.layers.named_parameters()
               if p.device.type != "cpu"]
    require(not on_card, f"train_infinity: trunk leaves on the card: "
                         f"{on_card[:3]}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (INF_BATCH, TRAIN_SEQ),
                        generator=gen, device=dev)
    mem1 = meminfo()
    reset_counts()
    run = streamed_steps(engine, ids, INF_STEPS)
    launches = train_launches()
    want = require_stream_launches("train_infinity", launches, layers,
                                   INF_STEPS)
    losses = run["loss"]
    require(all(np.isfinite(losses)), f"train_infinity: loss {losses}")
    require(losses[-1] < losses[0], f"train_infinity: loss did not fall: "
                                    f"{losses}")
    peak = torch.cuda.max_memory_allocated()
    resident = inf.resident_param_count()
    H, I, S, B = cfg.hidden_size, cfg.intermediate_size, TRAIN_SEQ, INF_BATCH
    # the resident leaves' fp32 master, gradient, m and v; the two layer
    # buffers; the layers' inputs; one layer's recompute and backward
    # (q, k, v repeated to 64 heads, attention out, three [B, S, I] FFN
    # tensors and their gradients, bf16, four-fold); the logits' fp32
    # log-softmax and its gradient (four [B, S, V] fp32)
    budget = (16 * resident + INF_PEAK_PARAM_BYTES + layers * B * S * H * 2
              + 4 * B * S * (6 * cfg.num_heads * cfg.hd + 3 * I) * 2 * 2
              + 4 * B * S * cfg.vocab_size * 4)
    require(peak < budget and peak < 80e9,
            f"train_infinity: peak {peak} B over the budget {budget} B "
            f"(resident state, trunk buffers, activations) or 80 GB")
    step_s = statistics.median(run["step_s"][1:])
    trace = device_idle_share(lambda: engine.train_step({"input_ids": ids}))
    tokens = B * S
    flops = (6 * cfg.num_params() + 12 * layers * S * H) * tokens
    mem2 = meminfo()
    out = dict(
        layers=layers, batch=[B, S], steps=INF_STEPS, dtype="bfloat16",
        attn_impl=cfg.attn_impl, tier="cpu", pipelined=sw._pipe is not None,
        loss=losses, grad_norm=run["grad_norm"], step_s=run["step_s"],
        step_s_median=step_s, tokens_per_s=tokens / step_s,
        mfu=flops / step_s / PEAK_BF16,
        trunk_params_off_device=n_layer * layers,
        layer_params=n_layer, resident_params=resident,
        total_params=inf.total_param_count(),
        peak_device_param_bytes=buf_bytes,
        max_memory_allocated=peak, memory_budget=budget,
        host_plane_bytes=sw.host_plane_bytes(),
        host_need_predicted=need, mem_available_before=mem0["MemAvailable"],
        mem_available_after_setup=mem1["MemAvailable"],
        mem_available_after=mem2["MemAvailable"],
        mem_total=mem0["MemTotal"], model_init_s=init_s,
        initialize_s=setup_s, io_bytes_per_step=run["io_bytes_per_step"],
        last_step_split_s=inf.last_timings, profiled_step=trace,
        threads={"torch_intra_op": torch.get_num_threads(),
                 "cpu_adam_openmp": num_threads(),
                 "host_cores": __import__("os").cpu_count()},
        launches=launches, launches_want=want, card=nvidia_smi_line(),
        host_cache_emptier=host_cache_emptier() is not None, note=INF_NOTE)
    del engine, inf, sw, model
    free_host_cache()
    return out


def infinity_rank(rank: int, seed: int) -> dict:
    """train_infinity in a process of its own: the cpu tier's planes take
    most of the host's memory, and a fresh heap holds nothing of the
    earlier phases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return phase_train_infinity(dev, seed)


def phase_train_infinity_nvme(dev, seed: int) -> dict:
    """train_infinity_nvme: Llama-3-8B widths at ``NVME_LAYERS`` on the
    cpu tier, then the same on the nvme tier (files under
    ``build/nvme_smoke``, a ring of ``NVME_SLOTS`` host slots, so it
    evicts), gas 2 with clipping (the stash path): the losses, grad norms
    and the final state equal bit for bit; disk bytes a step, their rate
    and the O_DIRECT / buffered split."""
    import os
    import shutil

    from deepspeed_tpu_torch import LlamaConfig, initialize

    free_host_cache()
    cfg = LlamaConfig.llama3_8b(num_layers=NVME_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32, attn_impl="flash")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "nvme_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    need = NVME_LAYERS * 14 * layer_params(cfg)
    disk = shutil.disk_usage(root).free
    require(disk > 1.2 * need, f"train_infinity_nvme: {disk} B free on the "
                               f"disk, the planes need {need}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (NVME_GAS, TRAIN_SEQ),
                        generator=gen, device=dev)
    runs, ref = {}, None
    try:
        for tier in ("cpu", "nvme"):
            model = stream_model(cfg, seed, dev)
            t0 = time.perf_counter()
            engine, *_ = initialize(model=model, device=dev, config=(
                infinity_config(1, gas=NVME_GAS, clip=1.0,
                                nvme_path=os.path.join(root, "planes")
                                if tier == "nvme" else None,
                                buffer_count=NVME_SLOTS)))
            setup_s = time.perf_counter() - t0
            sw = engine.infinity.swapper
            aio0 = sw.aio_stats()
            reset_counts()
            run = streamed_steps(engine, ids, NVME_STEPS)
            launches = train_launches()
            require_stream_launches(f"train_infinity_nvme {tier}", launches,
                                    NVME_LAYERS, NVME_STEPS, NVME_GAS)
            aio = sw.aio_stats()
            io = run["io_bytes_per_step"]
            step_s = statistics.median(run["step_s"][1:])
            state = state_copy(engine)
            if ref is None:
                ref = state
            runs[tier] = dict(
                loss=run["loss"], grad_norm=run["grad_norm"],
                step_s=run["step_s"], initialize_s=setup_s,
                state_equal_to_cpu_tier=same_state(state, ref),
                launches=launches,
                io_bytes_per_step=io,
                disk_gb_read_per_step=io["disk_read"] / 1e9,
                disk_gb_written_per_step=io["disk_write"] / 1e9,
                disk_gb_per_s=(io["disk_read"] + io["disk_write"])
                / step_s / 1e9,
                aio_direct_bytes=aio.get("direct_bytes", 0)
                - aio0.get("direct_bytes", 0),
                aio_buffered_bytes=aio.get("buffered_bytes", 0)
                - aio0.get("buffered_bytes", 0),
                host_plane_bytes=sw.host_plane_bytes(),
                buffer_count=sw.buffer_count)
            del engine, sw, model, state
            free_host_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nv, cpu = runs["nvme"], runs["cpu"]
    for key in ("loss", "grad_norm"):
        require(nv[key] == cpu[key], f"train_infinity_nvme: the nvme tier's "
                                     f"{key} {nv[key]} != the cpu tier's "
                                     f"{cpu[key]}")
    require(nv["state_equal_to_cpu_tier"], "train_infinity_nvme: the nvme "
                                           "tier's masters differ")
    require(all(np.isfinite(nv["loss"])), f"train_infinity_nvme: {nv}")
    require(nv["aio_direct_bytes"] + nv["aio_buffered_bytes"] > 0,
            "train_infinity_nvme: the AIO engine moved nothing")
    return dict(layers=NVME_LAYERS, gas=NVME_GAS, clip=1.0,
                batch=[NVME_GAS, TRAIN_SEQ], steps=NVME_STEPS,
                dtype="bfloat16", path="stash", tiers_bit_equal=True,
                disk_free_bytes=disk, planes_on_disk_bytes=need, **runs)


def phase_train_infinity_agree(dev, seed: int) -> dict:
    """train_infinity_agree: Llama-3-8B widths at ``INF_AGREE_LAYERS`` in
    fp32 on one ``[1, 2048]`` batch: the streamed engine (cpu tier, fused
    path) gives the on-device ZeRO-0 engine's losses and grad norms within
    ``INF_AGREE_RTOL``, and its pipelined host optimizer the serial one's
    bit for bit."""
    from deepspeed_tpu_torch import LlamaConfig, LlamaModel, initialize

    free_host_cache()
    cfg = LlamaConfig.llama3_8b(num_layers=INF_AGREE_LAYERS,
                                dtype=torch.float32,
                                param_dtype=torch.float32, attn_impl="flash")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), generator=gen,
                        device=dev)
    runs, ref = {}, None
    for label, pipelined in (("pipelined", True), ("serial", False)):
        engine, *_ = initialize(model=stream_model(cfg, seed, dev),
                                config=infinity_config(
                                    1, torch.float32, pipelined=pipelined),
                                device=dev)
        require((engine.infinity.swapper._pipe is not None) == pipelined,
                f"train_infinity_agree: pipeline={pipelined} not taken")
        run = streamed_steps(engine, ids, INF_AGREE_STEPS)
        state = state_copy(engine)
        ref = state if ref is None else ref
        runs[label] = dict(loss=run["loss"], grad_norm=run["grad_norm"],
                           step_s=run["step_s"],
                           state_equal_to_pipelined=same_state(state, ref))
        del engine, state
        free_host_cache()
    del ref
    model = LlamaModel(cfg, device=dev, seed=seed)
    engine, *_ = initialize(model=model, device=dev,
                            config=ds_config(model, 1))
    metrics = [engine.train_step({"input_ids": ids})
               for _ in range(INF_AGREE_STEPS)]
    dev_run = dict(loss=[float(m["loss"]) for m in metrics],
                   grad_norm=[float(m["grad_norm"]) for m in metrics])
    del engine, model
    free_host_cache()
    p, s = runs["pipelined"], runs["serial"]
    for key in ("loss", "grad_norm", "state_equal_to_pipelined"):
        require(p[key] == s[key], f"train_infinity_agree: pipelined {key} "
                                  f"{p[key]} != serial {s[key]}")
    rel = {k: _max_rel(p[k], dev_run[k]) for k in ("loss", "grad_norm")}
    for k, r in rel.items():
        require(r <= INF_AGREE_RTOL,
                f"train_infinity_agree: streamed {k} {p[k]} vs on-device "
                f"{dev_run[k]}: rel {r} > {INF_AGREE_RTOL}")
    return dict(layers=INF_AGREE_LAYERS, dtype="float32",
                batch=[1, TRAIN_SEQ], steps=INF_AGREE_STEPS,
                pipelined_equals_serial=True, rel_to_on_device=rel,
                tolerance=INF_AGREE_RTOL, on_device=dev_run, **runs)


def phase_train_offload(dev, seed: int, wide_peak_gb: float) -> dict:
    """train_offload: ZeRO-Offload at Llama-3-8B widths (``WIDE_LAYERS``),
    bf16 wire, flash, AdamW, ZeRO 0: finite falling losses; the card's
    parameters bf16 and no optimizer tensor on the card; host state 12 B a
    parameter; the peak allocation below ``train_8b_width``'s (printed
    beside it); each step split into the gradient program, the waits for
    the gradients' copies, the host Adam and the copies back."""
    from deepspeed_tpu_torch import LlamaConfig, LlamaModel, initialize
    from deepspeed_tpu_torch.ops.adam.cpu_adam import num_threads

    free_host_cache()
    cfg = LlamaConfig.llama3_8b(num_layers=WIDE_LAYERS, dtype=torch.bfloat16,
                                param_dtype=torch.float32, attn_impl="flash")
    model = LlamaModel(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conf = ds_config(model, WIDE_BATCH)
    conf["zero_optimization"] = {"stage": 0,
                                 "offload_optimizer": {"device": "cpu"}}
    engine, *_ = initialize(model=model, config=conf, device=dev)
    opt = engine.offload_opt
    require({p.dtype for p in engine.params} == {torch.bfloat16},
            "train_offload: the card's parameters are not bf16")
    host = [t for t in opt.masters + opt.opt.exp_avg + opt.opt.exp_avg_sq
            if t.device.type != "cpu"]
    require(not host, "train_offload: optimizer state on the card")
    n = cfg.num_params()
    require(opt.state_bytes == 12 * n,
            f"train_offload: host state {opt.state_bytes} B, want 12 x {n}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (WIDE_BATCH, TRAIN_SEQ),
                        generator=gen, device=dev)
    reset_counts()
    losses, split = [], []
    for _ in range(OFFLOAD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = engine.train_step({"input_ids": ids})
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        losses.append(float(m["loss"]))
        t = dict(opt.last_timings)
        split.append({"step_s": total,
                      "grad_program_s": total - t["step_s"],
                      "d2h_wait_s": t["d2h_wait_s"],
                      "host_adam_s": t["host_opt_s"], "h2d_s": t["h2d_s"]})
    launches = train_launches()
    require_train_launches("train_offload", dict(
        layers=WIDE_LAYERS, steps=OFFLOAD_STEPS, remat=cfg.remat,
        fused_adam=False, launches=launches))
    require(all(np.isfinite(losses)), f"train_offload: loss {losses}")
    require(losses[-1] < losses[0], f"train_offload: loss did not fall: "
                                    f"{losses}")
    peak = torch.cuda.max_memory_allocated()
    require(peak / 1e9 < wide_peak_gb,
            f"train_offload: peak {peak / 1e9:.2f} GB not below "
            f"train_8b_width's {wide_peak_gb:.2f} GB")
    out = dict(layers=WIDE_LAYERS, batch=[WIDE_BATCH, TRAIN_SEQ],
               steps=OFFLOAD_STEPS, dtype="bfloat16 (wire)", zero_stage=0,
               loss=losses, step_split=split,
               step_s_median=statistics.median(s["step_s"]
                                               for s in split[1:]),
               params=n, host_state_bytes=opt.state_bytes,
               host_staging_bytes=opt.staging_bytes,
               peak_mem_gb=peak / 1e9, train_8b_width_peak_mem_gb=wide_peak_gb,
               threads={"torch_intra_op": torch.get_num_threads(),
                        "cpu_adam_openmp": num_threads()},
               launches=launches)
    del engine, model, opt
    free_host_cache()
    return out


def predicted_offload_bytes(shapes: list, dp: int) -> int:
    """A rank's host state under ZeRO-Offload at stages 1-3: fp32 master,
    m and v (12 B an element) of each cut leaf's chunk and of each whole
    leaf (the placement rule)."""
    from deepspeed_tpu_torch.runtime.config import ZeroConfig
    from deepspeed_tpu_torch.runtime.zero import ZeroShardingPolicy

    policy = ZeroShardingPolicy.from_config(ZeroConfig(stage=2), dp)
    return 12 * sum(int(np.prod(s)) // (1 if policy.shard_dim(tuple(s))
                                        is None else dp) for s in shapes)



# -- the sequence-parallel slice ------------------------------------------------

#: train_sp: Llama-3-8B widths at SP_LAYERS of its 32 layers on SP ranks of
#: card 0 over gloo, one [1, SP_SEQ] batch (the model's published context:
#: 4096 tokens a rank), bf16 on fp32 masters, flash, remat, the loss in
#: SP_TILES tiles (a tile's fp32 logits 0.26 GB, a rank's 4096 tokens whole
#: 2.1 GB), SP_STEPS steps
SP, SP_LAYERS, SP_SEQ, SP_STEPS, SP_TILES = 2, 2, 8192, 2, 8
#: all-to-alls a layer a step on the Ulysses route: q, k, v and the output
#: forward, the same four again in the remat recompute, four in the backward
SP_A2A_PER_LAYER_STEP = 12
SP_TIMEOUT = 900
SP_NOTE = "gloo through the host, two ranks on one card: not an SP speed"
#: train_sp's fp32 agreements at AGREE_TRAIN's widths (4 heads: Ulysses at
#: sp 2), one [2, SP_AGREE_SEQ] batch, SP_AGREE_STEPS steps: name ->
#: (attn_impl, loss_tiles, the run it is held against, relative tolerance
#: of the losses, of the grad norms); "one_process" is the sp-1 run on the
#: card in this process.  The tiled loss sums the same terms in another
#: order: its losses hold to 1e-6, its grad norms (through two Adam
#: updates of last-bit differences) to Ulysses' 1e-5
SP_AGREE_SEQ, SP_AGREE_STEPS = 256, 3
SP_AGREE_RUNS = {"ulysses": ("flash", 1, "one_process", (1e-5, 1e-5)),
                 "ring": ("ring", 1, "one_process", (1e-4, 1e-4)),
                 "ulysses_tiles4": ("flash", 4, "ulysses", (1e-6, 1e-5))}
#: the bf16 bounds of tests/test_torch_train.py (loss, grad norm), for sp 2
#: against one process
SP_BF16_RTOL = (2e-2, 5e-2)


def sp_model_config(**kw):
    from deepspeed_tpu_torch import LlamaConfig
    return LlamaConfig.llama3_8b(num_layers=SP_LAYERS, dtype=torch.bfloat16,
                                 param_dtype=torch.float32,
                                 attn_impl="flash", loss_tiles=SP_TILES, **kw)


def sp_agree_config(attn: str, tiles: int):
    from deepspeed_tpu_torch import LlamaConfig
    return LlamaConfig(**dict(AGREE_TRAIN, attn_impl=attn), loss_tiles=tiles)


def sp_steps(engine, ids, steps: int) -> dict:
    """``steps`` train steps on one batch (``ids``, or a batch dict):
    losses, grad norms, host-clock step times (each ends in a
    synchronize), the training kernels' and the all-to-all's counts from 0
    around them."""
    from deepspeed_tpu_torch import comm

    batch = ids if isinstance(ids, dict) else {"input_ids": ids}
    reset_counts()
    comm.all_to_all_in_graph.calls = 0
    out = {"loss": [], "grad_norm": [], "host_step_ms": []}
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = engine.train_step(batch)
        torch.cuda.synchronize()
        out["host_step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["launches"] = train_launches()
    out["all_to_all"] = comm.all_to_all_in_graph.calls
    return out


def sp_ids(seed: int, vocab: int, dev) -> torch.Tensor:
    """train_sp's one whole row, the same on every rank."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    return torch.randint(0, vocab, (1, SP_SEQ), generator=gen, device=dev)


def sp_agree_ids(seed: int, dev) -> torch.Tensor:
    return zero_batch(seed + 6, AGREE_TRAIN["vocab_size"], 2, dev)[
        :, :SP_AGREE_SEQ]


def sp_agree_run(cfg, seed: int, dev, sp: int) -> dict:
    """The fp32 agreement model (rank 0's weights: seed + 4) through
    ``initialize`` at ``sp``, ``SP_AGREE_STEPS`` steps on one batch."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    model = LlamaModel(cfg, device=dev, seed=seed + 4)
    engine, *_ = initialize(model=model, config=dict(
        ds_config(model, 2), sequence_parallel={"sp_size": sp},
        optimizer={"type": "AdamW", "params": {"lr": 1e-3}}), device=dev)
    out = sp_steps(engine, sp_agree_ids(seed, dev), SP_AGREE_STEPS)
    del model, engine
    return out


def sp_train_rank(rank: int, seed: int) -> dict:
    """One rank of train_sp: the 8B-width model through ``initialize``
    with ``sequence_parallel.sp_size`` SP on the whole ``[1, SP_SEQ]`` row
    (its 4096-token chunk from the embedding to the loss), then the fp32
    agreement runs at sp 2."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    dev = zero_rank_setup()
    cfg = sp_model_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device=dev, seed=seed + rank)
    engine, *_ = initialize(model=model, config=dict(
        ds_config(model, 1), sequence_parallel={"sp_size": SP}), device=dev)
    setup_s = time.perf_counter() - t0
    ids = sp_ids(seed, cfg.vocab_size, dev)
    out = {"train": dict(sp_steps(engine, ids, SP_STEPS),
                         setup_s=setup_s, sp_rank=engine.sp_rank,
                         state_bytes=zero_state_bytes(engine),
                         peak_mem_bytes=torch.cuda.max_memory_allocated())}
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    for label, (attn, tiles, _, _) in SP_AGREE_RUNS.items():
        out[label] = sp_agree_run(sp_agree_config(attn, tiles), seed, dev,
                                  SP)
    out["infinity"] = sp_infinity_run(seed, dev, rank)
    out["infinity_agree"] = sp_infinity_agree_run(seed, dev)
    return out


def sp_infinity_run(seed: int, dev, rank: int) -> dict:
    """train_infinity_sp on one rank: train_sp's model (drawn in host
    memory with the card's generator: rank 0's weights are train_sp's) and
    row through ``initialize`` with ``offload_param`` (cpu tier, fused
    path) at sp ``SP``; the steps' metrics, launches, all-to-alls, byte
    counts and peak memory."""
    from deepspeed_tpu_torch import comm, initialize

    free_host_cache()
    cfg = sp_model_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = stream_model(cfg, seed + rank, dev)
    engine, *_ = initialize(model=model, config=dict(
        infinity_config(1), sequence_parallel={"sp_size": SP}), device=dev)
    setup_s = time.perf_counter() - t0
    inf = engine.infinity
    sw = inf.swapper
    ids = sp_ids(seed, cfg.vocab_size, dev)
    reset_counts()
    comm.all_to_all_in_graph.calls = 0
    run = streamed_steps(engine, ids, SP_STEPS)
    out = dict(run, launches=train_launches(),
               all_to_all=comm.all_to_all_in_graph.calls,
               last_step_split_s=inf.last_timings, setup_s=setup_s,
               sp_rank=engine.sp_rank, n_elems=sw.n_elems, n_pad=sw.n_pad,
               n_plane=sw.n_plane, segments=sw.segments,
               device_buffer_bytes=sum(b.numel() * b.element_size()
                                       for b in sw._dev),
               peak_device_param_bytes=inf.peak_device_param_bytes(),
               host_plane_bytes=sw.host_plane_bytes(),
               resident_params=inf.resident_param_count(),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    del model, engine, inf, sw
    free_host_cache()
    return out


def sp_infinity_agree_run(seed: int, dev) -> dict:
    """train_infinity_sp_agree on one rank: the fp32 Ulysses agreement
    model and batch of ``SP_AGREE_RUNS['ulysses']`` streamed from the cpu
    tier at sp ``SP``."""
    from deepspeed_tpu_torch import initialize

    cfg = sp_agree_config("flash", 1)
    engine, *_ = initialize(model=stream_model(cfg, seed + 4, dev),
                            config=dict(
        infinity_config(2, torch.float32), sequence_parallel={
            "sp_size": SP}, optimizer={"type": "AdamW",
                                       "params": {"lr": 1e-3}}), device=dev)
    out = sp_steps(engine, sp_agree_ids(seed, dev), SP_AGREE_STEPS)
    del engine
    free_host_cache()
    return out



def require_sp_launches(what: str, run: dict, attn: str, layers: int,
                        steps: int, sp: int) -> None:
    """The flash launches of the formula (none on the ring) and, on the
    Ulysses route at sp above 1, ``SP_A2A_PER_LAYER_STEP`` all-to-alls a
    layer a step (none otherwise)."""
    require_train_launches(what, dict(
        layers=layers if attn == "flash" else 0, steps=steps, remat=True,
        fused_adam=False, launches=run["launches"]))
    want = (steps * layers * SP_A2A_PER_LAYER_STEP
            if attn == "flash" and sp > 1 else 0)
    require(run["all_to_all"] == want, f"{what}: {run['all_to_all']} "
                                       f"all-to-alls, want {want}")


def sp_tp_launch(dev, seed: int) -> dict:
    """The launch train_sp and train_tp share (``SP`` = ``TP`` ranks on
    card 0 over gloo): each rank runs :func:`sp_train_rank`, then
    :func:`tp_train_rank`, then :func:`seq_models_rank`; the one-process
    runs they are held against here first (train_bert_tp's BERT, which
    train_bert_sp shares, OPT's and the seq agreement models')."""
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build()  # here, so the ranks do not both run nvcc
    one_bert = tp_bert_run(seed, dev)
    one_opt = seq_model_run("opt", seed, dev, 1)
    one_agree = {kind: seq_model_run(kind, seed, dev, 1, agree=True)
                 for kind in SEQ_AGREE_KINDS}
    free_host_cache()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(shared_rank, SP, ([("sp", sp_train_rank, (seed,)),
                                      ("tp", tp_train_rank, (seed,)),
                                      ("seq_models", seq_models_rank,
                                       (seed,))],),
                   timeout=SP_TIMEOUT + TP_TIMEOUT)
    return {"ranks": ranks, "wall": time.perf_counter() - t0,
            "one_bert": one_bert, "one_opt": one_opt,
            "one_agree": one_agree}


def phase_train_sp(dev, seed: int) -> dict:
    """train_sp: ``SP`` ranks on card 0 over gloo (the launch it shares
    with train_tp, :func:`sp_tp_launch`) train the
    8B-width model at sp 2: finite, falling losses equal on both ranks;
    per rank and step 2 L flash forwards (remat), L dq and L dk/dv passes
    at the Ulysses shape (B 1, the full S on h/sp heads) and
    ``SP_A2A_PER_LAYER_STEP`` L all-to-alls; then one process trains the
    same model, weights and row at sp 1 on the card: the losses and grad
    norms within ``SP_BF16_RTOL``.  The fp32 agreements of the same launch
    (``SP_AGREE_RUNS``) against the sp-1 run in this process, or the
    Ulysses run."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    got = shared_launch("sp_tp", lambda: sp_tp_launch(dev, seed))
    ranks, wall = [r["sp"] for r in got["ranks"]], got["wall"]
    L = SP_LAYERS
    base = ranks[0]["train"]
    for r, res in enumerate(ranks):
        t = res["train"]
        require(all(np.isfinite(t["loss"])),
                f"train_sp rank {r}: non-finite loss {t['loss']}")
        require(t["loss"][-1] < t["loss"][0],
                f"train_sp rank {r}: loss did not fall: {t['loss']}")
        require(t["loss"] == base["loss"] and
                t["grad_norm"] == base["grad_norm"],
                f"train_sp: rank {r}'s losses {t['loss']} / grad norms "
                f"{t['grad_norm']} != rank 0's")
        require_sp_launches(f"train_sp rank {r}", t, "flash", L, SP_STEPS,
                            SP)
    free_host_cache()
    cfg = sp_model_config()
    model = LlamaModel(cfg, device=dev, seed=seed)  # rank 0's weights
    engine, *_ = initialize(model=model, config=ds_config(model, 1),
                            device=dev)
    torch.cuda.reset_peak_memory_stats()
    one = sp_steps(engine, sp_ids(seed, cfg.vocab_size, dev), SP_STEPS)
    one["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    require_sp_launches("train_sp one process", one, "flash", L, SP_STEPS, 1)
    del model, engine
    free_host_cache()
    rel = {}
    for what, tol in zip(("loss", "grad_norm"), SP_BF16_RTOL):
        rel[what] = _max_rel(base[what], one[what])
        require(rel[what] <= tol, f"train_sp: sp {SP}'s {what} "
                                  f"{base[what]} != one process's "
                                  f"{one[what]} (rel {rel[what]} > {tol})")
    agree = {"one_process": sp_agree_run(sp_agree_config("flash", 1), seed,
                                         dev, 1)}
    require_sp_launches("train_sp_agree one_process", agree["one_process"],
                        "flash", AGREE_TRAIN["num_layers"], SP_AGREE_STEPS,
                        1)
    agree_rel = {}
    for label, (attn, tiles, against, tols) in SP_AGREE_RUNS.items():
        agree[label] = run = ranks[0][label]
        require(all(r[label]["loss"] == run["loss"] for r in ranks),
                f"train_sp_agree {label}: the ranks' losses differ")
        require_sp_launches(f"train_sp_agree {label}", run, attn,
                            AGREE_TRAIN["num_layers"], SP_AGREE_STEPS, SP)
        for what, tol in zip(("loss", "grad_norm"), tols):
            agree_rel[f"{label}_{what}"] = e = _max_rel(
                run[what], agree[against][what])
            require(e <= tol, f"train_sp_agree {label}: {what} "
                              f"{run[what]} != {against}'s "
                              f"{agree[against][what]} (rel {e} > {tol})")
    inf = check_infinity_sp(ranks, base, cfg)
    tokens = SP_SEQ
    step_ms = statistics.median(base["host_step_ms"][1:])
    return {"infinity": inf["train"], "infinity_agree": inf["agree"],
            "train": dict(
        layers=L, sp=SP, batch=[1, SP_SEQ], tokens_per_rank=SP_SEQ // SP,
        steps=SP_STEPS, dtype="bfloat16", attn_impl="flash",
        loss_tiles=SP_TILES, remat=True, params=cfg.num_params(),
        heads_per_rank=cfg.num_heads // SP,
        ranks=[r["train"] for r in ranks], one_process=one,
        rel_to_one_process=rel, tolerance=dict(zip(("loss", "grad_norm"),
                                                   SP_BF16_RTOL)),
        all_to_all_formula=f"{SP_A2A_PER_LAYER_STEP} x layers x steps",
        host_step_ms=step_ms, tokens_per_s_host=tokens / step_ms * 1e3,
        launch_wall_s=wall),
        "agree": dict(
            model=dict((k, v) for k, v in AGREE_TRAIN.items()
                       if k not in ("dtype", "param_dtype")),
            batch=[2, SP_AGREE_SEQ], steps=SP_AGREE_STEPS, sp=SP,
            runs=agree, max_rel=agree_rel,
            tolerance={label: {"against": against, "loss": tols[0],
                               "grad_norm": tols[1]}
                       for label, (_, _, against, tols)
                       in SP_AGREE_RUNS.items()})}


def check_infinity_sp(ranks: list, on_device: dict, cfg) -> dict:
    """train_infinity_sp and its agreement, from train_sp's launch: the
    ranks bit-equal, the launches and all-to-alls of the formula, the
    trunk's device buffers and host planes to the byte, the losses and
    grad norms within ``SP_BF16_RTOL`` of train_sp's on-device sp-2 run
    (``on_device``, rank 0's), and the fp32 streamed run within
    ``INF_AGREE_RTOL`` of train_sp_agree's Ulysses run."""
    L = SP_LAYERS
    n = layer_params(cfg)
    n_pad = -(-n // SP) * SP
    base = ranks[0]["infinity"]
    for r, res in enumerate(ranks):
        t = res["infinity"]
        require(all(np.isfinite(t["loss"])) and t["loss"][-1] < t["loss"][0],
                f"train_infinity_sp rank {r}: losses {t['loss']}")
        require(t["loss"] == base["loss"] and
                t["grad_norm"] == base["grad_norm"],
                f"train_infinity_sp: rank {r}'s losses {t['loss']} / grad "
                f"norms {t['grad_norm']} != rank 0's")
        require_stream_launches(f"train_infinity_sp rank {r}",
                                t["launches"], L, SP_STEPS)
        want = SP_STEPS * L * SP_A2A_PER_LAYER_STEP
        require(t["all_to_all"] == want, f"train_infinity_sp rank {r}: "
                                         f"{t['all_to_all']} all-to-alls, "
                                         f"want {want}")
        require(t["n_elems"] == n and t["n_pad"] == n_pad and
                t["n_plane"] * SP == n_pad and
                t["device_buffer_bytes"] == t["peak_device_param_bytes"]
                == 2 * n_pad * 2,
                f"train_infinity_sp rank {r}: planes {t['n_plane']} of "
                f"{t['n_pad']} (layer {t['n_elems']}), device buffers "
                f"{t['device_buffer_bytes']} B, want {2 * n_pad * 2}")
        # bf16 wire, fp32 master, m and v: half of one process's L x n x 14
        require(t["host_plane_bytes"] == L * n_pad // SP * 14,
                f"train_infinity_sp rank {r}: host planes "
                f"{t['host_plane_bytes']} B, want {L * n_pad // SP * 14}")
    rel = {}
    for what, tol in zip(("loss", "grad_norm"), SP_BF16_RTOL):
        rel[what] = e = _max_rel(base[what], on_device[what])
        require(e <= tol, f"train_infinity_sp: streamed {what} {base[what]} "
                          f"!= train_sp's on-device {on_device[what]} (rel "
                          f"{e} > {tol})")
    agree = ranks[0]["infinity_agree"]
    ulysses = ranks[0]["ulysses"]
    agree_rel = {}
    for r, res in enumerate(ranks):
        a = res["infinity_agree"]
        require(a["loss"] == agree["loss"] and
                a["grad_norm"] == agree["grad_norm"],
                f"train_infinity_sp_agree: rank {r}'s metrics differ")
        require_stream_launches(f"train_infinity_sp_agree rank {r}",
                                a["launches"], AGREE_TRAIN["num_layers"],
                                SP_AGREE_STEPS)
        want = SP_AGREE_STEPS * AGREE_TRAIN["num_layers"] * \
            SP_A2A_PER_LAYER_STEP
        require(a["all_to_all"] == want, f"train_infinity_sp_agree rank "
                                         f"{r}: {a['all_to_all']} "
                                         f"all-to-alls, want {want}")
    for what in ("loss", "grad_norm"):
        agree_rel[what] = e = _max_rel(agree[what], ulysses[what])
        require(e <= INF_AGREE_RTOL,
                f"train_infinity_sp_agree: streamed {what} {agree[what]} "
                f"!= Ulysses' {ulysses[what]} (rel {e} > {INF_AGREE_RTOL})")
    step_s = statistics.median(base["step_s"][1:])
    return {"train": dict(
        layers=L, sp=SP, batch=[1, SP_SEQ], tokens_per_rank=SP_SEQ // SP,
        steps=SP_STEPS, dtype="bfloat16", attn_impl="flash",
        loss_tiles=SP_TILES, tier="cpu", path="fused",
        params=cfg.num_params(), layer_params=n,
        ranks=[r["infinity"] for r in ranks], rel_to_on_device=rel,
        on_device_sp2=dict(loss=on_device["loss"],
                           grad_norm=on_device["grad_norm"],
                           peak_mem_bytes=on_device["peak_mem_bytes"]),
        tolerance=dict(zip(("loss", "grad_norm"), SP_BF16_RTOL)),
        step_s_median=step_s, tokens_per_s_host=SP_SEQ / step_s),
        "agree": dict(batch=[2, SP_AGREE_SEQ], steps=SP_AGREE_STEPS, sp=SP,
                      against="train_sp_agree ulysses", runs=dict(
                          streamed=agree, ulysses=ulysses),
                      max_rel=agree_rel, tolerance=INF_AGREE_RTOL)}


def emit_train_sp(out: dict) -> None:
    """The train_sp, train_sp_agree, train_infinity_sp and
    train_infinity_sp_agree lines of one launch."""
    reduced = ["cards 2 -> 1, NCCL -> gloo through the host"]
    steps = [f"steps 3 -> {SP_STEPS} (the script's length)"]
    emit(dict(phase="train_sp", model="llama3_8b",
              reduced=[f"num_layers 32 -> {SP_LAYERS}"] + reduced + steps,
              comm=SP_NOTE, card=nvidia_smi_line(), **out["train"]))
    emit(dict(phase="train_sp_agree", dtype="float32", reduced=reduced,
              comm=SP_NOTE, **out["agree"]))
    emit(dict(phase="train_infinity_sp", model="llama3_8b",
              offload_param="cpu",
              reduced=[f"num_layers 32 -> {SP_LAYERS}"] + reduced + steps,
              comm=SP_NOTE, note=INF_NOTE, card=nvidia_smi_line(),
              **out["infinity"]))
    emit(dict(phase="train_infinity_sp_agree", dtype="float32",
              offload_param="cpu", reduced=reduced, comm=SP_NOTE,
              **out["infinity_agree"]))


# -- the tensor-parallel training slice ----------------------------------------

#: train_tp: Llama-3-8B widths at train_sp's depth, row and loss tiles, then
#: Mixtral-8x7B widths at train_moe's depth and row, each at tp ``TP`` in
#: one launch of two ranks on card 0 over gloo, ``TP_STEPS`` steps each
TP_STEPS = 2
TP_TRAIN_NOTE = ("gloo through the host, two ranks on one card: not a TP "
                 "speed")
#: the hybrid engine's generate on the tp-2 Llama after its steps: the
#: first ``TP_HYBRID_PROMPT`` tokens of the row, ``TP_HYBRID_NEW`` new
TP_HYBRID_PROMPT, TP_HYBRID_NEW = 64, 8
#: train_tp_agree: AGREE_TRAIN's fp32 widths (4 heads, 2 kv heads: 2 and 1
#: a rank) and its Mixtral case, ``TP_AGREE_STEPS`` steps on one batch, tp 2
#: against one process, losses and grad norms to ``TP_AGREE_RTOL``
TP_AGREE_STEPS, TP_AGREE_RTOL = 3, 1e-5
TP_AGREE_CASES = {"llama": False, "mixtral_fused_adam": True}


def tp_rank_params(cfg, tp: int) -> int:
    """A tensor rank's parameters: the embedding and the norms whole, the
    head's ``V/tp`` rows, ``1/tp`` of every layer's projections (a
    Mixtral's router whole, its experts' FFN dim cut)."""
    H, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_layers)
    hd, nh, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    attn = (H * nh * hd + 2 * H * nkv * hd + nh * hd * H) // tp
    E = getattr(cfg, "num_experts", None)
    ffn = (H * E + E * 3 * H * I // tp) if E else 3 * H * I // tp
    return V * H + V * H // tp + L * (attn + ffn + 2 * H) + H


def tp_digests(engine) -> dict:
    """sha1 of every leaf the tensor ranks each hold whole (fp32 masters,
    on the host): the ranks must hold them bit for bit."""
    import hashlib
    from deepspeed_tpu_torch.runtime.zero import tensor_of

    return {name: hashlib.sha1(np.ascontiguousarray(
        p.detach().cpu().numpy()).data).hexdigest()
        for name, p in zip(engine.param_names, engine.params)
        if tensor_of(p) is None}


def tp_train_config(model, fused_adam: bool = False, **extra) -> dict:
    return dict(ds_config(model, 1, fused_adam),
                tensor_parallel={"autotp_size": TP}, **extra)


def tp_agree_ids(seed: int, vocab: int) -> torch.Tensor:
    """train_agree's batch: ``[2, 200]`` from the seed."""
    return torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, vocab, (2, 200)))


def tp_agree_config(moe: bool):
    from deepspeed_tpu_torch import LlamaConfig, MixtralConfig
    return (MixtralConfig(**AGREE_TRAIN, num_experts=4, top_k=2) if moe
            else LlamaConfig(**AGREE_TRAIN))


def tp_agree_run(moe: bool, seed: int, dev, mesh=None) -> dict:
    """The fp32 agreement model (seed + 4) at tp ``TP`` on ``mesh`` (None:
    one process), ``TP_AGREE_STEPS`` AdamW steps with clipping on
    train_agree's batch (the Mixtral case under fused Adam)."""
    from deepspeed_tpu_torch import LlamaModel, MixtralModel, initialize

    cfg = tp_agree_config(moe)
    model = (MixtralModel if moe else LlamaModel)(cfg, device=dev,
                                                  seed=seed + 4, mesh=mesh)
    conf = dict(ds_config(model, 2, fused_adam=moe), gradient_clipping=1.0,
                optimizer={"type": "AdamW", "params": {"lr": 1e-3}})
    if mesh is not None:
        conf["tensor_parallel"] = {"autotp_size": TP}
    engine, *_ = initialize(model=model, config=conf, device=dev, mesh=mesh)
    ids = tp_agree_ids(seed, cfg.vocab_size).to(dev)
    reset_counts()
    ms = [engine.train_step({"input_ids": ids})
          for _ in range(TP_AGREE_STEPS)]
    out = {"loss": [float(m["loss"]) for m in ms],
           "grad_norm": [float(m["grad_norm"]) for m in ms],
           "launches": train_launches()}
    del model, engine
    return out


def tp_train_rank(rank: int, seed: int) -> dict:
    """One rank of train_tp (one launch): the tp-2 Llama-3-8B widths
    (train_sp's config, weights from the seed and row) through
    ``initialize`` with ``tensor_parallel.autotp_size`` and the hybrid
    engine, its steps, then 8 greedy tokens of ``generate``; after freeing
    it, Mixtral-8x7B widths (train_moe's config, weights and row) under
    fused Adam; then the fp32 agreement runs at tp 2."""
    from deepspeed_tpu_torch import (LlamaModel, MixtralConfig, MixtralModel,
                                     initialize)
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.utils import groups

    dev = zero_rank_setup()
    mesh = groups.initialize_mesh(MeshLayout.infer(tp=TP))
    cfg = sp_model_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device=dev, seed=seed, mesh=mesh)
    # the engine alone: an unpacked optimizer would outlive ``del engine``
    engine = initialize(model=model, config=tp_train_config(
        model, hybrid_engine={"enabled": True}), device=dev, mesh=mesh)[0]
    setup_s = time.perf_counter() - t0
    ids = sp_ids(seed, cfg.vocab_size, dev)
    run = sp_steps(engine, ids, TP_STEPS)
    prompt = ids[:, :TP_HYBRID_PROMPT]
    reset_counts()
    t0 = time.perf_counter()
    tokens = engine.generate(prompt, max_new_tokens=TP_HYBRID_NEW).cpu()
    hybrid = {"tokens": tokens[:, TP_HYBRID_PROMPT:].tolist(),
              "launches": read_counts(), "kind": type(engine).__name__,
              "wall_s": time.perf_counter() - t0}
    out = {"llama": dict(
        run, setup_s=setup_s, tp_rank=model.tp_rank,
        head_rows=model.lm_head.weight.shape[0],
        params=sum(p.numel() for p in engine.params),
        state_bytes=zero_state_bytes(engine), digests=tp_digests(engine),
        peak_mem_bytes=torch.cuda.max_memory_allocated()),
        "hybrid": hybrid}
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = MixtralConfig.mixtral_8x7b(
        num_layers=MOE_TRAIN_LAYERS, dtype=torch.bfloat16,
        param_dtype=torch.float32, attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MixtralModel(mcfg, device=dev, seed=seed, mesh=mesh)
    engine = initialize(model=model, config=tp_train_config(
        model, fused_adam=True), device=dev, mesh=mesh)[0]
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(seed)  # train_moe's row
    rows = torch.randint(0, mcfg.vocab_size, (1, TRAIN_SEQ), generator=gen,
                         device=dev)
    run = sp_steps(engine, rows, TP_STEPS)
    layer = model._moe_layer
    out["mixtral"] = dict(
        run, setup_s=setup_s, rung=layer.last_impl,
        params=sum(p.numel() for p in engine.params),
        state_bytes=zero_state_bytes(engine), digests=tp_digests(engine),
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    del model, engine, layer
    gc.collect()
    torch.cuda.empty_cache()
    out["agree"] = {label: tp_agree_run(moe, seed, dev, mesh)
                    for label, moe in TP_AGREE_CASES.items()}
    out["infinity"] = tp_infinity_run(seed, dev, mesh)
    out["infinity_agree"] = tp_infinity_agree_run(seed, dev, mesh)
    out["bert"] = tp_bert_run(seed, dev, mesh)
    out["ladder_agree"] = {kind: ladder_agree_run(kind, seed, dev, mesh)
                           for kind in LADDER_AGREE}
    return out


#: train_infinity_tp: train_tp's Llama (8B widths, SP_LAYERS layers, its
#: row and weights) streamed from the cpu tier at tp 2 (the fused path),
#: TP_STEPS steps; its fp32 agreement: AGREE_TRAIN streamed at tp 2 with
#: clipping (the stash path) against train_tp_agree's on-device tp 2
def tp_layer_params(cfg, tp: int) -> int:
    """One decoder layer's parameters on a tensor rank: ``1/tp`` of its
    projections, the two norms whole."""
    H = cfg.hidden_size
    return (layer_params(cfg) - 2 * H) // tp + 2 * H


def tp_infinity_run(seed: int, dev, mesh) -> dict:
    """train_infinity_tp on one rank: the model drawn on the card's
    generator into host memory on the mesh (this rank's blocks: the
    weights of train_tp's on-device model), ``offload_param`` cpu at tp
    2: the steps' metrics, launches, the trunk's bytes on the card and in
    host planes, the trunk leaves left on the card (none), the digests of
    the resident leaves every rank holds whole."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    free_host_cache()
    cfg = sp_model_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device="cpu", seed=seed, mesh=mesh,
                       init_device=dev)
    engine, *_ = initialize(model=model, config=dict(
        infinity_config(1), tensor_parallel={"autotp_size": TP}),
        device=dev, mesh=mesh)
    setup_s = time.perf_counter() - t0
    inf = engine.infinity
    sw = inf.swapper
    reset_counts()
    run = streamed_steps(engine, sp_ids(seed, cfg.vocab_size, dev),
                         TP_STEPS)
    out = dict(run, launches=train_launches(), setup_s=setup_s,
               tp_rank=model.tp_rank, split=sorted(inf.layer_tensor),
               n_elems=sw.n_elems, n_pad=sw.n_pad,
               device_buffer_bytes=sum(b.numel() * b.element_size()
                                       for b in sw._dev),
               peak_device_param_bytes=inf.peak_device_param_bytes(),
               host_plane_bytes=sw.host_plane_bytes(),
               trunk_on_card=sum(p.numel() for p in model.layers.parameters()
                                 if p.device.type == "cuda"),
               resident_params=inf.resident_param_count(),
               digests=tp_digests(engine),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    del model, engine, inf, sw
    free_host_cache()
    return out


def tp_infinity_agree_run(seed: int, dev, mesh) -> dict:
    """train_infinity_tp_agree on one rank: train_tp_agree's fp32 Llama
    (its weights and batch) streamed from the cpu tier at tp 2 with
    clipping (the stash path), ``TP_AGREE_STEPS`` steps."""
    from deepspeed_tpu_torch import LlamaModel, initialize

    cfg = tp_agree_config(False)
    model = LlamaModel(cfg, device="cpu", seed=seed + 4, mesh=mesh,
                       init_device=dev)
    engine, *_ = initialize(model=model, config=dict(
        infinity_config(2, torch.float32, clip=1.0),
        optimizer={"type": "AdamW", "params": {"lr": 1e-3}},
        tensor_parallel={"autotp_size": TP}), device=dev, mesh=mesh)
    out = sp_steps(engine, tp_agree_ids(seed, cfg.vocab_size).to(dev),
                   TP_AGREE_STEPS)
    del model, engine
    free_host_cache()
    return out


#: train_bert_tp: BERT-large widths at 2 of its 24 layers, train_bert's
#: ``[8, 512]`` batch (pad tails as segments), bf16, tp 2 (8 of 16 heads a
#: rank), TP_STEPS steps; the first held against one process
BERT_TP_LAYERS = 2


def tp_bert_run(seed: int, dev, mesh=None) -> dict:
    """BERT-large widths at ``BERT_TP_LAYERS`` on the mesh (one process
    without one): ``TP_STEPS`` steps on train_bert's batch, the launches,
    the whole leaves' digests, the rank's heads and peak memory."""
    from deepspeed_tpu_torch import BertModel, initialize

    torch.cuda.reset_peak_memory_stats()
    model = BertModel(bert_config(num_layers=BERT_TP_LAYERS), device=dev,
                      seed=seed, mesh=mesh)
    conf = ds_config(model, BERT_BATCH)
    if mesh is not None:
        conf["tensor_parallel"] = {"autotp_size": TP}
    engine, *_ = initialize(model=model, config=conf, device=dev, mesh=mesh)
    data = bert_batch(model.config.vocab_size, BERT_BATCH, seed + 1, dev)
    out = dict(sp_steps(engine, data, TP_STEPS),
               heads=model.num_local_heads, digests=tp_digests(engine),
               params=sum(p.numel() for p in engine.params),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: train_tp's AutoTP client (``tools/hf_client.py``, the CPU tests' model)
#: at these widths
AGREE_CLIENT = dict(vocab=2048, H=256, heads=4, kv_heads=2, inter=512,
                    layers=2)


def hf_client():
    """``tools/hf_client.py``, the HF-shaped client AutoTP splits."""
    import os
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import hf_client
    return hf_client


#: train_tp's fp32 agreements of the ladder models and an AutoTP client at
#: tp 2 against one process: OPT-1.3B widths at AGREE_OPT_LAYERS layers,
#: ResNet tiny (every leaf whole: cuDNN deterministic, so the tensor ranks'
#: gradients are bit-equal with no sum), a narrow BERT (2 layers of 512, 8
#: heads of 64: fp32 flash, pad tails) and the HF-shaped client at
#: AGREE_CLIENT, TP_AGREE_STEPS AdamW steps with clipping on one batch
#: from the seed: every loss and grad norm within TP_AGREE_RTOL.  OPT's
#: MLP is a ReLU, whose derivative jumps at 0: a pre-activation within
#: rounding of 0 takes the other branch at tp 2 than in one process (the
#: column split rounds fc_in's product differently), and the gradients
#: that reach it part by more than rounding.  ``tools/tp_grad_probe.py``
#: counts those sign flips and reruns one process with the tp-2 run's
#: ReLU mask, which closes the gap.  So OPT holds its first loss (no flip
#: has reached it) to TP_AGREE_RTOL and the rest to OPT_AGREE_RTOL: 1.5x
#: the largest departure these deterministic runs give on an H100 80GB
#: HBM3 (the third grad norm's 1.68e-4)
LADDER_AGREE = ("opt", "resnet", "bert", "client")
OPT_AGREE_RTOL = 2.5e-4


def ladder_agree_model(kind: str, seed: int, dev, mesh=None):
    from deepspeed_tpu_torch import (BertConfig, BertModel, OPTConfig,
                                     OPTModel, ResNetConfig, ResNetModel,
                                     tp_model_init)

    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    if kind == "opt":
        return OPTModel(OPTConfig.opt_1_3b(num_layers=AGREE_OPT_LAYERS,
                                           **f32), device=dev, seed=seed + 5,
                        mesh=mesh)
    if kind == "resnet":
        return ResNetModel(ResNetConfig.tiny(**f32), device=dev,
                           seed=seed + 5, mesh=mesh)
    if kind == "bert":  # d 64: the flash kernels' smallest head dim
        return BertModel(BertConfig.tiny(
            num_layers=2, hidden_size=512, num_heads=8,
            intermediate_size=1024, attn_impl="flash", **f32), device=dev,
            seed=seed + 5, mesh=mesh)
    model = hf_client().ClientLM(seed + 5, AGREE_CLIENT).to(dev)
    return tp_model_init(model, tp_size=TP, mesh=mesh) if mesh is not None \
        else model


def ladder_agree_batch(kind: str, seed: int, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    if kind == "resnet":
        return {"images": torch.randn(8, 8, 8, 3, generator=gen,
                                      device=dev),
                "labels": torch.randint(0, 10, (8,), generator=gen,
                                        device=dev)}
    vocab = AGREE_CLIENT["vocab"] if kind == "client" else 512 if \
        kind == "bert" else 50272
    ids = torch.randint(0, vocab, (2, 128), generator=gen, device=dev)
    if kind != "bert":
        return {"input_ids": ids}
    mask = torch.ones_like(ids, dtype=torch.int32)
    mask[1, 100:] = 0
    picked = (torch.rand(ids.shape, generator=gen, device=dev) < 0.3) & \
        mask.bool()
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": torch.zeros_like(ids),
            "labels": torch.where(picked, ids, torch.full_like(ids, -100))}


def ladder_agree_run(kind: str, seed: int, dev, mesh=None) -> dict:
    """``TP_AGREE_STEPS`` fp32 AdamW steps (lr 1e-3, clipping 1.0) of a
    ladder agreement model at tp 2 on ``mesh`` (one process without one):
    losses, grad norms, launches and the whole leaves' digests."""
    from deepspeed_tpu_torch import initialize

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = ladder_agree_model(kind, seed, dev, mesh)
        batch = ladder_agree_batch(kind, seed, dev)
        conf = {"train_micro_batch_size_per_gpu": next(
                    iter(batch.values())).shape[0],
                "gradient_clipping": 1.0, "steps_per_print": 0,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": 0}}
        if mesh is not None:
            conf["tensor_parallel"] = {"autotp_size": TP}
        engine, *_ = initialize(model=model, config=conf, device=dev,
                                mesh=mesh)
        out = dict(sp_steps(engine, batch, TP_AGREE_STEPS),
                   digests=tp_digests(engine),
                   split=sum(p.numel() for p in engine.params
                             if hasattr(p, "ds_tensor")),
                   params=sum(p.numel() for p in engine.params))
        del model, engine
        return out
    finally:
        torch.backends.cudnn.deterministic = deterministic


def phase_train_tp(dev, seed: int, res: dict) -> dict:
    """train_tp, train_tp_agree and the tp-2 hybrid generate (from the
    launch of ``TP`` ranks on card 0 over gloo it shares with train_sp,
    :func:`sp_tp_launch`), after train_sp and train_moe (their
    one-process runs in ``res``): per model, finite falling losses and
    grad norms bit-equal on the ranks, every leaf the ranks hold whole
    bit-equal (sha1), each rank's parameters and state bytes those of the
    split (16 bytes a parameter), the launch formula per rank (flash at the
    ``_sp`` shape for the Llama; #11/#12 on the kernel rung, #13/#14 once a
    step for the Mixtral), the first step's loss and grad norm within
    ``SP_BF16_RTOL`` of one process on the same weights and row; the
    hybrid's tokens equal on the ranks, decode #1 ``L x (new - 1)`` times;
    the fp32 agreements within ``TP_AGREE_RTOL`` of one process."""
    from deepspeed_tpu_torch import MixtralConfig

    got = shared_launch("sp_tp", lambda: sp_tp_launch(dev, seed))
    ranks, wall = [r["tp"] for r in got["ranks"]], got["wall"]
    one_bert = got["one_bert"]  # train_bert_tp's one process
    # train_sp's sp-1 run and train_moe's, on the same weights and rows
    one = {"llama": res["train_sp_one"], "mixtral": res["train_moe"]}
    cfgs = {"llama": sp_model_config(),
            "mixtral": MixtralConfig.mixtral_8x7b(
                num_layers=MOE_TRAIN_LAYERS)}
    out = {"launch_wall_s": wall}
    for name, cfg in cfgs.items():
        base = ranks[0][name]
        moe = name == "mixtral"
        want_params = tp_rank_params(cfg, TP)
        for r, res_r in enumerate(ranks):
            t = res_r[name]
            what = f"train_tp {name} rank {r}"
            require(all(np.isfinite(t["loss"])) and
                    t["loss"][-1] < t["loss"][0],
                    f"{what}: losses {t['loss']}")
            require(t["loss"] == base["loss"] and
                    t["grad_norm"] == base["grad_norm"],
                    f"{what}: losses {t['loss']} / grad norms "
                    f"{t['grad_norm']} != rank 0's")
            require(t["digests"] == base["digests"],
                    f"{what}: a leaf the ranks hold whole differs")
            require(t["params"] == want_params and
                    t["state_bytes"]["total"] == 16 * want_params,
                    f"{what}: {t['params']} parameters, "
                    f"{t['state_bytes']['total']} state bytes; predicted "
                    f"{want_params}, {16 * want_params}")
            require_train_launches(what, dict(
                layers=cfg.num_layers, steps=TP_STEPS, remat=True,
                fused_adam=moe, launches=t["launches"]), moe=moe)
            require(t["all_to_all"] == 0, f"{what}: all-to-alls ran")
            if moe:
                require(t["rung"] == "pallas",
                        f"{what}: the MoE layer took the {t['rung']} rung")
            else:
                require(t["head_rows"] == cfg.vocab_size // TP,
                        f"{what}: the head holds {t['head_rows']} rows")
        rel = {}
        for what, tol in zip(("loss", "grad_norm"), SP_BF16_RTOL):
            rel[what] = e = abs(base[what][0] - one[name][what][0]) / abs(
                one[name][what][0])
            require(e <= tol, f"train_tp {name}: tp {TP}'s first {what} "
                              f"{base[what][0]} != one process's "
                              f"{one[name][what][0]} (rel {e} > {tol})")
        out[name] = dict(
            layers=cfg.num_layers, tp=TP, steps=TP_STEPS,
            batch=[1, SP_SEQ if name == "llama" else TRAIN_SEQ],
            params_a_rank=want_params, params_one_process=cfg.num_params(),
            state_bytes_a_rank=16 * want_params,
            ranks=[{k: v for k, v in r[name].items() if k != "digests"}
                   for r in ranks],
            whole_leaves_bit_equal=len(base["digests"]),
            one_process_first=dict(loss=one[name]["loss"][0],
                                   grad_norm=one[name]["grad_norm"][0]),
            rel_to_one_process=rel,
            tolerance=dict(zip(("loss", "grad_norm"), SP_BF16_RTOL)),
            host_step_ms=statistics.median(base["host_step_ms"][1:]),
            peak_mem_bytes_sum=sum(r[name]["peak_mem_bytes"]
                                   for r in ranks))
    L = cfgs["llama"].num_layers
    hyb = ranks[0]["hybrid"]
    for r, res_r in enumerate(ranks):
        h = res_r["hybrid"]
        require(h["kind"] == "DeepSpeedHybridEngine" and
                h["tokens"] == hyb["tokens"],
                f"train_tp hybrid rank {r}: {h['kind']}, tokens "
                f"{h['tokens']} != rank 0's {hyb['tokens']}")
        require(h["launches"]["decode_attention"] == L * (TP_HYBRID_NEW - 1)
                and h["launches"]["flash_fwd"] == 0,
                f"train_tp hybrid rank {r}: launches {h['launches']}")
    require(all(0 <= t < cfgs["llama"].vocab_size
                for row in hyb["tokens"] for t in row),
            "train_tp hybrid: ids outside the vocabulary")
    out["hybrid"] = dict(prompt=[1, TP_HYBRID_PROMPT],
                         new_tokens=TP_HYBRID_NEW, **hyb)
    agree = {}
    for label, moe in TP_AGREE_CASES.items():
        ref = tp_agree_run(moe, seed, dev)
        got = ranks[0]["agree"][label]
        rel = {}
        for r, res_r in enumerate(ranks):
            a = res_r["agree"][label]
            require(a["loss"] == got["loss"] and
                    a["grad_norm"] == got["grad_norm"],
                    f"train_tp_agree {label}: rank {r}'s metrics differ")
            require_train_launches(f"train_tp_agree {label} rank {r}", dict(
                layers=AGREE_TRAIN["num_layers"], steps=TP_AGREE_STEPS,
                remat=True, fused_adam=moe, launches=a["launches"]), moe=moe)
        for what in ("loss", "grad_norm"):
            rel[what] = e = _max_rel(got[what], ref[what])
            require(e <= TP_AGREE_RTOL,
                    f"train_tp_agree {label}: tp {TP}'s {what} {got[what]} "
                    f"!= one process's {ref[what]} (rel {e} > "
                    f"{TP_AGREE_RTOL})")
        agree[label] = dict(tp2=got, one_process=ref, max_rel=rel)
    out["agree"] = dict(
        model=dict((k, v) for k, v in AGREE_TRAIN.items()
                   if k not in ("dtype", "param_dtype")),
        batch=[2, 200], steps=TP_AGREE_STEPS, tp=TP,
        tolerance=TP_AGREE_RTOL, runs=agree)
    out["infinity"], out["infinity_agree"] = check_infinity_tp(
        ranks, cfgs["llama"])
    out["bert"] = check_bert_tp(ranks, one_bert)
    out["ladder_agree"] = check_ladder_agree(dev, seed, ranks)
    return out


#: train_infinity_tp's split leaves of a layer
TP_LAYER_SPLIT = sorted(f"{n}.weight" for n in (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj"))


def check_infinity_tp(ranks: list, cfg) -> tuple:
    """train_infinity_tp and its agreement, from train_tp's launch: the
    ranks' metrics and resident whole leaves bit-equal, the flash launches
    of ``require_stream_launches``, the trunk's device buffers and host
    planes those of the tensor rank's plane to the byte, no trunk leaf on
    the card, the first step within ``SP_BF16_RTOL`` of train_tp's
    on-device run (same weights and row); the fp32 streamed run within
    ``INF_AGREE_RTOL`` of train_tp_agree's on-device tp-2 run."""
    L = cfg.num_layers
    n = tp_layer_params(cfg, TP)
    base = ranks[0]["infinity"]
    for r, res_r in enumerate(ranks):
        t = res_r["infinity"]
        what = f"train_infinity_tp rank {r}"
        require(all(np.isfinite(t["loss"])) and t["loss"][-1] < t["loss"][0],
                f"{what}: losses {t['loss']}")
        require(t["loss"] == base["loss"] and
                t["grad_norm"] == base["grad_norm"] and
                t["digests"] == base["digests"],
                f"{what}: losses {t['loss']}, grad norms {t['grad_norm']} "
                "or a resident whole leaf differ from rank 0's")
        require(t["split"] == TP_LAYER_SPLIT,
                f"{what}: split leaves {t['split']}")
        require_stream_launches(what, t["launches"], L, TP_STEPS)
        require(t["n_elems"] == n == t["n_pad"] and
                t["device_buffer_bytes"] == t["peak_device_param_bytes"]
                == 2 * n * 2 and t["host_plane_bytes"] == L * n * 14,
                f"{what}: a layer of {t['n_elems']} (want {n}), device "
                f"buffers {t['device_buffer_bytes']} B (want {4 * n}), host "
                f"planes {t['host_plane_bytes']} B (want {L * n * 14})")
        require(t["trunk_on_card"] == 0,
                f"{what}: {t['trunk_on_card']} trunk elements on the card")
    on_device = ranks[0]["llama"]
    rel = {}
    for what, tol in zip(("loss", "grad_norm"), SP_BF16_RTOL):
        rel[what] = e = abs(base[what][0] - on_device[what][0]) / abs(
            on_device[what][0])
        require(e <= tol, f"train_infinity_tp: streamed first {what} "
                          f"{base[what][0]} != on-device tp 2's "
                          f"{on_device[what][0]} (rel {e} > {tol})")
    agree = ranks[0]["infinity_agree"]
    want = ranks[0]["agree"]["llama"]
    for r, res_r in enumerate(ranks):
        a = res_r["infinity_agree"]
        require(a["loss"] == agree["loss"] and
                a["grad_norm"] == agree["grad_norm"],
                f"train_infinity_tp_agree: rank {r}'s metrics differ")
        require_stream_launches(f"train_infinity_tp_agree rank {r}",
                                a["launches"], AGREE_TRAIN["num_layers"],
                                TP_AGREE_STEPS)
    agree_rel = {}
    for what in ("loss", "grad_norm"):
        agree_rel[what] = e = _max_rel(agree[what], want[what])
        require(e <= INF_AGREE_RTOL,
                f"train_infinity_tp_agree: streamed {what} {agree[what]} "
                f"!= on-device tp 2's {want[what]} (rel {e} > "
                f"{INF_AGREE_RTOL})")
    step_s = statistics.median(base["step_s"][1:])
    return (dict(layers=L, tp=TP, batch=[1, SP_SEQ], steps=TP_STEPS,
                 dtype="bfloat16", attn_impl="flash", loss_tiles=SP_TILES,
                 tier="cpu", path="fused", layer_params_a_rank=n,
                 ranks=[{k: v for k, v in x["infinity"].items()
                         if k != "digests"} for x in ranks],
                 resident_whole_leaves_bit_equal=len(base["digests"]),
                 on_device_first=dict(loss=on_device["loss"][0],
                                      grad_norm=on_device["grad_norm"][0]),
                 rel_to_on_device=rel,
                 tolerance=dict(zip(("loss", "grad_norm"), SP_BF16_RTOL)),
                 step_s_median=step_s, tokens_per_s_host=SP_SEQ / step_s),
            dict(batch=[2, 200], steps=TP_AGREE_STEPS, tp=TP, path="stash",
                 against="train_tp_agree llama (on-device tp 2)",
                 runs=dict(streamed=agree, on_device=want),
                 max_rel=agree_rel, tolerance=INF_AGREE_RTOL))


def check_bert_tp(ranks: list, one: dict) -> dict:
    """train_bert_tp: finite, falling losses and grad norms bit-equal on the
    ranks, every whole leaf bit-equal, 8 of 16 heads a rank, the flash
    launches of the formula, the first step within ``SP_BF16_RTOL`` of
    one process on the same weights and batch."""
    base = ranks[0]["bert"]
    cfg = bert_config(num_layers=BERT_TP_LAYERS)
    for r, res_r in enumerate(ranks):
        t = res_r["bert"]
        what = f"train_bert_tp rank {r}"
        require(all(np.isfinite(t["loss"])) and t["loss"][-1] < t["loss"][0],
                f"{what}: losses {t['loss']}")
        require(t["loss"] == base["loss"] and
                t["grad_norm"] == base["grad_norm"] and
                t["digests"] == base["digests"],
                f"{what}: metrics or a whole leaf differ from rank 0's")
        require(t["heads"] == cfg.num_heads // TP, f"{what}: {t['heads']} "
                                                   "heads")
        require_train_launches(what, dict(
            layers=BERT_TP_LAYERS, steps=TP_STEPS, remat=True,
            fused_adam=False, launches=t["launches"]))
    rel = {}
    for what, tol in zip(("loss", "grad_norm"), SP_BF16_RTOL):
        rel[what] = e = abs(base[what][0] - one[what][0]) / abs(one[what][0])
        require(e <= tol, f"train_bert_tp: tp {TP}'s first {what} "
                          f"{base[what][0]} != one process's {one[what][0]} "
                          f"(rel {e} > {tol})")
    return dict(layers=BERT_TP_LAYERS, tp=TP, batch=[BERT_BATCH, BERT_SEQ],
                steps=TP_STEPS, heads_a_rank=base["heads"],
                ranks=[{k: v for k, v in x["bert"].items()
                        if k != "digests"} for x in ranks],
                whole_leaves_bit_equal=len(base["digests"]),
                one_process={k: one[k] for k in ("loss", "grad_norm",
                                                 "params",
                                                 "peak_mem_bytes")},
                rel_to_one_process=rel,
                tolerance=dict(zip(("loss", "grad_norm"), SP_BF16_RTOL)),
                host_step_ms=statistics.median(base["host_step_ms"][1:]))


def check_ladder_agree(dev, seed: int, ranks: list) -> dict:
    """train_tp_ladder_agree: each ladder agreement model's tp-2 metrics
    and whole leaves bit-equal on the ranks, split leaves on OPT, BERT and
    the client (none on ResNet), the launches (BERT's fp32 flash of the
    formula, none elsewhere), and its losses and grad norms within
    ``TP_AGREE_RTOL`` of one process."""
    out = {}
    for kind in LADDER_AGREE:
        base = ranks[0]["ladder_agree"][kind]
        for r, res_r in enumerate(ranks):
            t = res_r["ladder_agree"][kind]
            what = f"train_tp_ladder_agree {kind} rank {r}"
            require(t["loss"] == base["loss"] and
                    t["grad_norm"] == base["grad_norm"] and
                    t["digests"] == base["digests"],
                    f"{what}: metrics or a whole leaf differ from rank 0's")
            require((t["split"] == 0) == (kind == "resnet"),
                    f"{what}: {t['split']} elements in split leaves")
            require_train_launches(what, dict(
                layers=2 if kind == "bert" else 0, steps=TP_AGREE_STEPS,
                remat=True, fused_adam=False, launches=t["launches"]))
        one = ladder_agree_run(kind, seed, dev)
        rel = {"first_loss": _max_rel(base["loss"][:1], one["loss"][:1]),
               "loss": _max_rel(base["loss"], one["loss"]),
               "grad_norm": _max_rel(base["grad_norm"], one["grad_norm"])}
        for what, e in rel.items():
            tol = (OPT_AGREE_RTOL if kind == "opt" and what != "first_loss"
                   else TP_AGREE_RTOL)
            require(e <= tol,
                    f"train_tp_ladder_agree {kind}: tp {TP}'s {what} ("
                    f"losses {base['loss']}, grad norms {base['grad_norm']})"
                    f" != one process's ({one['loss']}, {one['grad_norm']})"
                    f" (rel {e} > {tol})")
        out[kind] = dict(tp2={k: base[k] for k in ("loss", "grad_norm",
                                                   "params", "split")},
                         one_process={k: one[k] for k in ("loss",
                                                          "grad_norm",
                                                          "params")},
                         whole_leaves_bit_equal=len(base["digests"]),
                         max_rel=rel)
        free_host_cache()
    return dict(models={"opt": f"opt_1_3b widths, {AGREE_OPT_LAYERS} "
                               "layers", "resnet": "ResNetConfig.tiny",
                        "bert": "BertConfig.tiny at 2 x 512, 8 heads of "
                                "64, flash",
                        "client": "tools/hf_client.py at AGREE_CLIENT (AutoTP's name policy)"},
                steps=TP_AGREE_STEPS, tp=TP, dtype="float32",
                tolerance=dict(all=TP_AGREE_RTOL,
                               opt_after_its_first_loss=OPT_AGREE_RTOL),
                runs=out)


def emit_train_tp(out: dict) -> None:
    """The train_tp, train_tp_agree and train_tp_hybrid lines."""
    reduced = ["cards 2 -> 1, NCCL -> gloo through the host",
               f"steps 3 -> {TP_STEPS} (the script's length)"]
    for name, label in (("llama", "llama3_8b"), ("mixtral", "mixtral_8x7b")):
        emit(dict(phase="train_tp", model=label, dtype="bfloat16",
                  reduced=[f"num_layers 32 -> {out[name]['layers']}"]
                  + reduced, comm=TP_TRAIN_NOTE, card=nvidia_smi_line(),
                  launch_wall_s=out["launch_wall_s"], **out[name]))
    emit(dict(phase="train_tp_agree", dtype="float32",
              reduced=reduced[:1], comm=TP_TRAIN_NOTE, **out["agree"]))
    emit(dict(phase="train_tp_hybrid", model="llama3_8b",
              reduced=[f"num_layers 32 -> {SP_LAYERS}"] + reduced[:1],
              **out["hybrid"]))
    emit(dict(phase="train_infinity_tp", model="llama3_8b",
              offload_param="cpu",
              reduced=[f"num_layers 32 -> {SP_LAYERS}"] + reduced,
              comm=TP_TRAIN_NOTE, note=INF_NOTE, card=nvidia_smi_line(),
              **out["infinity"]))
    emit(dict(phase="train_infinity_tp_agree", dtype="float32",
              offload_param="cpu", reduced=reduced[:1], comm=TP_TRAIN_NOTE,
              **out["infinity_agree"]))
    emit(dict(phase="train_bert_tp", model="bert_large", dtype="bfloat16",
              reduced=[f"num_layers 24 -> {BERT_TP_LAYERS}"] + reduced,
              comm=TP_TRAIN_NOTE, card=nvidia_smi_line(), **out["bert"]))
    emit(dict(phase="train_tp_ladder_agree", reduced=reduced[:1],
              comm=TP_TRAIN_NOTE, **out["ladder_agree"]))


# -- tensor x sequence parallelism ---------------------------------------------

#: train_tp_sp: Mistral-7B widths (32 heads, 8 kv, window 4096, V 32000) at
#: train_sp's depth, row and loss tiles, tp 2 x sp 2 in one launch of four
#: ranks on card 0 over gloo (h 32 / (tp sp) = 8 heads a rank at the full
#: S 8192: the ``tpsp`` flash case), TP_STEPS steps; then AGREE_TRAIN's
#: fp32 widths at tp 2 x sp 2, Ulysses and the ring, against one process
TP_SP_RANKS = TP * SP
TP_SP_NOTE = "gloo through the host, four ranks on one card: not a speed"
#: name -> attn_impl; the first step holds to TP_AGREE_RTOL of the
#: one-process flash run, every step to TP_SP_AGREE_RTOL: three Adam steps
#: on AGREE_TRAIN part by ~1e-5 at sp 2 alone (train_sp_agree's Ulysses
#: grad norms 9.4e-6 from one process on an H100 80GB HBM3), and tp 2
#: x sp 2 adds the order of the tensor sums (2.2e-5 there); the bound is
#: train_sp_agree's ring's
TP_SP_AGREE_RUNS = {"ulysses": "flash", "ring": "ring"}
TP_SP_AGREE_RTOL = 1e-4


def tp_sp_model_config():
    from deepspeed_tpu_torch import LlamaConfig
    return LlamaConfig.mistral_7b(num_layers=SP_LAYERS, dtype=torch.bfloat16,
                                  param_dtype=torch.float32,
                                  attn_impl="flash", loss_tiles=SP_TILES)


def tp_sp_config(model, micro: int, **extra) -> dict:
    return dict(ds_config(model, micro), tensor_parallel={
        "autotp_size": TP}, sequence_parallel={"sp_size": SP}, **extra)


def tp_leaf_digests(engine) -> dict:
    """sha1 of every leaf (fp32 masters, on the host), with whether the
    tensor axis splits it."""
    import hashlib
    from deepspeed_tpu_torch.runtime.zero import tensor_of

    return {name: (hashlib.sha1(np.ascontiguousarray(
        p.detach().cpu().numpy()).data).hexdigest(),
        tensor_of(p) is not None)
        for name, p in zip(engine.param_names, engine.params)}


def tp_sp_train_rank(rank: int, seed: int) -> dict:
    """One rank of train_tp_sp (one launch): Mistral-7B widths built on a
    tp 2 x sp 2 mesh (this rank's tensor blocks of the seeded weights)
    through ``initialize``, its steps on the whole ``[1, SP_SEQ]`` row
    (its 4096-token chunk on its 16 of 32 heads, Ulysses over its seq
    group), the leaves' digests; then the fp32 agreement runs."""
    from deepspeed_tpu_torch import LlamaModel, initialize
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.utils import groups

    dev = zero_rank_setup()
    mesh = groups.initialize_mesh(MeshLayout.infer(TP_SP_RANKS, tp=TP,
                                                   sp=SP))
    cfg = tp_sp_model_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaModel(cfg, device=dev, seed=seed, mesh=mesh)
    engine = initialize(model=model, config=tp_sp_config(model, 1),
                        device=dev, mesh=mesh)[0]
    setup_s = time.perf_counter() - t0
    run = sp_steps(engine, sp_ids(seed, cfg.vocab_size, dev), TP_STEPS)
    out = {"train": dict(
        run, setup_s=setup_s, tp_rank=model.tp_rank,
        sp_rank=mesh.axis_rank("seq"), heads=model.num_local_heads,
        head_rows=model.lm_head.weight.shape[0],
        params=sum(p.numel() for p in engine.params),
        state_bytes=zero_state_bytes(engine),
        digests=tp_leaf_digests(engine),
        peak_mem_bytes=torch.cuda.max_memory_allocated())}
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    for label, attn in TP_SP_AGREE_RUNS.items():
        model = LlamaModel(sp_agree_config(attn, 1), device=dev,
                           seed=seed + 4, mesh=mesh)
        engine, *_ = initialize(model=model, config=tp_sp_config(
            model, 2, optimizer={"type": "AdamW", "params": {"lr": 1e-3}}),
            device=dev, mesh=mesh)
        out[label] = sp_steps(engine, sp_agree_ids(seed, dev),
                              SP_AGREE_STEPS)
        del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    out["moe_mesh"] = moe_mesh_rank(rank, seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["hpz"] = hpz_rank(rank, seed, dev)  # train_hpz
    return out


def phase_train_tp_sp(dev, seed: int) -> dict:
    """train_tp_sp and train_tp_sp_agree: one process trains the Mistral
    widths on the seeded weights and row (its first step, then freed);
    four ranks on card 0 over gloo train it at tp 2 x sp 2: finite,
    falling losses and grad norms bit-equal on the four, every leaf the
    tensor axis leaves whole bit-equal on the four and every split leaf on
    the two seq ranks of its tensor coordinate, each rank's parameters and
    state bytes those of the tensor split (16 bytes a parameter), the
    launch formula at the ``tpsp`` flash shape and 12 L all-to-alls a
    step, the first step within ``SP_BF16_RTOL`` of one process; the fp32
    agreements (``TP_SP_AGREE_RUNS``) against one process's flash run."""
    import os

    from deepspeed_tpu_torch import LlamaModel, initialize
    from deepspeed_tpu_torch.launcher import launch
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.build()  # here, so the ranks do not all run nvcc
    free_host_cache()
    cfg = tp_sp_model_config()
    model = LlamaModel(cfg, device=dev, seed=seed)
    engine = initialize(model=model, config=ds_config(model, 1),
                        device=dev)[0]
    torch.cuda.reset_peak_memory_stats()
    one = sp_steps(engine, sp_ids(seed, cfg.vocab_size, dev), 1)
    one["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    require_sp_launches("train_tp_sp one process", one, "flash",
                        cfg.num_layers, 1, 1)
    del model, engine
    agree_one = sp_agree_run(sp_agree_config("flash", 1), seed, dev, 1)
    free_host_cache()
    moe_one = moe_mesh_one_process(seed, dev)
    free_host_cache()
    gc.collect()
    torch.cuda.empty_cache()  # four ranks share the card after this
    t0 = time.perf_counter()
    # the ranks' allocators grow segments in place: four ranks' int8
    # transients (train_hpz) left 4.3 GiB a rank stranded in fixed ones
    alloc_key = "PYTORCH_CUDA_ALLOC_CONF"
    saved = os.environ.get(alloc_key)
    os.environ[alloc_key] = "expandable_segments:True"
    try:
        ranks = launch(tp_sp_train_rank, TP_SP_RANKS, (seed,),
                       timeout=SP_TIMEOUT + TP_TIMEOUT)
    finally:
        if saved is None:
            os.environ.pop(alloc_key)
        else:
            os.environ[alloc_key] = saved
    wall = time.perf_counter() - t0
    L = cfg.num_layers
    base = ranks[0]["train"]
    want_params = tp_rank_params(cfg, TP)
    coords = sorted((x["train"]["tp_rank"], x["train"]["sp_rank"])
                    for x in ranks)
    require(coords == [(t, q) for t in range(TP) for q in range(SP)],
            f"train_tp_sp: (tensor, seq) coordinates {coords}")
    for r, res_r in enumerate(ranks):
        t = res_r["train"]
        what = f"train_tp_sp rank {r}"
        require(all(np.isfinite(t["loss"])) and t["loss"][-1] < t["loss"][0],
                f"{what}: losses {t['loss']}")
        require(t["loss"] == base["loss"] and
                t["grad_norm"] == base["grad_norm"],
                f"{what}: losses {t['loss']} / grad norms {t['grad_norm']} "
                "!= rank 0's")
        for other in ranks:
            o = other["train"]
            for name, (digest, split) in t["digests"].items():
                if not split or o["tp_rank"] == t["tp_rank"]:
                    require(o["digests"][name][0] == digest,
                            f"{what}: {name} differs from the rank at "
                            f"(tensor {o['tp_rank']}, seq {o['sp_rank']})")
        require(t["params"] == want_params and
                t["state_bytes"]["total"] == 16 * want_params,
                f"{what}: {t['params']} parameters, "
                f"{t['state_bytes']['total']} state bytes; predicted "
                f"{want_params}, {16 * want_params}")
        require(t["heads"] == cfg.num_heads // TP and
                t["head_rows"] == cfg.vocab_size // TP,
                f"{what}: {t['heads']} heads, {t['head_rows']} head rows")
        require_sp_launches(what, t, "flash", L, TP_STEPS, SP)
    rel = {}
    for what, tol in zip(("loss", "grad_norm"), SP_BF16_RTOL):
        rel[what] = e = abs(base[what][0] - one[what][0]) / abs(one[what][0])
        require(e <= tol, f"train_tp_sp: tp {TP} x sp {SP}'s first {what} "
                          f"{base[what][0]} != one process's {one[what][0]} "
                          f"(rel {e} > {tol})")
    agree, agree_rel = {"one_process": agree_one}, {}
    for label, attn in TP_SP_AGREE_RUNS.items():
        agree[label] = run = ranks[0][label]
        require(all(x[label]["loss"] == run["loss"] and
                    x[label]["grad_norm"] == run["grad_norm"]
                    for x in ranks),
                f"train_tp_sp_agree {label}: the ranks' metrics differ")
        require_sp_launches(f"train_tp_sp_agree {label}", run, attn,
                            AGREE_TRAIN["num_layers"], SP_AGREE_STEPS, SP)
        for what in ("loss", "grad_norm"):
            for key, n, tol in (("first", 1, TP_AGREE_RTOL),
                                ("all", SP_AGREE_STEPS, TP_SP_AGREE_RTOL)):
                agree_rel[f"{label}_{what}_{key}"] = e = _max_rel(
                    run[what][:n], agree_one[what][:n])
                require(e <= tol, f"train_tp_sp_agree {label}: {what} "
                                  f"{run[what]} != one process's "
                                  f"{agree_one[what]} ({key} steps: rel "
                                  f"{e} > {tol})")
    step_ms = statistics.median(base["host_step_ms"][1:])
    return {"moe_mesh": check_moe_mesh(ranks, moe_one),
            "hpz": check_hpz(ranks), "train": dict(
        layers=L, tp=TP, sp=SP, batch=[1, SP_SEQ],
        tokens_per_rank=SP_SEQ // SP, steps=TP_STEPS, dtype="bfloat16",
        attn_impl="flash", window=cfg.sliding_window, loss_tiles=SP_TILES,
        remat=True, params_one_process=cfg.num_params(),
        params_a_rank=want_params, state_bytes_a_rank=16 * want_params,
        heads_per_rank_in_attention=cfg.num_heads // (TP * SP),
        ranks=[{k: v for k, v in x["train"].items() if k != "digests"}
               for x in ranks],
        leaves_checked=len(base["digests"]), one_process=one,
        rel_to_one_process=rel, tolerance=dict(zip(("loss", "grad_norm"),
                                                   SP_BF16_RTOL)),
        host_step_ms=step_ms, launch_wall_s=wall,
        peak_mem_bytes_sum=sum(x["train"]["peak_mem_bytes"]
                               for x in ranks)),
        "agree": dict(
            model=dict((k, v) for k, v in AGREE_TRAIN.items()
                       if k not in ("dtype", "param_dtype")),
            batch=[2, SP_AGREE_SEQ], steps=SP_AGREE_STEPS, tp=TP, sp=SP,
            runs=agree, max_rel=agree_rel,
            tolerance=dict(first=TP_AGREE_RTOL, all=TP_SP_AGREE_RTOL))}


def emit_train_tp_sp(out: dict) -> None:
    reduced = ["cards 4 -> 1, NCCL -> gloo through the host"]
    emit(dict(phase="train_tp_sp", model="mistral_7b",
              reduced=[f"num_layers 32 -> {SP_LAYERS}"] + reduced,
              comm=TP_SP_NOTE, card=nvidia_smi_line(), **out["train"]))
    emit(dict(phase="train_tp_sp_agree", dtype="float32", reduced=reduced,
              comm=TP_SP_NOTE, **out["agree"]))
    emit_moe_mesh(out["moe_mesh"])
    emit_zeropp("train_hpz", out["hpz"], HPZ_RUNS, HPZ_RANKS, ep=HPZ_EP,
                dp=HPZ_RANKS // HPZ_EP, hpz=HPZ_RANKS // HPZ_EP,
                loss_rel_to_stage3=out["hpz"]["loss_rel_to_stage3"],
                tolerance=ZERO_STAGE_RTOL)


# -- the MoE and the other ladder models under seq; expert x tensor -----------

#: train_bert_sp / train_opt_sp (train_sp's launch, a body of its own after
#: train_sp's and train_tp's): BERT-large widths at BERT_TP_LAYERS of 24
#: on train_bert's [8, 512] batch (train_bert_tp's one-process run is the
#: reference) and OPT-1.3B widths at SEQ_OPT_LAYERS of 24 on one
#: [1, SEQ_OPT_SEQ] row (its max_seq_len), at sp SP on the flash kernels
#: (Ulysses: 8 of BERT's 16 heads, non-causal with the whole rows' pads as
#: segments; 16 of OPT's 32, causal, d 64, at the full S), bf16 on fp32
#: masters, remat, TP_STEPS steps; the first held against one process
#: within SP_BF16_RTOL
SEQ_OPT_LAYERS, SEQ_OPT_SEQ = 2, 2048
#: their fp32 agreements at sp SP, SP_AGREE_STEPS AdamW steps with
#: clipping on one batch, against one process: train_tp_ladder_agree's
#: narrow BERT and an OPT of its widths (2 layers of 512, 8 heads of 64,
#: flash); the losses and grad norms within SEQ_AGREE_RTOL.  Ulysses runs
#: the same per-head attention and every other op per token, but cuBLAS
#: may round a chunk's products otherwise than the whole rows' (and a ReLU
#: pre-activation within rounding of 0 then takes the other branch:
#: ``OPT_AGREE_RTOL``'s note); the bound is train_sp_agree's ring's
SEQ_AGREE_KINDS = ("bert", "opt")
SEQ_AGREE_RTOL = 1e-4
#: train_moe_ep_sp / train_moe_ep_tp (train_tp_sp's launch, after its
#: runs): Mixtral-8x7B widths at MOE_MESH_LAYERS of 32, bf16 on fp32
#: masters, flash, remat, SP_TILES loss tiles, the dispatch kernels, ZeRO
#: stage MOE_MESH_STAGE (the non-expert leaves' moments and gradients cut
#: over the expert axis's two data-parallel ranks), MOE_MESH_STEPS steps
#: on one [1, MOE_MESH_SEQ] row a data coordinate (the expert axis's two:
#: a global [2, MOE_MESH_SEQ] batch routed together): at ep 2 x sp 2 (a
#: rank's 4 experts and its chunk of its row) and at ep 2 x tp 2 (a
#: rank's 4 experts by half their FFN columns); each run's engine freed
#: before the next; the first step held against one process on the same
#: batch within SP_BF16_RTOL.  The four ranks share card 0: at ep 2 x sp
#: 2 a rank holds 1,008,775,168 parameters (16.1 GB of fp32 state at
#: stage 0, 14.3 GB at stage 2), and a [1, 8192] row a coordinate would
#: add ~5.5 GB a rank of transients (the global capacity's [E, C, H]
#: buffers, the expert products and the experts' bf16 casts): ~80 GB for
#: the four with their contexts; a [1, 2048] row adds ~3.7 GB.  Fused
#: Adam updates the 14.3 GB in place (the plain step's ``_foreach``
#: temporaries would hold a leaf group's size again), and the gradients
#: are all-reduced in flat buckets of MOE_MESH_BUCKET elements (the
#: default 500 M: a 1.75 GiB copy of the experts' gradients ran one rank
#: out of memory at the first sum over ``seq``, my chip call 1, PR 19)
MOE_MESH_LAYERS, MOE_MESH_STEPS, MOE_MESH_BUCKET = 1, 2, 50_000_000
MOE_MESH_SEQ, MOE_MESH_STAGE = 2048, 2
MOE_MESH_RUNS = {"ep2_sp2": dict(ep=2, sp=2), "ep2_tp2": dict(ep=2, tp=2)}
#: their fp32 agreements: AGREE_TRAIN's widths with 4 experts, top-2, one
#: [1, SP_AGREE_SEQ] row a data coordinate, SP_AGREE_STEPS steps, at each
#: layout against one process: the first step within TP_AGREE_RTOL, every
#: step within TP_SP_AGREE_RTOL
MOE_MESH_AGREE = dict(AGREE_TRAIN, num_experts=4, top_k=2)


def seq_model(kind: str, seed: int, dev, agree: bool = False):
    """A ladder model for the seq bodies: train_bert_tp's BERT-large or
    OPT-1.3B widths (bf16), or with ``agree`` the fp32 agreement ones."""
    from deepspeed_tpu_torch import OPTConfig, OPTModel, BertModel

    if agree:
        if kind == "bert":
            return ladder_agree_model("bert", seed, dev)
        f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
        return OPTModel(OPTConfig.tiny(
            num_layers=2, hidden_size=512, num_heads=8, ffn_dim=1024,
            max_seq_len=256, attn_impl="flash", **f32), device=dev,
            seed=seed + 5)
    if kind == "bert":
        return BertModel(bert_config(num_layers=BERT_TP_LAYERS), device=dev,
                         seed=seed)
    return OPTModel(OPTConfig.opt_1_3b(
        num_layers=SEQ_OPT_LAYERS, dtype=torch.bfloat16,
        param_dtype=torch.float32, attn_impl="flash"), device=dev,
        seed=seed)


def seq_batch(kind: str, seed: int, dev, vocab: int,
              agree: bool = False) -> dict:
    """A seq body's batch: train_bert_tp's (train_bert's ``[8, 512]``),
    OPT's one row, or the agreement models' (train_tp_ladder_agree's)."""
    if agree:
        b = ladder_agree_batch(kind, seed, dev)
        if kind == "opt":  # the narrow OPT's vocabulary
            b["input_ids"] = b["input_ids"] % vocab
        return b
    if kind == "bert":
        return bert_batch(vocab, BERT_BATCH, seed + 1, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    return {"input_ids": torch.randint(0, vocab, (1, SEQ_OPT_SEQ),
                                       generator=gen, device=dev)}


def seq_model_run(kind: str, seed: int, dev, sp: int,
                  agree: bool = False) -> dict:
    """A ladder model through ``initialize`` at sp ``sp`` on its batch
    (every rank the whole rows): the steps' metrics and launches, state
    bytes and peak memory."""
    from deepspeed_tpu_torch import initialize

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = seq_model(kind, seed, dev, agree)
    batch = seq_batch(kind, seed, dev, model.config.vocab_size, agree)
    rows = next(iter(batch.values())).shape[0]
    conf = dict(ds_config(model, rows), sequence_parallel={"sp_size": sp})
    if agree:
        conf.update(gradient_clipping=1.0, optimizer={
            "type": "AdamW", "params": {"lr": 1e-3}})
    engine = initialize(model=model, config=conf, device=dev)[0]
    setup_s = time.perf_counter() - t0
    out = dict(sp_steps(engine, batch, SP_AGREE_STEPS if agree
                        else TP_STEPS), setup_s=setup_s,
               sp_rank=engine.sp_rank, heads=model.num_local_heads,
               state_bytes=zero_state_bytes(engine),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seq_models_rank(rank: int, seed: int) -> dict:
    """One rank of train_bert_sp / train_opt_sp and their fp32
    agreements (train_sp's launch)."""
    dev = zero_rank_setup()
    out = {kind: seq_model_run(kind, seed, dev, SP)
           for kind in ("bert", "opt")}
    out["agree"] = {kind: seq_model_run(kind, seed, dev, SP, agree=True)
                    for kind in SEQ_AGREE_KINDS}
    return out


def check_seq_models(got: dict, one_bert: dict) -> dict:
    """train_bert_sp, train_opt_sp and train_seq_models_agree from train_sp's
    launch: finite, falling losses equal on both ranks, the flash launches
    of the formula and 12 L all-to-alls a step; the first step within
    ``SP_BF16_RTOL`` of one process (BERT: train_bert_tp's run); the fp32
    runs within ``SEQ_AGREE_RTOL`` of theirs."""
    ranks = [r["seq_models"] for r in got["ranks"]]
    one = {"bert": one_bert, "opt": got["one_opt"]}
    out = {}
    for kind in ("bert", "opt"):
        base = ranks[0][kind]
        layers = BERT_TP_LAYERS if kind == "bert" else SEQ_OPT_LAYERS
        for r, res in enumerate(ranks):
            t = res[kind]
            what = f"train_{kind}_sp rank {r}"
            require(all(np.isfinite(t["loss"])) and
                    t["loss"][-1] < t["loss"][0], f"{what}: {t['loss']}")
            require(t["loss"] == base["loss"] and
                    t["grad_norm"] == base["grad_norm"],
                    f"{what}: metrics differ from rank 0's")
            require_sp_launches(what, t, "flash", layers, TP_STEPS, SP)
        rel = {}
        for what, tol in zip(("loss", "grad_norm"), SP_BF16_RTOL):
            rel[what] = e = _max_rel(base[what][:1], one[kind][what][:1])
            require(e <= tol, f"train_{kind}_sp: sp {SP}'s first {what} "
                              f"{base[what][0]} != one process's "
                              f"{one[kind][what][0]} (rel {e} > {tol})")
        out[kind] = dict(
            layers=layers, sp=SP, steps=TP_STEPS, dtype="bfloat16",
            attn_impl="flash", remat=True,
            heads_per_rank_in_attention=base["heads"] // SP,
            ranks=list(r[kind] for r in ranks),
            one_process={k: one[kind][k] for k in ("loss", "grad_norm")},
            rel_first_step_to_one_process=rel,
            tolerance=dict(zip(("loss", "grad_norm"), SP_BF16_RTOL)),
            host_step_ms=statistics.median(base["host_step_ms"][1:]))
    agree = {}
    for kind in SEQ_AGREE_KINDS:
        run = ranks[0]["agree"][kind]
        require(all(r["agree"][kind]["loss"] == run["loss"] for r in ranks),
                f"train_seq_models_agree {kind}: the ranks' losses differ")
        require_sp_launches(f"train_seq_models_agree {kind}", run, "flash",
                            2, SP_AGREE_STEPS, SP)
        ref = got["one_agree"][kind]
        rel = {w: _max_rel(run[w], ref[w]) for w in ("loss", "grad_norm")}
        for w, e in rel.items():
            require(e <= SEQ_AGREE_RTOL,
                    f"train_seq_models_agree {kind}: {w} {run[w]} != one "
                    f"process's {ref[w]} (rel {e} > {SEQ_AGREE_RTOL})")
        agree[kind] = dict(sp2={k: run[k] for k in ("loss", "grad_norm")},
                           one_process={k: ref[k] for k in ("loss",
                                                            "grad_norm")},
                           max_rel=rel)
    out["agree"] = dict(models={
        "bert": "BertConfig.tiny at 2 x 512, 8 heads of 64, flash",
        "opt": "OPTConfig.tiny at 2 x 512, 8 heads of 64, flash"},
        sp=SP, steps=SP_AGREE_STEPS, dtype="float32",
        tolerance=SEQ_AGREE_RTOL, runs=agree)
    return out


def emit_seq_models(out: dict) -> None:
    reduced = ["cards 2 -> 1, NCCL -> gloo through the host",
               f"steps -> {TP_STEPS} (the script's length)"]
    for kind, model, layers in (("bert", "bert_large", BERT_TP_LAYERS),
                                ("opt", "opt_1_3b", SEQ_OPT_LAYERS)):
        emit(dict(phase=f"train_{kind}_sp", model=model,
                  reduced=[f"num_layers 24 -> {layers}"] + reduced,
                  comm=SP_NOTE, card=nvidia_smi_line(), **out[kind]))
    emit(dict(phase="train_seq_models_agree", reduced=reduced[:1],
              comm=SP_NOTE, **out["agree"]))


def moe_mesh_config(agree: bool):
    from deepspeed_tpu_torch import MixtralConfig
    if agree:
        return MixtralConfig(**MOE_MESH_AGREE)
    return MixtralConfig.mixtral_8x7b(
        num_layers=MOE_MESH_LAYERS, dtype=torch.bfloat16,
        param_dtype=torch.float32, attn_impl="flash", loss_tiles=SP_TILES)


def moe_mesh_ids(seed: int, vocab: int, seq: int, dev) -> torch.Tensor:
    """The global batch: one row a data coordinate of the expert axis."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    return torch.randint(0, vocab, (2, seq), generator=gen, device=dev)


def moe_mesh_run(seed: int, dev, agree: bool, ep: int = 1, sp: int = 1,
                 tp: int = 1) -> dict:
    """A Mixtral through ``initialize`` at ``ep x sp x tp`` (one process
    at 1 x 1 x 1: both rows), built on the mesh from the seed (a rank's
    experts and columns are slices of the one-process model), its data
    coordinate's row: the steps' metrics and launches, the rung, state
    bytes, the experts a rank holds and its peak memory."""
    from deepspeed_tpu_torch import MixtralModel, comm, initialize
    from deepspeed_tpu_torch.parallel import MeshLayout
    from deepspeed_tpu_torch.utils import groups

    cfg = moe_mesh_config(agree)
    world = ep * sp * tp
    mesh = (groups.initialize_mesh(MeshLayout.infer(world, ep=ep, sp=sp,
                                                    tp=tp))
            if world > 1 else None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MixtralModel(cfg, device=dev, seed=seed + (4 if agree else 0),
                         mesh=mesh)
    conf = dict(ds_config(model, 2 // ep, fused_adam=not agree,
                          stage=0 if agree or ep == 1 else MOE_MESH_STAGE),
                moe={"expert_parallel_size": ep},
                sequence_parallel={"sp_size": sp},
                tensor_parallel={"autotp_size": tp})
    if not agree:
        conf["zero_optimization"]["reduce_bucket_size"] = MOE_MESH_BUCKET
    if agree:
        conf["optimizer"] = {"type": "AdamW", "params": {"lr": 1e-3}}
    engine = initialize(model=model, config=conf, device=dev, mesh=mesh)[0]
    setup_s = time.perf_counter() - t0
    ids = moe_mesh_ids(seed, cfg.vocab_size,
                       SP_AGREE_SEQ if agree else MOE_MESH_SEQ, dev)
    q = comm.get_rank(engine.dp_group) if engine.dp_world_size > 1 else 0
    rows = ids[q * 2 // ep:(q + 1) * 2 // ep]
    run = sp_steps(engine, rows, SP_AGREE_STEPS if agree
                   else MOE_MESH_STEPS)
    layer = model._moe_layer
    out = dict(run, setup_s=setup_s, rung=layer.last_impl,
               capacity=layer.last_capacity,
               kept_share=float(layer.last_routing.keep.float().mean())
               if layer.last_routing is not None else None,
               coords={a: mesh.axis_rank(a) for a in ("expert", "seq",
                                                      "tensor")}
               if mesh is not None else None,
               experts=tuple(model.layers[0].w_gate.shape),
               params=sum(p.numel() for p in engine.params),
               state_bytes=zero_state_bytes(engine),
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    del model, engine, layer
    gc.collect()
    torch.cuda.empty_cache()
    groups.reset_mesh()
    return out


def moe_mesh_rank(rank: int, seed: int, dev) -> dict:
    """train_moe_ep_sp, train_moe_ep_tp and their fp32 agreements on one
    rank of train_tp_sp's launch."""
    out = {label: moe_mesh_run(seed, dev, False, **lay)
           for label, lay in MOE_MESH_RUNS.items()}
    out["agree"] = {label: moe_mesh_run(seed, dev, True, **lay)
                    for label, lay in MOE_MESH_RUNS.items()}
    return out


def moe_mesh_one_process(seed: int, dev) -> dict:
    """The one-process references of train_tp_sp's Mixtral bodies: the
    first step at Mixtral-8x7B widths on the global batch, and the fp32
    agreement model's steps."""
    one = moe_mesh_run(seed, dev, False)
    free_host_cache()
    return {"train": one, "agree": moe_mesh_run(seed, dev, True)}


def check_moe_mesh(ranks: list, one: dict) -> dict:
    """train_moe_ep_sp, train_moe_ep_tp and train_moe_mesh_agree: per run,
    each rank at its coordinates with its 4 experts (by half their columns
    at tp 2), finite losses equal on the four, the flash and dispatch
    launches of the formula (remat: dispatch and combine twice a layer a
    step, on the kernel rung; the bf16 runs' Σg² and Adam kernels once a
    step) and under ``seq`` 12 L all-to-alls a step,
    the first step within ``SP_BF16_RTOL`` of one process; the fp32 runs
    within ``TP_AGREE_RTOL`` (first step) and ``TP_SP_AGREE_RTOL`` of
    theirs."""
    cfg = moe_mesh_config(False)
    out = {}
    for agree in (False, True):
        for label, lay in MOE_MESH_RUNS.items():
            sp, tp = lay.get("sp", 1), lay.get("tp", 1)
            runs = [r["moe_mesh"]["agree"][label] if agree
                    else r["moe_mesh"][label] for r in ranks]
            ref = one["agree" if agree else "train"]
            base = runs[0]
            name = f"train_moe_mesh_agree {label}" if agree else \
                f"train_moe_{label.replace('2', '')}"
            coords = sorted(tuple(x["coords"][a] for a in ("expert", "seq",
                                                          "tensor"))
                            for x in runs)
            require(coords == sorted((e, s, t) for e in range(2)
                                     for s in range(sp) for t in range(tp)),
                    f"{name}: coordinates {coords}")
            E = (MOE_MESH_AGREE["num_experts"] if agree
                 else cfg.num_experts)
            I = (MOE_MESH_AGREE["intermediate_size"] if agree
                 else cfg.intermediate_size)
            for r, x in enumerate(runs):
                what = f"{name} rank {r}"
                require(all(np.isfinite(x["loss"])), f"{what}: {x['loss']}")
                require(x["loss"] == base["loss"] and
                        x["grad_norm"] == base["grad_norm"],
                        f"{what}: metrics differ from rank 0's")
                require(x["experts"][0] == E // 2 and
                        x["experts"][2] == I // tp,
                        f"{what}: expert stack {x['experts']}")
                require(x["rung"] == "pallas", f"{what}: rung {x['rung']}")
                layers = (MOE_MESH_AGREE["num_layers"] if agree
                          else MOE_MESH_LAYERS)
                steps = SP_AGREE_STEPS if agree else MOE_MESH_STEPS
                require_train_launches(what, dict(
                    layers=layers, steps=steps, remat=True,
                    fused_adam=not agree, launches=x["launches"]), moe=True)
                want = steps * layers * SP_A2A_PER_LAYER_STEP if sp > 1 \
                    else 0
                require(x["all_to_all"] == want,
                        f"{what}: {x['all_to_all']} all-to-alls, want {want}")
            if agree:
                rel = {}
                for w in ("loss", "grad_norm"):
                    for key, n, tol in (("first", 1, TP_AGREE_RTOL),
                                        ("all", SP_AGREE_STEPS,
                                         TP_SP_AGREE_RTOL)):
                        rel[f"{w}_{key}"] = e = _max_rel(base[w][:n],
                                                         ref[w][:n])
                        require(e <= tol, f"{name}: {w} {base[w]} != one "
                                          f"process's {ref[w]} ({key}: rel "
                                          f"{e} > {tol})")
                out.setdefault("agree", {})[label] = dict(
                    mesh={k: base[k] for k in ("loss", "grad_norm")},
                    one_process={k: ref[k] for k in ("loss", "grad_norm")},
                    max_rel=rel)
                continue
            rel = {}
            for w, tol in zip(("loss", "grad_norm"), SP_BF16_RTOL):
                rel[w] = e = _max_rel(base[w][:1], ref[w][:1])
                require(e <= tol, f"{name}: first {w} {base[w][0]} != one "
                                  f"process's {ref[w][0]} (rel {e} > {tol})")
            out[label] = dict(
                layers=MOE_MESH_LAYERS, **lay, global_batch=[2, MOE_MESH_SEQ],
                steps=MOE_MESH_STEPS, dtype="bfloat16", attn_impl="flash",
                loss_tiles=SP_TILES, remat=True, rung=base["rung"],
                capacity=base["capacity"],
                experts_a_rank=list(base["experts"]),
                ranks=[{k: v for k, v in x.items()} for x in runs],
                one_process={k: ref[k] for k in (
                    "loss", "grad_norm", "params", "state_bytes",
                    "peak_mem_bytes")},
                rel_first_step_to_one_process=rel,
                tolerance=dict(zip(("loss", "grad_norm"), SP_BF16_RTOL)),
                host_step_ms=statistics.median(base["host_step_ms"][1:]),
                peak_mem_bytes_sum=sum(x["peak_mem_bytes"] for x in runs))
    out["agree"] = dict(model=dict((k, v) for k, v in MOE_MESH_AGREE.items()
                                   if k not in ("dtype", "param_dtype")),
                        global_batch=[2, SP_AGREE_SEQ], steps=SP_AGREE_STEPS,
                        dtype="float32", runs=out["agree"],
                        tolerance=dict(first=TP_AGREE_RTOL,
                                       all=TP_SP_AGREE_RTOL))
    return out


def emit_moe_mesh(out: dict) -> None:
    reduced = ["cards 4 -> 1, NCCL -> gloo through the host",
               f"num_layers 32 -> {MOE_MESH_LAYERS}"]
    for label in MOE_MESH_RUNS:
        emit(dict(phase=f"train_moe_{label.replace('2', '')}",
                  model="mixtral_8x7b", reduced=reduced, comm=TP_SP_NOTE,
                  card=nvidia_smi_line(), **out[label]))
    emit(dict(phase="train_moe_mesh_agree", reduced=reduced[:1],
              comm=TP_SP_NOTE, **out["agree"]))


def nvidia_smi_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    return proc.stdout.strip()


#: Mixtral-8x7B serving keeps 24 of its 32 layers (93.4 GB of bf16
#: weights at 32, 70.2 GB at 24 on an 80 GB card); training keeps 2 (fp32
#: masters, gradients and both moments: 16 bytes a parameter, 50.6 GB)
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 24, 2, 5


def run_serving(model, name: str, seed: int, reduced: list,
                phases: Optional[tuple] = None) -> tuple:
    """The ``serve`` and ``generate`` phases of one model (and their
    launch checks), printed under ``phases`` (default: ``serve`` /
    ``generate``, ``serve_moe`` / ``generate_moe`` for a Mixtral); returns
    (serve, generate) results."""
    from deepspeed_tpu_torch import KVCacheConfig

    cfg = model.config
    moe = hasattr(cfg, "num_experts")
    if phases is None:
        phases = ("serve_moe", "generate_moe") if moe else ("serve",
                                                            "generate")
    rng = np.random.default_rng(seed)
    s = serve(model, rng, cache_config=KVCacheConfig(
        num_blocks=1025, block_size=16, max_seq_len=2048),
        header_len=512, requests=SERVE_REQUESTS, max_batch_slots=8,
        prefill_chunk=256, prefill_batch=2, decode_burst=8)
    L, la = cfg.num_layers, s["launches"]
    require(la["paged_decode_attention"] == L * s["decode_steps"],
            f"serve ({name}): paged kernel launched "
            f"{la['paged_decode_attention']} times, want {L} x "
            f"{s['decode_steps']} decode steps")
    require(la["decode_attention"] == 0,
            f"serve ({name}): the padded-cache kernel ran on the paged path")
    for kernel in MOE_KERNELS:  # prefill calls only: decode is dense
        want = L * s["prefill_calls"] if moe else 0
        require(la[kernel] == want, f"serve ({name}): {kernel} launched "
                                    f"{la[kernel]} times, want {want}")
    emit(dict(phase=phases[0], model=name, layers=L,
              hidden=cfg.hidden_size, params=cfg.num_params(),
              dtype="bfloat16", reduced=reduced,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              **without_tokens(s)))

    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (V1_BATCH, V1_PROMPT)))
    g = generate_v1(model, ids, V1_NEW)
    la = g["launches"]
    want = L * (V1_NEW - 1)
    require(la["decode_attention"] == want,
            f"generate ({name}): decode kernel launched "
            f"{la['decode_attention']} times, want {want}")
    require(la["paged_decode_attention"] == 0,
            f"generate ({name}): the paged kernel ran on the padded-cache "
            "path")
    for kernel in MOE_KERNELS:  # the one prefill; decode (T 4) is dense
        want = L if moe else 0
        require(la[kernel] == want, f"generate ({name}): {kernel} launched "
                                    f"{la[kernel]} times, want {want}")
    emit(dict(phase=phases[1], model=name, **without_tokens(g)))
    return s, g


def without_tokens(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "tokens"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run alone (build, "
                         "kernels, flash_kernels, moe_kernels, adam_kernels, "
                         "sparse_kernels, quant_kernels, tp_kernels, serve, "
                         "agree, serve_moe, agree_moe, train, "
                         "train_8b_width, train_moe, train_agree, sparse, "
                         "serve_tp, generate_tp, agree_tp, "
                         "train_zero, train_zero_agree, "
                         "train_ckpt, train_moe_ep, train_moe_ep_agree, "
                         "serve_moe_tp, generate_moe_tp, agree_moe_tp, "
                         "train_bert, train_bert_zero, "
                         "train_resnet, serve_opt, generate_opt (one run "
                         "gives both), agree_opt, train_infinity, "
                         "train_infinity_nvme, train_infinity_agree, "
                         "train_offload, train_sp, train_sp_agree, "
                         "train_infinity_sp, train_infinity_sp_agree, "
                         "train_tp, train_tp_agree, "
                         "train_tp_hybrid, train_infinity_tp, "
                         "train_infinity_tp_agree, train_bert_tp, "
                         "train_tp_ladder_agree (train_sp and train_moe "
                         "first when they are not named), train_tp_sp, "
                         "train_tp_sp_agree, train_moe_ep_sp, "
                         "train_moe_ep_tp, train_moe_mesh_agree, "
                         "train_bert_sp, train_opt_sp, "
                         "train_seq_models_agree, train_zeropp, "
                         "train_zeropp_agree, train_hpz; the phases of one "
                         "rank launch run together: serve_tp's and "
                         "serve_moe_tp's; train_zero's, train_ckpt's ZeRO "
                         "part, train_moe_ep's, train_bert_zero's and "
                         "train_zeropp's; train_sp's, train_tp's, "
                         "train_bert_sp's and train_opt_sp's; train_tp_sp's, "
                         "the train_moe_ep_* ones and train_hpz)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU path "
              "only", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch import (LlamaConfig, LlamaModel, MixtralConfig,
                                     MixtralModel)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    res = {}

    def kernels():
        res["timing"] = phase_kernels(dev)
        for name, row in res["timing"].items():  # one line per kernel
            emit(dict(phase="kernels", kernel=name, **row))

    def flash_kernels():
        res["flash"] = phase_flash_kernels(dev)
        for name, row in res["flash"].items():
            emit(dict(phase="kernels", kernel=name, **row))

    def moe_kernels():
        res["moe"] = phase_moe_kernels(dev)
        for name, row in res["moe"].items():
            emit(dict(phase="kernels", kernel=name, **row))

    def adam_kernels():
        cfg = MixtralConfig.mixtral_8x7b(num_layers=MOE_TRAIN_LAYERS)
        res["adam"] = phase_adam_kernels(dev, mixtral_train_shapes(cfg),
                                         args.seed)
        for name, row in res["adam"].items():
            emit(dict(phase="kernels", kernel=name, **row))

    def sparse_kernels():
        res["sparse_kernels"] = phase_sparse_kernels(dev)
        for name, row in res["sparse_kernels"].items():
            emit(dict(phase="kernels", kernel=name, **row))

    def quant_kernels():
        res["quant"] = phase_quant_kernels(dev, args.seed)
        emit(dict(phase="kernels", kernel="quantize_int8", **res["quant"]))

    def tp_kernels():
        res["tp_kernels"] = phase_tp_kernels(dev)
        for name, row in res["tp_kernels"].items():
            emit(dict(phase="kernels", kernel=name, **row))

    def serving_tp():
        out = phase_serving_tp(dev, args.seed)
        ranks = out["ranks"]
        res["serve_tp"] = ranks[0]["serve"]
        res["serving_tp"] = ranks[0]
        for key, phase, model, layers, full in (
                ("serve", "serve_tp", "llama3_8b", SERVE_TP_LAYERS, 32),
                ("generate", "generate_tp", "llama3_8b", SERVE_TP_LAYERS,
                 32),
                ("serve_opt", "serve_opt_tp", OPT_NAME, OPT_TP_LAYERS, 24),
                ("generate_opt", "generate_opt_tp", OPT_NAME, OPT_TP_LAYERS,
                 24)):
            emit(dict(phase=phase, model=model, layers=layers,
                      tp=TP, dtype="bfloat16", reduced=[
                          f"num_layers {full} -> {layers}",
                          "cards 2 -> 1, NCCL -> gloo through the host"],
                      comm=TP_NOTE,
                      ranks_tokens_equal=True,
                      launch_wall_s=out["launch_wall_s"],
                      **{f"rank{r}": without_tokens(x[key])
                         for r, x in enumerate(ranks)}))
        emit(dict(phase="agree_tp", **out["agree"]))

    def train_zero():
        out = phase_train_zero(dev, args.seed)
        for label, stage, fused in ZERO_RUNS:  # one line per run
            emit(dict(phase="train_zero", run=label, stage=stage,
                      fused_adam=fused, model="bench.py headline",
                      ranks=ZERO_RANKS, global_batch=[TRAIN_BATCH, TRAIN_SEQ],
                      reduced=[f"num_layers 12 -> {ZERO_LAYERS} (the "
                               "script's length)",
                               "cards 2 -> 1, NCCL -> gloo through the host",
                               "steps 4 -> 2 (the script's length)"],
                      comm=ZERO_NOTE,
                      loss_rel_to_stage0=out["loss_rel_to_stage0"][label],
                      **{f"rank{r}": x[label]
                         for r, x in enumerate(out["ranks"])}))
        emit(dict(phase="train_zero", run=ZERO_OFFLOAD_RUN,
                  stage=ZERO_OFFLOAD_STAGE, offload_optimizer="cpu",
                  model="bench.py headline", ranks=ZERO_RANKS,
                  global_batch=[TRAIN_BATCH, TRAIN_SEQ],
                  reduced=[f"num_layers 12 -> {ZERO_LAYERS} (the script's "
                           "length)",
                           "cards 2 -> 1, NCCL -> gloo through the host",
                           "steps 4 -> 2 (the script's length)"],
                  comm=ZERO_NOTE,
                  one_process_loss=out["offload_one_process_loss"],
                  rel_to_one_process=out["offload_rel_to_one_process"],
                  **{f"rank{r}": x[ZERO_OFFLOAD_RUN]
                     for r, x in enumerate(out["ranks"])}))
        emit(dict(phase="train_zero", run=ZERO_INF_RUN,
                  offload_param="cpu", model="AGREE_TRAIN widths",
                  dtype="float32", ranks=ZERO_RANKS, path="stash",
                  clip=ZERO_INF_CLIP, steps=ZERO_INF_STEPS,
                  global_batch=[ZERO_RANKS, AGREE_TRAIN["max_seq_len"]],
                  reduced=["cards 2 -> 1, NCCL -> gloo through the host"],
                  comm=ZERO_NOTE, one_process=out["infinity_one_process"],
                  rel_to_one_process=out["infinity_rel_to_one_process"],
                  tolerance=INF_AGREE_RTOL,
                  **{f"rank{r}": x[ZERO_INF_RUN]
                     for r, x in enumerate(out["ranks"])}))
        emit(dict(phase="train_zero", launch_wall_s=out["launch_wall_s"],
                  peak_mem_bytes_rank0=out["peak_mem_bytes_rank0"]))
        emit(dict(phase="train_zero_agree", model="bench.py headline width",
                  reduced=[f"num_layers 12 -> {ZERO_AGREE_LAYERS}",
                           "cards 2 -> 1, NCCL -> gloo through the host"],
                  comm=ZERO_NOTE, **out["agree"]))

    def train_zeropp():
        res["train_zeropp"] = out = phase_train_zeropp(dev, args.seed)
        emit_zeropp("train_zeropp", out, ZEROPP_RUNS, ZERO_RANKS,
                    loss_rel_to_exact=out["loss_rel_to_exact"],
                    tolerance=ZEROPP_RTOL, wire_exact=out["wire_exact"],
                    wire_quantized=out["wire_quantized"],
                    quantizer=out["quantizer"])
        emit(dict(phase="train_zeropp_agree", model="AGREE_TRAIN widths",
                  dtype="float32", reduced=[
                      "cards 2 -> 1, NCCL -> gloo through the host"],
                  comm=ZEROPP_NOTE, **out["agree"]))

    def serving_moe_tp():
        out = phase_serving_moe_tp(dev, args.seed)
        ranks = out["ranks"]
        res["serve_moe_tp"] = ranks[0]
        for key, phase in (("serve", "serve_moe_tp"),
                           ("generate", "generate_moe_tp")):
            emit(dict(phase=phase, model="mixtral_8x7b",
                      layers=MOE_TP_LAYERS, tp=TP, dtype="bfloat16",
                      reduced=[f"num_layers 32 -> {MOE_TP_LAYERS}",
                               "cards 2 -> 1, NCCL -> gloo through the "
                               "host"], comm=TP_NOTE, ranks_tokens_equal=True,
                      launch_wall_s=out["launch_wall_s"],
                      card=nvidia_smi_line(),
                      **{f"rank{r}": without_tokens(x[key])
                         for r, x in enumerate(ranks)}))
        emit(dict(phase="agree_moe_tp", card=nvidia_smi_line(),
                  **out["agree"]))

    def train_moe_ep():
        out = phase_train_moe_ep(dev, args.seed)
        agree = out.pop("agree")
        res["train_moe_ep"] = out["ranks"][0]
        emit(dict(phase="train_moe_ep", model="mixtral_8x7b", ep=MOE_EP,
                  global_batch=[MOE_EP, TRAIN_SEQ], dtype="bfloat16",
                  fused_adam=True, reduced=[
                      f"num_layers 32 -> {MOE_EP_LAYERS} (2 -> 1 for the "
                      "script's length)",
                      "cards 2 -> 1, NCCL -> gloo through the host",
                      f"steps 4 -> {MOE_EP_STEPS} (the script's length)"],
                  comm=MOE_EP_NOTE, card=nvidia_smi_line(), **out))
        emit(dict(phase="train_moe_ep_agree", model="mixtral_8x7b widths",
                  dtype="float32", reduced=[
                      f"num_layers 32 -> {MOE_AGREE_LAYERS}",
                      "cards 2 -> 1, NCCL -> gloo through the host",
                      "checkpoint: the narrow fp32 Mixtral"],
                  comm=MOE_EP_NOTE, card=nvidia_smi_line(), **agree))

    def sparse():
        rows, res["sparse"] = phase_sparse(dev)
        for row in rows:  # one line per case
            emit(dict(phase="sparse", dtype="bfloat16", **row))
        emit(dict(phase="sparse", launches=res["sparse"], reduced=[
            "timed calls a rep 30 / 10 / 3 -> 15 / 5 / 2 at S <= 4096 / "
            "8192 / above (the script's length)"]))

    def serving(moe: bool):
        cfg = (MixtralConfig.mixtral_8x7b(num_layers=MOE_SERVE_LAYERS)
               if moe else LlamaConfig.llama3_8b())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = (MixtralModel if moe else LlamaModel)(cfg, device=dev,
                                                      seed=args.seed)
        torch.cuda.synchronize()
        emit(dict(phase="init", model="mixtral_8x7b" if moe else "llama3_8b",
                  seconds=time.perf_counter() - t0))
        key = "serve_moe" if moe else "serve"
        res[key] = run_serving(
            model, "mixtral_8x7b" if moe else "llama3_8b", args.seed,
            [f"num_layers 32 -> {MOE_SERVE_LAYERS}"] if moe else [])
        if not moe:
            emit(dict(phase="serve_trace", model="llama3_8b",
                      **trace_decode(model)))
        del model
        torch.cuda.empty_cache()

    def training(name: str):
        t0 = time.perf_counter()
        if name == "train":  # bench.py's headline at full width and depth
            cfg = LlamaConfig(**HEADLINE, dtype=torch.bfloat16,
                              param_dtype=torch.float32, attn_impl="flash")
            steps, batch, reduced, label = TRAIN_STEPS, TRAIN_BATCH, [], \
                "bench.py headline"
        elif name == "train_8b_width":
            cfg = LlamaConfig.llama3_8b(
                num_layers=WIDE_LAYERS, dtype=torch.bfloat16,
                param_dtype=torch.float32, attn_impl="flash")
            steps, batch, label = WIDE_STEPS, WIDE_BATCH, "llama3_8b"
            reduced = [f"num_layers 32 -> {WIDE_LAYERS}"]
        else:
            cfg = MixtralConfig.mixtral_8x7b(
                num_layers=MOE_TRAIN_LAYERS, dtype=torch.bfloat16,
                param_dtype=torch.float32, attn_impl="flash")
            steps, batch, label = MOE_TRAIN_STEPS, 1, "mixtral_8x7b"
            reduced = [f"num_layers 32 -> {MOE_TRAIN_LAYERS}"]
        moe = name == "train_moe"
        model = (MixtralModel if moe else LlamaModel)(cfg, device=dev,
                                                      seed=args.seed)
        t = train(model, steps, batch, TRAIN_SEQ, args.seed, fused_adam=moe,
                  hybrid_new=HEADLINE_HYBRID_NEW if name == "train" else 0)
        require_train_launches(name, t, moe=moe)
        emit(dict(phase=name, model=label, reduced=reduced,
                  wall_s=time.perf_counter() - t0, **t))
        res[name] = t
        del model
        torch.cuda.empty_cache()

    def serving_opt():
        from deepspeed_tpu_torch import OPTConfig, OPTModel

        torch.cuda.reset_peak_memory_stats()
        model = OPTModel(OPTConfig.opt_1_3b(), device=dev, seed=args.seed)
        res["serve_opt"], res["generate_opt"] = run_serving(
            model, OPT_NAME, args.seed, [],
            phases=("serve_opt", "generate_opt"))
        del model
        torch.cuda.empty_cache()

    def train_infinity():
        from deepspeed_tpu_torch.launcher import launch
        from deepspeed_tpu_torch.ops import op_builder

        op_builder.build()
        free_host_cache()
        parent = meminfo()["MemAvailable"]
        res["train_infinity"] = t = launch(infinity_rank, 1, (args.seed,),
                                           timeout=900)[0]
        t["mem_available_in_parent"] = parent
        emit(dict(phase="train_infinity", model="llama3_70b",
                  reduced=[f"num_layers 80 -> {t['layers']} (4 -> 3 and "
                           f"steps 4 -> {INF_STEPS} for the script's "
                           "length)"],
                  offload_param="cpu", **t))

    def train_offload():
        if "train_8b_width" not in res:
            training("train_8b_width")
        res["train_offload"] = phase_train_offload(
            dev, args.seed, res["train_8b_width"]["peak_mem_gb"])
        emit(dict(phase="train_offload", model="llama3_8b",
                  reduced=[f"num_layers 32 -> {WIDE_LAYERS}",
                           "steps 4 -> 3 (the script's length)"],
                  offload_optimizer="cpu", card=nvidia_smi_line(),
                  **res["train_offload"]))

    def train_sp():
        out = phase_train_sp(dev, args.seed)
        res["train_sp"] = out["train"]["ranks"][0]
        res["train_sp_one"] = out["train"]["one_process"]
        res["train_infinity_sp"] = out["infinity"]["ranks"][0]
        emit_train_sp(out)

    def train_tp():
        if "train_sp_one" not in res:  # the one-process runs it holds to
            train_sp()
        if "train_moe" not in res:
            training("train_moe")
        res["train_tp"] = out = phase_train_tp(dev, args.seed, res)
        emit_train_tp(out)

    def train_tp_sp():
        res["train_tp_sp"] = out = phase_train_tp_sp(dev, args.seed)
        emit_train_tp_sp(out)

    def train_seq_models():  # in train_sp's launch
        got = shared_launch("sp_tp", lambda: sp_tp_launch(dev, args.seed))
        res["train_seq_models"] = out = check_seq_models(got,
                                                         got["one_bert"])
        emit_seq_models(out)

    def train_bert():
        res["train_bert"] = phase_train_bert(dev, args.seed)
        emit(dict(phase="train_bert", model="bert_large", reduced=[],
                  card=nvidia_smi_line(), **res["train_bert"]))

    def train_bert_zero():
        out = phase_train_bert_zero(dev, args.seed)
        for label, stage in BERT_ZERO_RUNS:  # one line per stage
            emit(dict(phase="train_bert_zero", run=label, stage=stage,
                      model="bert_large", ranks=ZERO_RANKS,
                      global_batch=[BERT_BATCH, BERT_SEQ], dtype="bfloat16",
                      reduced=[f"num_layers 24 -> {BERT_ZERO_LAYERS}",
                               "cards 2 -> 1, NCCL -> gloo through the "
                               "host", f"steps 4 -> {BERT_ZERO_STEPS} (the "
                               "script's length)"], comm=ZERO_NOTE,
                      loss_rel_to_stage0=out["loss_rel_to_stage0"][label],
                      **{f"rank{r}": x[label]
                         for r, x in enumerate(out["ranks"])}))
        emit(dict(phase="train_bert_zero",
                  launch_wall_s=out["launch_wall_s"]))

    phases = {
        "build": phase_build,
        "kernels": kernels, "flash_kernels": flash_kernels,
        "moe_kernels": moe_kernels, "adam_kernels": adam_kernels,
        "sparse_kernels": sparse_kernels, "quant_kernels": quant_kernels,
        "tp_kernels": tp_kernels,
        "serve": lambda: serving(False),
        "agree": lambda: emit(dict(phase="agree", **agree(dev, args.seed))),
        "serve_moe": lambda: serving(True),
        "agree_moe": lambda: emit(dict(phase="agree_moe",
                                       **agree(dev, args.seed, moe=True))),
        "train": lambda: training("train"),
        "train_8b_width": lambda: training("train_8b_width"),
        "train_moe": lambda: training("train_moe"),
        "train_agree": lambda: emit(dict(phase="train_agree",
                                         **train_agree(dev, args.seed))),
        "sparse": sparse, "serve_tp": serving_tp, "generate_tp": serving_tp,
        "agree_tp": serving_tp,
        "train_zero": train_zero, "train_zero_agree": train_zero,
        "train_zeropp": train_zeropp, "train_zeropp_agree": train_zeropp,
        "train_ckpt": lambda: emit(dict(
            phase="train_ckpt", model="bench.py headline", reduced=[
                "zero: cards 2 -> 1, NCCL -> gloo through the host"],
            card=nvidia_smi_line(), **phase_train_ckpt(dev, args.seed))),
        "train_moe_ep": train_moe_ep,
        "train_moe_ep_agree": train_moe_ep,
        "serve_moe_tp": serving_moe_tp, "generate_moe_tp": serving_moe_tp,
        "agree_moe_tp": serving_moe_tp,
        "train_bert": train_bert,
        "train_bert_zero": train_bert_zero,
        "train_resnet": lambda: emit(dict(
            phase="train_resnet", reduced=[], card=nvidia_smi_line(),
            **phase_train_resnet(dev, args.seed))),
        "serve_opt": serving_opt, "generate_opt": serving_opt,
        "agree_opt": lambda: emit(dict(
            phase="agree_opt", model="opt_1_3b widths", dtype="float32",
            reduced=[f"num_layers 24 -> {AGREE_OPT_LAYERS}"],
            **agree(dev, args.seed, opt=True))),
        "train_infinity_agree": lambda: emit(dict(
            phase="train_infinity_agree", model="llama3_8b",
            reduced=[f"num_layers 32 -> {INF_AGREE_LAYERS}"],
            **phase_train_infinity_agree(dev, args.seed))),
        "train_offload": train_offload,
        "train_infinity_nvme": lambda: emit(dict(
            phase="train_infinity_nvme", model="llama3_8b",
            reduced=[f"num_layers 32 -> {NVME_LAYERS} (4 -> 3 and steps "
                     "3 -> 2 a tier for the script's length)"],
            offload_param="nvme, then cpu", card=nvidia_smi_line(),
            **phase_train_infinity_nvme(dev, args.seed))),
        "train_infinity": train_infinity,
        "train_sp": train_sp, "train_sp_agree": train_sp,
        "train_infinity_sp": train_sp, "train_infinity_sp_agree": train_sp,
        "train_tp": train_tp, "train_tp_agree": train_tp,
        "train_tp_hybrid": train_tp, "train_infinity_tp": train_tp,
        "train_infinity_tp_agree": train_tp, "train_bert_tp": train_tp,
        "train_tp_ladder_agree": train_tp,
        "train_tp_sp": train_tp_sp, "train_tp_sp_agree": train_tp_sp,
        "train_moe_ep_sp": train_tp_sp, "train_moe_ep_tp": train_tp_sp,
        "train_moe_mesh_agree": train_tp_sp, "train_hpz": train_tp_sp,
        "train_bert_sp": train_seq_models, "train_opt_sp": train_seq_models,
        "train_seq_models_agree": train_seq_models}
    only = [p for p in args.only.split(",") if p]
    unknown = set(only) - set(phases)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    ran = set()
    seconds = {}
    try:
        for name, run in phases.items():
            if (not only or name in only) and run not in ran:
                ran.add(run)
                t_phase = time.perf_counter()
                run()
                seconds[name] = time.perf_counter() - t_phase
    finally:
        import shutil
        for d in _SHARED_DIRS:
            shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "timing", "seconds_by_phase": seconds,
          "shared_launches": {
              name: {"wall_s": got["wall"],
                     "rank0_seconds": got["ranks"][0]["seconds"]}
              for name, got in _SHARED_LAUNCHES.items()},
          "seconds": time.perf_counter() - t_start})
    if only:
        return 0

    decode_src = "deepspeed_tpu_torch/csrc/decode_attention.cu"
    # the main path (train) is bf16: the tensor-core kernels
    flash_src = "deepspeed_tpu_torch/csrc/flash_attention_mma.cu"
    moe_src = "deepspeed_tpu_torch/csrc/moe_dispatch.cu"
    adam_src = "deepspeed_tpu_torch/csrc/fused_adam.cu"
    # the sparse phase is bf16: the tensor-core kernels
    sparse_src = "deepspeed_tpu_torch/csrc/block_sparse_attention_mma.cu"
    quant_src = "deepspeed_tpu_torch/csrc/quantizer.cu"
    pallas = "deepspeed_tpu/ops/pallas/"
    (s, g), (sm, gm), t, tm = (res["serve"], res["serve_moe"], res["train"],
                               res["train_moe"])
    # the headline's flash rows also count OPT-1.3B's at sp 2 (causal, d
    # 64, S 2048: the headline's shape on 16 heads)
    timing, flash, moe, adam, bs = (res["timing"], res["flash"], res["moe"],
                                    res["adam"], res["sparse_kernels"])

    ep, smt = res["train_moe_ep"], res["serve_moe_tp"]
    tb, so, go = res["train_bert"], res["serve_opt"], res["generate_opt"]
    ti, tsp = res["train_infinity"], res["train_sp"]
    tisp = res["train_infinity_sp"]
    # the tensor-parallel training slice, rank 0's counts
    ttp = res["train_tp"]
    ttl, ttm = ttp["llama"]["ranks"][0], ttp["mixtral"]["ranks"][0]
    # train_tp's launch: streamed at tp 2 (the _sp shape: 16 heads, S
    # 8192), BERT-large at tp 2 (8 of its 16 heads); train_tp_sp's rank 0
    tti, ttb = ttp["infinity"]["ranks"][0], ttp["bert"]["ranks"][0]
    ttsp = res["train_tp_sp"]["train"]["ranks"][0]
    stp = res["serving_tp"]
    # the seq slice, rank 0's counts: BERT-large and OPT-1.3B at sp 2
    # (train_sp's launch), Mixtral at ep 2 x sp 2 and ep 2 x tp 2
    # (train_tp_sp's)
    tsm = res["train_seq_models"]
    tbs, tos = tsm["bert"]["ranks"][0], tsm["opt"]["ranks"][0]
    tmm = res["train_tp_sp"]["moe_mesh"]
    tmes, tmet = tmm["ep2_sp2"]["ranks"][0], tmm["ep2_tp2"]["ranks"][0]

    def moe_launches(kernel):  # every MoE main path (a rank's on EP, TP)
        return sum(x["launches"][kernel] for x in (
            sm, gm, tm, ep, smt["serve"], smt["generate"], ttm, tmes,
            tmet))

    # the ZeRO++ slice at Llama-3-8B widths (B 1, h 32, d 128, S 2048):
    # train_zeropp's and train_hpz's rank 0, every run
    zpp = ([res["train_zeropp"]["ranks"][0][label]
            for label, _, _ in ZEROPP_RUNS]
           + [res["train_tp_sp"]["hpz"]["ranks"][0][label]
              for label, _ in HPZ_RUNS])

    def zeropp_launches(kernel):
        return sum(x["launches"][kernel] for x in zpp)

    def hybrid_decode():  # the hybrid engine's generates (train, train_tp)
        return (t["hybrid"]["launches"]["decode_attention"]
                + ttp["hybrid"]["launches"]["decode_attention"])

    rows = {  # name: (source, TPU kernel, main-path launches, measured)
        "decode_attention": (decode_src, pallas + "decode_attention.py:98",
                             g["launches"]["decode_attention"]
                             + hybrid_decode(),
                             timing["decode_attention"]),
        "paged_decode_attention": (decode_src,
                                   pallas + "paged_attention.py:116",
                                   s["launches"]["paged_decode_attention"],
                                   timing["paged_decode_attention"]),
        # the same kernel on one rank's heads; launches per rank of
        # serve_tp and serve_moe_tp
        "paged_decode_attention_tp": (
            decode_src, pallas + "paged_attention.py:183",
            res["serve_tp"]["launches"]["paged_decode_attention_tp"]
            + smt["serve"]["launches"]["paged_decode_attention_tp"]
            + stp["serve_opt"]["launches"]["paged_decode_attention_tp"],
            res["tp_kernels"]["paged_decode_attention_tp"]),
        "flash_fwd": (flash_src, pallas + "flash_attention.py:260",
                      t["launches"]["flash_fwd"]
                      + tos["launches"]["flash_fwd"]
                      + zeropp_launches("flash_fwd"), flash["flash_fwd"]),
        "flash_bwd_dq": (flash_src, pallas + "flash_attention.py:453",
                         t["launches"]["flash_bwd_dq"]
                         + tos["launches"]["flash_bwd_dq"]
                         + zeropp_launches("flash_bwd_dq"),
                         flash["flash_bwd_dq"]),
        "flash_bwd_dkv": (flash_src, pallas + "flash_attention.py:472",
                          t["launches"]["flash_bwd_dkv"]
                          + tos["launches"]["flash_bwd_dkv"]
                          + zeropp_launches("flash_bwd_dkv"),
                          flash["flash_bwd_dkv"]),
        "moe_dispatch": (moe_src, pallas + "moe_dispatch.py:194",
                         moe_launches("moe_dispatch"), moe["moe_dispatch"]),
        # #11 at the expert-parallel pattern; launches: train_moe_ep's rank
        "moe_dispatch_ep": (moe_src, pallas + "moe_dispatch.py:194",
                            ep["launches"]["moe_dispatch"],
                            moe["moe_dispatch_ep"]),
        # #11 at the expert x seq pattern; launches: train_moe_ep_sp's rank
        "moe_dispatch_sp": (moe_src, pallas + "moe_dispatch.py:194",
                            tmes["launches"]["moe_dispatch"],
                            moe["moe_dispatch_sp"]),
        "moe_combine": (moe_src, pallas + "moe_dispatch.py:215",
                        moe_launches("moe_combine"), moe["moe_combine"]),
        "multi_tensor_sqsum": (adam_src, pallas + "fused_optimizer.py:91",
                               tm["launches"]["multi_tensor_sqsum"]
                               + ep["launches"]["multi_tensor_sqsum"]
                               + ttm["launches"]["multi_tensor_sqsum"]
                               + tmes["launches"]["multi_tensor_sqsum"]
                               + tmet["launches"]["multi_tensor_sqsum"]
                               + zeropp_launches("multi_tensor_sqsum"),
                               adam["multi_tensor_sqsum"]),
        "fused_adam": (adam_src, pallas + "fused_optimizer.py:158",
                       tm["launches"]["fused_adam"]
                       + ep["launches"]["fused_adam"]
                       + ttm["launches"]["fused_adam"]
                       + tmes["launches"]["fused_adam"]
                       + tmet["launches"]["fused_adam"]
                       + zeropp_launches("fused_adam"), adam["fused_adam"]),
        # the forward replaces the gather (:335) and resident (:523) forwards
        "block_sparse_fwd": (sparse_src,
                             pallas + "block_sparse_attention.py:335",
                             res["sparse"]["block_sparse_fwd"],
                             bs["block_sparse_fwd"]),
        "block_sparse_bwd_dq": (sparse_src,
                                pallas + "block_sparse_attention.py:990",
                                res["sparse"]["block_sparse_bwd_dq"],
                                bs["block_sparse_bwd_dq"]),
        "block_sparse_bwd_dkv": (sparse_src,
                                 pallas + "block_sparse_attention.py:1037",
                                 res["sparse"]["block_sparse_bwd_dkv"],
                                 bs["block_sparse_bwd_dkv"]),
        "quantize_int8": (quant_src, pallas + "quantizer.py:38",
                          res["quant"]["path"]["launches"]["quantize_int8"],
                          res["quant"]),
        # the ladder-model slice: the flash kernels at BERT-large's
        # non-causal, padded shape (launches: train_bert, and at h/tp and
        # h/sp: train_bert_tp's and train_bert_sp's rank), decode and paged
        # at OPT-1.3B's MHA d 64 (launches: generate_opt, serve_opt)
        "flash_fwd_bert": (flash_src, pallas + "flash_attention.py:260",
                           tb["launches"]["flash_fwd"]
                           + ttb["launches"]["flash_fwd"]
                           + tbs["launches"]["flash_fwd"],
                           flash["flash_fwd"]),
        "flash_bwd_dq_bert": (flash_src, pallas + "flash_attention.py:453",
                              tb["launches"]["flash_bwd_dq"]
                              + ttb["launches"]["flash_bwd_dq"]
                              + tbs["launches"]["flash_bwd_dq"],
                              flash["flash_bwd_dq"]),
        "flash_bwd_dkv_bert": (flash_src, pallas + "flash_attention.py:472",
                               tb["launches"]["flash_bwd_dkv"]
                               + ttb["launches"]["flash_bwd_dkv"]
                               + tbs["launches"]["flash_bwd_dkv"],
                               flash["flash_bwd_dkv"]),
        "decode_attention_opt": (decode_src, pallas + "decode_attention.py:98",
                                 go["launches"]["decode_attention"]
                                 + stp["generate_opt"]["launches"][
                                     "decode_attention"],
                                 timing["decode_attention_opt"]),
        "paged_decode_attention_opt": (
            decode_src, pallas + "paged_attention.py:116",
            so["launches"]["paged_decode_attention"],
            timing["paged_decode_attention_opt"]),
        # the offload and Infinity slice: the flash kernels at Llama-3-70B's
        # attention in each streamed layer (launches: train_infinity)
        "flash_fwd_70b": (flash_src, pallas + "flash_attention.py:260",
                          ti["launches"]["flash_fwd"], flash["flash_fwd"]),
        "flash_bwd_dq_70b": (flash_src, pallas + "flash_attention.py:453",
                             ti["launches"]["flash_bwd_dq"],
                             flash["flash_bwd_dq"]),
        "flash_bwd_dkv_70b": (flash_src, pallas + "flash_attention.py:472",
                              ti["launches"]["flash_bwd_dkv"],
                              flash["flash_bwd_dkv"]),
        # the sequence-parallel slice: the flash kernels at the Ulysses
        # shape, the full S 8192 on h/sp heads (launches: train_sp, a
        # rank); train_tp's Llama runs the same shape on h/tp heads, and
        # Mixtral's at ep 2 x sp 2 and ep 2 x tp 2 (train_moe_ep_sp's and
        # train_moe_ep_tp's rank)
        "flash_fwd_sp": (flash_src, pallas + "flash_attention.py:260",
                         tsp["launches"]["flash_fwd"]
                         + ttl["launches"]["flash_fwd"]
                         + tti["launches"]["flash_fwd"]
                         + tmes["launches"]["flash_fwd"]
                         + tmet["launches"]["flash_fwd"], flash["flash_fwd"]),
        "flash_bwd_dq_sp": (flash_src, pallas + "flash_attention.py:453",
                            tsp["launches"]["flash_bwd_dq"]
                            + ttl["launches"]["flash_bwd_dq"]
                            + tti["launches"]["flash_bwd_dq"]
                            + tmes["launches"]["flash_bwd_dq"]
                            + tmet["launches"]["flash_bwd_dq"],
                            flash["flash_bwd_dq"]),
        "flash_bwd_dkv_sp": (flash_src, pallas + "flash_attention.py:472",
                             tsp["launches"]["flash_bwd_dkv"]
                             + ttl["launches"]["flash_bwd_dkv"]
                             + tti["launches"]["flash_bwd_dkv"]
                             + tmes["launches"]["flash_bwd_dkv"]
                             + tmet["launches"]["flash_bwd_dkv"],
                             flash["flash_bwd_dkv"]),
        # the tensor x sequence slice: the windowed kernels at h 8 and the
        # full S 8192 (launches: train_tp_sp, a rank)
        "flash_fwd_tpsp": (flash_src, pallas + "flash_attention.py:260",
                           ttsp["launches"]["flash_fwd"],
                           flash["flash_fwd"]),
        "flash_bwd_dq_tpsp": (flash_src, pallas + "flash_attention.py:453",
                              ttsp["launches"]["flash_bwd_dq"],
                              flash["flash_bwd_dq"]),
        "flash_bwd_dkv_tpsp": (flash_src, pallas + "flash_attention.py:472",
                               ttsp["launches"]["flash_bwd_dkv"],
                               flash["flash_bwd_dkv"]),
        # the multi-rank Infinity slice: the same kernels at the Ulysses
        # shape inside each streamed layer (launches: train_infinity_sp,
        # a rank)
        "flash_fwd_inf_sp": (flash_src, pallas + "flash_attention.py:260",
                             tisp["launches"]["flash_fwd"],
                             flash["flash_fwd"]),
        "flash_bwd_dq_inf_sp": (flash_src,
                                pallas + "flash_attention.py:453",
                                tisp["launches"]["flash_bwd_dq"],
                                flash["flash_bwd_dq"]),
        "flash_bwd_dkv_inf_sp": (flash_src,
                                 pallas + "flash_attention.py:472",
                                 tisp["launches"]["flash_bwd_dkv"],
                                 flash["flash_bwd_dkv"])}

    def case_of(name):  # a flash row's timed case
        for suffix in ("tpsp", "bert", "70b", "sp"):
            if name.endswith("_" + suffix):
                return suffix
        return "headline"

    def kernel_row(name, source, replaces, launches, m):
        if "timed" in m:
            m = m["timed"][case_of(name)]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": (max(
                    e for case, e in rows[name][3]["max_abs_err_by_case"]
                    .items() if case_of(name) in case.split("_"))
                    if case_of(name) != "headline" and "timed" in rows[name][3]
                    else rows[name][3]["max_abs_err"]),
                "ms": m["kernel_time"]["ms"],
                "plain_ms": m["plain_time"]["ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": (m["library_time"] or {}).get("ms")}

    emit({"kernels": [kernel_row(name, *row) for name, row in rows.items()],
          "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
