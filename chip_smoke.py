#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero (there is no caught phase and no CPU
fallback):

1. device   the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
2. build    compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a.
3. kernels  each CUDA kernel against its plain torch version on the card
            (flash also at olmo-1b's training batch, 4 x 2048, and
            flash's backward: at olmo-1b's training shape, D = 64 not
            causal, G = 2 and 4, a window, a softcap that binds and the
            tile edges, every head dim the forward takes in both dtypes,
            nemotron-4-340b's heads (D = 192) and gemma2-2b's (D = 256,
            its softcap binding, with and without a window), a kv_len
            below T and the tile edges at D = 256, each gradient within
            2e-2 (bf16) or 2e-5 (fp32) of its norm, after the forward's
            lse is held against torch.logsumexp of the plain scores;
            timed at olmo-1b's, gemma2-2b's and nemotron-4-340b's heads
            and in fp32, and at the training shapes of mixtral-8x7b
            (G = 4) and seamless-m4t-medium (fp32 D = 64 not causal, bf16
            D = 64 causal), the forward too; its library call is SDPA's
            backward, or under a
            softcap flex_attention's; and the SSD scan's backward: at
            mamba2-780m's training shape, x [4,2048,48,64] bf16, its
            .reduced() widths, G = 2, jamba-1.5-large's 256 heads over
            one group, a ragged tail, S below the chunk, an initial state
            with a final state's gradient, the edges of every width, and
            in fp32, each gradient within 1e-2 (bf16) or 1e-4 (fp32) of
            its norm and dA within 1e-3; timed at mamba2-780m's and
            jamba-1.5-large's heads and in fp32, with no library call),
            at the main path's shapes, the sweep shapes of
            ``tests/test_kernels.py`` and the edges of the kernels' tiles
            (the SSD scan also shows which variant ran: bf16 must take the
            tensor cores); times the kernel, the plain version
            and one PyTorch library call where one computes the same
            function, beside the card's bound, and the kernel's and the
            call's device time alone and the wrapper's host time.
            Every attention model after the first gets cases and times at
            its own heads, windows and logit softcap (gemma2-2b, G = 2 at
            head_dim 256; starcoder2-3b, G = 12 under a window on every
            layer; qwen2-vl-2b, G = 6; nemotron-4-340b, G = 12 at head_dim
            192; mixtral-8x7b, G = 4 under a window on every layer;
            jamba-1.5-large, G = 8 with no positional embedding;
            seamless-m4t-medium, G = 1 at head_dim 64: flash not causal
            over its encoder's 1500 frames and at 4096, its cross-attention
            of 16 queries over 1500 keys, its decoder's causal 16, paged
            over its 80-slot self cache and its 1500-slot cross cache of
            4-token pages at every length the capacity), with
            scores scaled past a softcap so a kernel that dropped it would
            fail; a hybrid model's SSD scan gets cases and a time at its
            own heads (jamba-1.5-large: 256 heads over one group).  The
            library calls are SDPA (a window as a boolean mask) and,
            under a window or a softcap, flex_attention
            (the window as a block mask, the cap as score_mod), each held
            against the plain version first; the fastest is the library
            call, the others stand beside it (SDPA without a softcap is
            timed apart under one: a different function).  Then the
            logits' product (``Model._logits``) at nemotron-4-340b's and
            mixtral-8x7b's untied heads at 1 and 32 rows: the served one
            (the bf16 head read once, fp32 sums) against the widened one
            (argmax equal, within 1e-4 of its norm), both timed beside the
            bound, with the kernels the served one launches.
Then for each model, olmo-1b, mamba2-780m, gemma2-2b, starcoder2-3b and
qwen2-vl-2b at full published width, and at full layer width cut in depth
(CUT; none of the three fits one card whole) nemotron-4-340b to 4 of its
96 layers (head_dim 192, int8 KV caches), mixtral-8x7b to 8 of its 32 and
jamba-1.5-large to one 8-layer pattern repeat of its 72 with 8 of its 16
experts (a hybrid: 7 Mamba-2 blocks and 1 attention block, int8 KV),
random weights from --seed:
4. model    a prefill plus 16 decode steps on the kernel path against the
            plain path, teacher-forced (a windowed model: a prompt 64
            tokens past its window; under a logit softcap, again with the
            query projections scaled by 100 so that the cap binds; a VLM,
            again fed embeds with M-RoPE positions whose rows differ, which
            must move the logits; an int8 KV cache, also on starcoder2-3b
            and qwen2-vl-2b at full width: int8 values, scales not zero,
            logits apart from the same model's with bf16 caches but within
            the gate; an MoE model under the MoE bounds of
            tests/test_models_decode.py, and one full-width MoE layer's
            kernel dispatch against the plain one-hot dispatch, prefill and
            decode, timed, with the experts its routing reached); then a
            prefill of the longest prompt and one decode
            step at the engine's shape, each timed and traced with
            torch.profiler (device busy share, launches, costliest
            kernels), the decode step again with int8 caches where the
            int8 check ran at full width.
5. engine   RealEngine in passthrough, static_colocate, dynamic_pd and
            disagg: 8 requests, prompts of 128-1024 tokens (a windowed
            model's first one lengthened to 304 tokens past its window:
            4400 tokens at a 4096 window, so its 4096-slot rings wrap),
            32 new tokens each, arriving as a burst.  Every request must
            complete, with the same tokens in every mode, and the launch
            counters (reset just before each mode) must show the engine ran
            through the model's kernels, counted by mixer: every attention
            layer's flash launch under its window and paged launch over its
            own cache's capacity, as the wrappers count them, every Mamba
            layer's SSD scan, each on the tensor cores.  After the first
            model's engine, its traffic again in dynamic_pd and disagg
            under FLEX_SANITIZE=1: the hazard sanitizer must find nothing,
            and the tokens must not change.
Then the encoder-decoder, seamless-m4t-medium at full width (12 + 12
layers, 681,912,320 parameters), at model level (the engine feeds token
prompts; its prefill needs frame embeddings): 4 sequences of 1500 bf16
frame embeddings from --seed.
4. model    a prefill of the frames and a 16-token prompt plus 16 decode
            steps on the kernel path against the plain path, teacher-forced
            and step for step; then the prefill and one decode step, each
            timed and traced.
5. main     greedy decoding to 64 new tokens into a cache made with 1024
   path     cross slots (the prefill must replace them with the 1500
            frames' K/V), the launch counters reset just before and read
            just after: flash in every encoder layer and twice in every
            decoder layer (counted causal or not), paged twice a step in
            every decoder layer (counted by capacity, 80 and 1500); the
            logits against the teacher-forced forward over the generated
            sequence.
Then the cluster simulator, which does no device work itself:
sim         olmo-1b at full width: prefills of 128, 512 and 2048 tokens at
            batch 1 and decode steps at batch 1, 2 and 4 over contexts of
            512 and 2048, each on the host clock (median of 5) beside the
            profiler's busy time; InstanceSpec's compute_eff, bw_eff and
            launch_overhead_s fitted to them by least squares through
            CostModel.prefill_time/decode_time at one chip, beside the
            committed ones (serving/costmodel.py), each point beside both
            predictions (gates: each fitted efficiency in (0, 1]; the
            committed derates predict each host time within 2x); the
            engine in dynamic_pd on the engine phase's traffic under
            FLEX_PROFILE=1 and the reference's LatencyModel fitted to its
            trace (its calibration report); run_sim for mixtral-8x7b x
            1k1k on 384 simulated cards under dynamic and 6p2d (gate: all
            2,000 requests complete, none fails); a one-card simulation of
            olmo-1b's engine traffic (8 prompts, 32 new tokens, a burst,
            max_num_seqs 4) under static_colocate and dynamic_pd beside the
            engine phase's measured TTFT and TPOT (not a gate: a ratio
            outside [0.5, 2] is printed as a fault); the phase's seconds.
Then training, olmo-1b (1,176,764,416 parameters), gemma2-2b
(2,614,341,888: head_dim 256, G = 2, an attention softcap of 50),
mamba2-780m (780,148,992: 48 SSD layers), mixtral-8x7b at full layer
width cut to 2 of its 32 layers (3,164,688,384: 8 experts top-2, routed
with capacity through the sorted dispatch; TRAIN_CUT) and
seamless-m4t-medium (681,912,320: its encoder in fp32 on make_batch's
fp32 frames, its decoder in bf16), random weights from --seed, batches
of 4 x 2048 tokens from the port's make_batch, AdamW, remat as the
config sets it:
6. train    one loss and gradient on the kernel path, twice, which must
            agree bit for bit, then against the plain path
            (blocked_attention, ssd_chunked or the one-hot MoE dispatch
            under autograd) from the same parameters (mamba2-780m's at 4
            of its 48 layers, TRAIN_CHECK_LAYERS: past that bf16
            rounding sets its gradient on either path): the loss within
            1e-2, every gradient's cosine at least 0.99, the global
            norms within 3e-2; then 15 steps of the launcher's train step
            at lr 1e-3, warmup 3, total 40 (the schedule and gate of
            tests/test_training.py:17-31: the loss down by more than
            0.5), the launch counters reset just before and read just
            after, by mixer: the forward kernel twice a layer a step (the
            forward and remat's recompute), the backward kernel's passes
            once a layer a step, nothing else, flash by window and its
            launches not causal (the encoder's and the cross-attention's)
            apart; each step on the host clock, peak memory, tokens/s and
            model-FLOPs utilisation, then one step traced.
Then the distributed layer, on a NCCL process group of one rank (a
HashStore: no port) and the 1 x 1 (data, model) DeviceMesh on the card:
7. distributed
            olmo-1b's full-width parameters, annotated with their logical
            axes, laid out by the train rules (each local shard equal to the
            parameter bit for bit); its full-width gradient tree
            (1,176,764,416 bf16 elements, one step of batch 0) through
            the int8-compressed all-reduce over the data axis's group,
            bit for bit the int8 fake-quant on every leaf, timed, with the
            bytes a rank would send at 2, 4 and 16 ranks beside a bf16
            ring all-reduce's; then olmo-1b at full layer width cut to 2
            of its 16 layers (237,240,320 parameters): 6 steps of the
            launcher's train step, its gradients averaged over the group
            and then fake-quantized to int8, under run_with_restarts
            (save every 2, keep 2, in
            a temporary directory it removes), one failure raised after
            step 1 has updated the state in place and one before step 4,
            the launch counters reset just before and read just after
            (the forward kernel twice and the backward once a layer a step
            executed); the final parameters and AdamW state must equal an
            uninterrupted run's from the same seed bit for bit; the steps
            re-executed, each step's time, each save's and restore's
            seconds and GB/s.
8. dryrun   the dry-run (``repro_torch.launch.dryrun``), shape-only on
            ``meta`` shards over fake process groups, in subprocesses run
            side by side (started beside the build, awaited before the
            first timed phase): olmo-1b at full width and the train phase's
            shape (4 x 2048, remat) on a 1 x 1 mesh, its predicted
            parameter and AdamW-state bytes equal to the real trees' bytes
            exactly, its argument bytes, FLOPs and bytes positive, and one
            ``dryrun calibration:`` line of its predicted peak bytes,
            FLOPs and roofline times beside the train phase's measured
            peak memory, model FLOPs and step time; then the cells
            DRYRUN_CELLS on the 256- and 512-rank production meshes, each
            of which must complete (per-rank GB and whether they fit 80
            GB, FLOPs, collective bytes by type, roofline terms and trace
            seconds, a line each) with its peak of live bytes equal to the
            CPU's to the byte (DRYRUN_PEAKS) and jamba-1.5-large's decode
            FLOPs within 5 % of the JAX package's (DRYRUN_JAX_FLOPS), and
            the phase's seconds.
9. report   one ``{"kernels": [...]}`` line, then the card line, then
            ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

# the cut models fill most of the card, and their init draws each stacked
# tensor in fp32 before it casts: expandable segments let the allocator
# reuse those temporaries' memory for tensors of other sizes (set before
# the first CUDA allocation)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# flex_attention (the softcapped library call) compiles through inductor
# and Triton: their caches stay inside the checkout
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                      os.path.join(ROOT, "build", "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 on CUDA cores (data sheet)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
SPIN_CYCLES_PER_S = 2e9       # above the H100's 1.98 GHz boost clock, so a
                              # spin of n cycles lasts at least n / 2e9 s
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # tests/test_kernels.py
# a windowed model's attention cases also hold ||got - want|| / ||want||
# under this: both sides round to bf16, at most a step (2^-8) an element
REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
# q's scale in the softcap cases: bf16 scores of std ~30 pass a cap of 50
# by far; fp32 ones of std ~4 move the output by ten of fp32's tolerances
# (at std ~30 the fp32 scores' own rounding would pass 2e-5)
CAP_BOOST = {torch.bfloat16: 30.0, torch.float32: 4.0}
SSD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
ARCHS = ("olmo-1b", "mamba2-780m", "gemma2-2b", "starcoder2-3b",
         "qwen2-vl-2b", "nemotron-4-340b", "mixtral-8x7b",
         "jamba-1.5-large-398b")
# served at full layer width, cut in depth (and jamba's in experts): each
# matrix keeps its published shape.  nemotron-4-340b's 96 layers hold 341 B
# parameters; 4 of them, the embedding and the untied head 23.3 B (46.5 GB
# in bf16; Model._logits reads the 9.4-GB bf16 head once under inference
# mode, and widens it to fp32, 18.9 GB, in 4 GiB strips under autograd).
# mixtral-8x7b's 32 layers hold 46.7 B (93.4 GB); 8 of them 11.9 B.
# jamba-1.5-large's 72 layers hold 398 B, one 8-layer repeat of its pattern
# 45.1 B (90.3 GB), and that repeat with 8 of its 16 experts 25.8 B
# (51.6 GB); num_repeats allows no depth below one pattern.
# the encoder-decoder, served at model level (the engine feeds token
# prompts, and it needs frame embeddings): full width, 12 + 12 layers,
# 681,912,320 parameters (jax.eval_shape of the JAX init)
ENCDEC = "seamless-m4t-medium"
ENCDEC_PARAMS = 681_912_320
ENCDEC_B = 4                  # sequences
ENCDEC_FRAMES = 1500          # frame embeddings a sequence
ENCDEC_PROMPT = 16            # target prompt tokens
ENCDEC_NEW = 64               # greedy new tokens
# the greedy run's cache: 80 self slots (the prompt and the new tokens
# fit), made with a cross length of 1024, not the 1500 frames the
# prefill's encoder gives: the prefill must replace the cross K/V
ENCDEC_MAX_LEN, ENCDEC_ENC_LEN = 80, 1024
# flash at seamless's heads: (use, B, S, T, causal, on the main path);
# 4096 frames is the published max_position_embeddings
ENCDEC_FLASH = (("encoder", ENCDEC_B, ENCDEC_FRAMES, ENCDEC_FRAMES, False,
                 True),
                ("encoder at 4096 frames", 1, 4096, 4096, False, False),
                ("cross-attention", ENCDEC_B, ENCDEC_PROMPT, ENCDEC_FRAMES,
                 False, True),
                ("decoder self-attention", ENCDEC_B, ENCDEC_PROMPT,
                 ENCDEC_PROMPT, True, True))
CUT = {"nemotron-4-340b": dict(num_layers=4),
       "mixtral-8x7b": dict(num_layers=8),
       "jamba-1.5-large-398b": dict(num_layers=8, num_experts=8)}
# full-width models whose int8 KV cache is also run in the model phase
# (checked against bf16 caches, and its decode step traced): head_dim 128,
# starcoder2-3b's 4096-slot rings and qwen2-vl-2b's slot caches
INT8_AT_WIDTH = ("starcoder2-3b", "qwen2-vl-2b")
# a windowed model's traffic lengthens its first prompt to window + 304
# tokens (4400 at gemma2-2b's 4096), and its model phase's prompt is
# window + 64 tokens: both past the window, so the ring caches wrap
PAST_WINDOW = 304
CHECK_PAST_WINDOW = 64
IMAGE_GRID = 16               # the M-RoPE check's 16 x 16 patch grid
MAX_NUM_SEQS = 4
N_REQUESTS = 8
MAX_NEW = 32
MODEL_DECODE_STEPS = 16
TIE_EPS = 0.02                # tests/test_models_decode.py::agree_step
# an MoE model's gate, tests/test_models_decode.py:71-74: median softmax
# error below 0.05 and tie-aware agreement at 0.7 of the positions or more
# (a bf16 difference can flip a borderline top-k pick, and so an expert)
MOE_MIN_AGREE = 0.7
SSM_DECODE_EXACT = 5e-3       # tests/test_models_decode.py, mamba2
MODES = ("passthrough", "static_colocate", "dynamic_pd", "disagg")
# the modes run again under the hazard sanitizer, on the first model
SANITIZED_MODES = ("dynamic_pd", "disagg")
# the PyTorch calls that may compute a kernel's function (kernel_times)
LIBRARY_CALLS = ("sdpa", "flex_attention")
# the flash backward kernel against its plain version: each gradient's
# error within this share of its norm (the same fp32 sums in another
# order; bf16 also rounds each gradient once)
BWD_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the forward's lse against torch.logsumexp of the plain scores (the same
# fp32 function of the same inputs), relative and absolute
LSE_TOL = 2e-5
# the SSD backward kernel against its plain version: each gradient's error
# within this share of its norm (the same fp32 sums in another order; bf16
# also rounds dx, dB and dC once), dA within SSD_DA_REL_TOL: one sum a head
# over every row of the batch, of terms that cancel (tests/test_torch_cuda.py)
SSD_BWD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
SSD_DA_REL_TOL = 1e-3
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# training: olmo-1b and gemma2-2b at full published width and depth, the
# launcher's defaults but the size (batch 4 x 2048 tokens, AdamW, remat as
# in the config), from --seed; the schedule and the gate of
# tests/test_training.py:17-31 (lr 1e-3, warmup 3, total 40; 15 steps, the
# loss down by more than 0.5).  Each arch's parameter count is the JAX
# init's.
TRAIN_ARCH = "olmo-1b"        # its shapes are the backward's main row
TRAIN_PARAMS = {"olmo-1b": 1_176_764_416, "gemma2-2b": 2_614_341_888,
                "mamba2-780m": 780_148_992, "mixtral-8x7b": 3_164_688_384,
                ENCDEC: ENCDEC_PARAMS}
# trained at full layer width, cut in depth: training holds 12 bytes a
# parameter (bf16 weights, fp32 moments) and bf16 gradients besides, so
# mixtral-8x7b's 46.7 B would need 560 GB; 2 of its 32 layers and the
# embeddings hold 3.16 B, 38.0 GB of state, plus 6.3 GB of gradients and
# AdamW's fp32 temporaries for the stacked 940 M-element w_up (3.8 GB
# each); 3 layers would hold 55 GB of state before any activation
TRAIN_CUT = {"mixtral-8x7b": dict(num_layers=2)}
# flash at the training paths added last, at batch 4 x 2048: (model, use,
# H, KVH, D, dtype, causal, window).  mixtral-8x7b's window of 4096 does
# not bind at 2048 positions; seamless-m4t-medium's encoder runs in fp32
# on make_batch's fp32 frames, and its cross-attention, q widened to fp32,
# over the encoder's 2048 fp32 K/V, both not causal; its decoder in bf16
TRAIN_FLASH = (("mixtral-8x7b training", "attention", 32, 8, 128,
                torch.bfloat16, True, 4096),
               (f"{ENCDEC} training", "encoder and cross-attention", 16, 16,
                64, torch.float32, False, 0),
               (f"{ENCDEC} training", "decoder self-attention", 16, 16, 64,
                torch.bfloat16, True, 0))
TRAIN_B, TRAIN_S = 4, 2048
TRAIN_STEPS = 15
TRAIN_OPT = dict(lr=1e-3, warmup_steps=3, total_steps=40)
TRAIN_MIN_DROP = 0.5
# one step's loss and gradient on the kernel path against the plain path
# (blocked_attention under autograd) from the same parameters and batch:
# bf16 rounds at other places on the two paths
TRAIN_LOSS_TOL = 1e-2
TRAIN_MIN_COS = 0.99          # every gradient leaf's cosine
TRAIN_GNORM_TOL = 3e-2        # relative difference of the global norms
# that step at full width but fewer layers: mamba2-780m's bf16 gradient at
# random init is set by rounding past a few layers, on either path.
# Against a float64 evaluation of the same loss (tools/
# bf16_depth_noise.py) the worst leaf's cosine is 0.995 (kernel path) and
# 0.997 (plain path) at 4 layers, 0.95 at 8, 0.79-0.87 at 12 and 0.25-0.36
# at all 48, where the two bf16 paths are 0.50 apart; so the gate holds
# the paths to each other at 4 layers, and the 48 train
TRAIN_CHECK_LAYERS = {"mamba2-780m": 4}
# the distributed layer: a NCCL group of one rank (a HashStore, no port),
# the 1 x 1 (data, model) mesh; olmo-1b's full-width parameters laid out by
# the train rules, and its full-width gradient tree through the
# int8-compressed all-reduce over the data axis's group; the wire bytes
# of that design and of a bf16 ring all-reduce at DIST_RANKS ranks
DIST_ARCH = "olmo-1b"
DIST_MESH = ((1, 1), ("data", "model"))
DIST_RANKS = (2, 4, 16)
DIST_ITERS = 5
# restarts: olmo-1b at full layer width cut to 2 of its 16 layers (10
# bytes a parameter of training state, 2.37 GB a checkpoint; the whole
# model's 11.8 GB, written several times over, does not belong in a smoke
# run), the launcher's train step (gradients averaged over the group,
# then fake-quantized to int8), RESTART_STEPS steps under run_with_restarts, saving every
# RESTART_SAVE_EVERY steps and keeping RESTART_KEEP; one failure raised
# after step 1 has updated the state in place (before the first save: the
# restart reads back the step-0 checkpoint) and one before step 4 runs
RESTART_CUT = dict(num_layers=2)
RESTART_PARAMS = 237_240_320
RESTART_STEPS = 6
RESTART_SAVE_EVERY = 2
RESTART_KEEP = 2
RESTART_FAIL_AFTER = (1,)
RESTART_FAIL_BEFORE = (4,)
# the dry-run: olmo-1b's train phase (TRAIN_B x TRAIN_S, remat) traced on a
# 1 x 1 mesh against the real step's trees, memory and time; then three
# production cells (arch, shape, mesh), traced on one rank of a fake group
# of 256 (single) or 512 (multi) ranks; each process's time limit
DRYRUN_CALIBRATION = "olmo-1b"
DRYRUN_CELLS = (("olmo-1b", "train_4k", "single"),
                ("mixtral-8x7b", "prefill_32k", "single"),
                ("jamba-1.5-large-398b", "long_500k", "multi"))
DRYRUN_TIMEOUT_S = 400
# each cell's peak of live bytes (mem_temp_bytes), which the op stream
# alone sets: the CPU's figures (torch 2.13.0+cpu; ``PYTHONPATH=src python
# -m repro_torch.launch.dryrun --arch ARCH --shape SHAPE --mesh MESH``),
# which the card's torch must give to the byte
DRYRUN_PEAKS = {("olmo-1b", "train_4k", "single"): 8_913_145_872,
                ("mixtral-8x7b", "prefill_32k", "single"): 3_221_487_620,
                ("jamba-1.5-large-398b", "long_500k", "multi"): 335_545_860}
# the JAX package's FLOPs a rank for one-token decode on FSDP weights
# (``PYTHONPATH=src python tools/jax_dryrun_cells.py --cells
# jamba-1.5-large-398b:long_500k:multi``, CPU), and the share within which
# the port's dry-run must count them
DRYRUN_JAX_FLOPS = {("jamba-1.5-large-398b", "long_500k", "multi"):
                    3_383_123_840.0}
DRYRUN_FLOPS_TOL = 0.05
# the sim phase: InstanceSpec's derates fitted (least squares, host clock)
# to olmo-1b's own prefills at batch 1 and decode steps; the reference's
# LatencyModel fitted to an engine trace (FLEX_PROFILE=1); the 384-card
# simulation of mixtral-8x7b x 1k1k at the H100's constants; a one-card
# simulation of the engine phase's own traffic beside its measured TTFT and
# TPOT
SIM_ARCH = "olmo-1b"
SIM_PREFILL_LENS = (128, 512, 2048)
SIM_DECODE_BATCHES = (1, 2, 4)
SIM_DECODE_CONTEXTS = (512, 2048)
SIM_DECODE_STEPS = 4
SIM_DEPLOYMENTS = ("dynamic", "6p2d")
SIM_ENGINE_MODES = ("static_colocate", "dynamic_pd")
SIM_PREDICT_FACTOR = 2.0      # committed derates: each point within 2x
SIM_RATIO_BOUNDS = (0.5, 2.0)  # sim / measured outside: a fault to record


# the logits' product timed at these models' untied heads ([d, V] bf16),
# at M rows: one prefill's last token (1), a decode step's batch (32); the
# served product within LOGITS_REL_TOL of the widened one's norm
LOGITS_ARCHS = ("nemotron-4-340b", "mixtral-8x7b")
LOGITS_ROWS = (1, 32)
LOGITS_REL_TOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


# each engine run's result, by (model, mode): the sim phase sets the
# simulated TTFT and TPOT beside the measured ones
ENGINE_RESULTS = {}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_label(ptxas_line: str) -> str:
    """``ssd_chunk_scan<64,128>`` or ``paged_attention_kernel<bf16,256,2>``
    from ptxas's "Compiling entry function '<mangled name>'" line (integer
    and bool template arguments, and the element type as bf16 or f32)."""
    m = re.search(r"\d+((?:flash|paged|ssd|fa_bwd)_\w*?)(I|E)", ptxas_line)
    if m is None:
        return ptxas_line.strip()
    if m.group(2) == "E":
        return m.group(1)
    span = re.match(r"(?:L[ib]\d+E|\d+__nv_bfloat16|f)*",
                    ptxas_line[m.end():]).group(0)
    args = ["bf16" if a.endswith("bfloat16") else "f32" if a == "f"
            else a[2:-1]
            for a in re.findall(r"L[ib]\d+E|\d+__nv_bfloat16|f", span)]
    return f"{m.group(1)}<{','.join(args)}>"


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call, from CUDA events around ``iters``
    back-to-back calls.  Where a call's host-side work (argument checks,
    allocation, the launch) outlasts its kernel, the host's issue rate sets
    this time: it is the pace a caller sees."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_held(fn, iters: int, warmup: int = 2):
    """(device ms, host us) of one call.  A spin kernel holds the stream
    while the host issues ``iters`` calls, for longer than that takes, so
    the events around them time the card alone and the host clock times
    the issue alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_call_s = time.perf_counter() - t0     # host issue + device, a bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((iters * one_call_s + 1e-3) * SPIN_CYCLES_PER_S))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, 1e6 * host_s / iters


def kernel_times(kernel, plain, library, iters: int = 50):
    """The kernels line's times for one kernel: ``ms`` and ``plain_ms`` by
    ``time_ms``, and the kernel's device time and its wrapper's host time
    per call by ``time_held``.  ``library``: {name: call} of the PyTorch
    calls that compute the same function (each already held against the
    plain version).  Each is timed the same two ways; the fastest by
    ``ms`` is reported as ``library_ms``/``library_device_ms`` and named
    in ``library_call``, and every other one stands beside it as
    ``<name>_ms``/``<name>_device_ms``."""
    t = dict(ms=time_ms(kernel, iters),
             plain_ms=time_ms(plain, 3, warmup=1))
    t["device_ms"], t["host_us"] = time_held(kernel, iters)
    lib = {name: (time_ms(call, iters), time_held(call, iters)[0])
           for name, call in library.items()}
    best = min(lib, key=lambda name: lib[name][0], default=None)
    t["library_call"] = best
    t["library_ms"], t["library_device_ms"] = lib.get(best, (None, None))
    for name, (ms, device_ms) in lib.items():
        if name != best:
            t[f"{name}_ms"], t[f"{name}_device_ms"] = ms, device_ms
    return t


def times_text(t) -> str:
    return " ".join(f"{k}={t[k]!r}" for k in (
        "ms", "device_ms", "host_us", "plain_ms", "library_call",
        "library_ms", "library_device_ms", "bound_ms")) + \
        f" ({t['bound_by']})"


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """Least time for the work on the card (bf16 inputs: the tensor cores'
    bf16 peak; fp32 ones pass fp32's), and whether operations or bytes set
    it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(got, want) -> float:
    """||got - want|| / ||want||."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def check_rel(name: str, got, want, dtype) -> float:
    rel = rel_err(got, want)
    require(rel < REL_TOL[dtype],
            f"{name}: kernel's error is {rel:.3g} of the output's norm "
            f"(bound {REL_TOL[dtype]})")
    return rel


def check_cap_binds(name: str, want, uncapped, dtype) -> float:
    """The plain version with the softcap and without it differ by ten
    tolerances or more, elementwise and in norm: a kernel that dropped the
    cap could not pass."""
    rel, err = rel_err(uncapped, want), max_err(uncapped, want)
    require(rel > 10 * REL_TOL[dtype] and err > 10 * TOL[dtype],
            f"{name}: the softcap does not bind (without it the output "
            f"moves {err:.3g}, {rel:.3g} of its norm)")
    return rel


def same_function(what: str, out, want) -> bool:
    """Print whether a library call's ``out`` agrees with the plain
    version's ``want`` under TOL and REL_TOL (then it computes the same
    function, and its time may stand beside the kernel's)."""
    dtype = want.dtype
    err, rel = max_err(out, want), rel_err(out, want)
    agrees = (bool(torch.allclose(out.float(), want.float(), rtol=TOL[dtype],
                                  atol=TOL[dtype]))
              and rel < REL_TOL[dtype])
    print(f"    {what} against the plain version: max_abs_err={err:.3g} "
          f"rel_err={rel:.3g}: " + ("the same function" if agrees else
                                    "DISAGREES, so no library time is "
                                    "reported for it"))
    return agrees


def check_close(name: str, got, want, dtype, tols=TOL) -> float:
    err = max_err(got, want)
    tol = tols[dtype]
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    require(ok, f"{name}: kernel disagrees with its plain version "
                f"(max abs err {err:.3g}, tolerance {tol})")
    return err


# --------------------------------------------------------------------- cuts

def cut_config(cfg, num_layers: int = 0, num_experts: int = 0):
    """``cfg`` at full layer width with its first ``num_layers`` layers and
    its first ``num_experts`` experts (0: all), as launch/serve.py's
    --layers and --experts cut it."""
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if num_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=num_experts))
    return cfg


def cut_label(published, cfg) -> str:
    """How ``cfg`` differs from the published config: its width, and the
    layers and experts a cut keeps."""
    kept = []
    if cfg.num_layers != published.num_layers:
        kept.append(f"{cfg.num_layers} of {published.num_layers} layers")
    if cfg.moe is not None and cfg.moe.num_experts != \
            published.moe.num_experts:
        kept.append(f"{cfg.moe.num_experts} of {published.moe.num_experts} "
                    f"experts")
    if not kept:
        return "full width"
    return (f"full layer width, {' and '.join(kept)} (a cut, not the "
            f"published model)")


# ------------------------------------------------------------------ traffic

def engine_traffic(seed: int, vocab: int, long_first: int = 0):
    """8 prompts of 128-1024 tokens; the first lengthened to
    ``long_first`` tokens if that is set.  The slot cache holds the
    longest prompt and its new tokens, rounded up to 64."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 1025, N_REQUESTS)
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in lens]
    if long_first:
        prompts[0] += rng.integers(0, vocab,
                                   long_first - len(prompts[0])).tolist()
    longest = max(len(p) for p in prompts)
    return prompts, 64 * math.ceil((longest + MAX_NEW) / 64)


# ------------------------------------------------------------ kernel checks

def layer_windows(cfg):
    """The windows of a model's attention layers, 0 for global."""
    from repro_torch.models.transformer import block_pattern
    return sorted({d.window for d in block_pattern(cfg)})


def flash_cases(prompt_lens, models, encdec):
    """(label, B, S, T, H, KVH, D, dtype, kwargs) — the engine's prefill
    shapes first, then the sweeps of tests/test_kernels.py, then each
    further attention model's (``models``: (cfg, its prompt lengths)) at
    its own heads, windows and softcap: its longest prefill in every kind
    of layer, the 64-row tile edges, kv_len; then the encoder-decoder's
    (``encdec``, its cfg) three prefill uses (ENCDEC_FLASH).  Cases whose
    ``q_boost`` scales q past the cap also check that the cap binds;
    ``model`` marks a model's cases (also held under REL_TOL), ``timed``
    the key of a shape timed later."""
    cases = [(f"main S={s}", 1, s, s, 16, 16, 128, torch.bfloat16,
              dict(causal=True, scale=128 ** -0.5)) for s in prompt_lens]
    for S, H, KVH, D in [(64, 4, 2, 32), (100, 4, 4, 64), (33, 8, 2, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"sweep S={S} H={H}/{KVH} D={D}", 2, S, S, H, KVH,
                          D, dt, dict(causal=True, scale=D ** -0.5)))
    for dt in (torch.float32, torch.bfloat16):
        for window, softcap, causal in [(16, 0.0, True), (0, 25.0, True),
                                        (16, 25.0, True), (0, 0.0, False)]:
            cases.append((f"variant w={window} cap={softcap} "
                          f"causal={causal}", 1, 80, 80, 4, 2, 32, dt,
                          dict(causal=causal, scale=0.2, window=window,
                               softcap=softcap)))
        cases.append(("kv_len=70 of T=100", 1, 48, 100, 4, 2, 64, dt,
                      dict(causal=False, scale=0.2, kv_len=70)))
        for S in (1, 63, 64, 65, 129):              # the 64-row tile edges
            cases.append((f"edge S={S}", 1, S, S, 4, 2, 128, dt,
                          dict(causal=True, scale=128 ** -0.5)))
    for cfg, lens in models:
        H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        cap, S, name = cfg.attn_logit_softcap, max(lens), cfg.name
        base = dict(causal=True, scale=D ** -0.5, softcap=cap, model=name)
        for window in layer_windows(cfg):
            for boost in (1.0, CAP_BOOST[torch.bfloat16]) if cap else (1.0,):
                cases.append((f"{name} S={S} window={window} cap={cap:g} "
                              f"q*{boost:g}", 1, S, S, H, KVH, D,
                              torch.bfloat16,
                              dict(base, window=window, q_boost=boost,
                                   timed=(name, window) if boost == 1.0
                                   else None)))
        for dt in (torch.float32, torch.bfloat16):
            for S_ in (1, 63, 64, 65, 129):
                for window in (0, 40):
                    for boost in ((1.0, CAP_BOOST[dt]) if cap and S_ > 64
                                  else (1.0,)):
                        cases.append((f"{name} edge S={S_} window={window} "
                                      f"cap={cap:g} q*{boost:g}", 1, S_, S_,
                                      H, KVH, D, dt,
                                      dict(base, window=window,
                                           q_boost=boost)))
            cases.append((f"{name} kv_len=70 of T=100", 1, 48, 100, H, KVH,
                          D, dt, dict(base, causal=False, kv_len=70)))
    train = f"{TRAIN_ARCH} training"
    cases.append((f"{train} q/k/v [{TRAIN_B},{TRAIN_S}]", TRAIN_B, TRAIN_S,
                  TRAIN_S, 16, 16, 128, torch.bfloat16,
                  dict(causal=True, scale=128 ** -0.5, model=train,
                       timed=(train, 0))))
    for model, use, H, KVH, D, dt, causal, window in TRAIN_FLASH:
        cases.append((f"{model} {use} q/k/v [{TRAIN_B},{TRAIN_S}]", TRAIN_B,
                      TRAIN_S, TRAIN_S, H, KVH, D, dt,
                      dict(causal=causal, scale=D ** -0.5, window=window,
                           model=model, timed=(model, use))))
    H, KVH, D = encdec.num_heads, encdec.num_kv_heads, encdec.head_dim
    for use, B, S, T, causal, _ in ENCDEC_FLASH:
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"{encdec.name} {use} q [{B},{S}] k/v [{B},{T}] "
                          f"causal={causal}", B, S, T, H, KVH, D, dt,
                          dict(causal=causal, scale=D ** -0.5,
                               model=encdec.name,
                               timed=((encdec.name, use)
                                      if dt == torch.bfloat16 else None))))
    return cases


def check_flash(prompt_lens, models, encdec, gen):
    from repro_torch.kernels import flash_attention as FA
    main_err, errs = 0.0, {}
    for label, B, S, T, H, KVH, D, dt, kw in flash_cases(prompt_lens,
                                                         models, encdec):
        kw = dict(kw)
        boost, model = kw.pop("q_boost", 1.0), kw.pop("model", None)
        timed = kw.pop("timed", None)
        q = (torch.randn(B, S, H, D, generator=gen, device="cuda")
             * boost).to(dt)
        k = torch.randn(B, T, KVH, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, T, KVH, D, generator=gen, device="cuda").to(dt)
        got = FA.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want = FA.flash_attention_plain(q, k, v, **kw)
        name = f"flash_attention {label} {str(dt)[6:]}"
        err = check_close(name, got, want, dt)
        text = f"max_abs_err={err:.3g}"
        if model:
            text += f" rel_err={check_rel(name, got, want, dt):.3g}"
        if boost > 1:
            uncapped = FA.flash_attention_plain(q, k, v,
                                                **dict(kw, softcap=0.0))
            text += (" (without the cap the plain output moves "
                     f"{check_cap_binds(name, want, uncapped, dt):.3g} of "
                     "its norm)")
        if label.startswith("main"):
            main_err = max(main_err, err)
        if timed:
            errs[timed] = err
        print(f"  {name}: {text}")

    # timing at the shortest prompt of the engine's traffic (its own line),
    # then at each further model's longest in every kind of layer, then at
    # olmo-1b's longest (the kernels line)
    S = min(prompt_lens)
    print(f"  flash_attention at q/k/v [1,{S},16,128] bf16 causal: "
          f"{times_text(time_flash(FA, S, gen))}")
    extra = []
    for cfg, lens in models:
        H, KVH, D, S = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        max(lens))
        for window in layer_windows(cfg):
            t = time_flash(FA, S, gen, H=H, KVH=KVH, D=D, window=window,
                           softcap=cfg.attn_logit_softcap)
            t["model"], t["window"] = cfg.name, window
            t["shape"] = (f"q [1,{S},{H},{D}], k/v [1,{S},{KVH},{D}] bf16 "
                          f"causal, window {window}, softcap "
                          f"{cfg.attn_logit_softcap:g}")
            t["max_abs_err"] = errs[cfg.name, window]
            print(f"  flash_attention at {t['shape']}: {times_text(t)}")
            print_beside("flash_attention", t)
            extra.append(t)
    # the encoder-decoder's three uses; the wrapper counts its launches by
    # causality: the encoder's and the cross-attention's together (not
    # causal), the decoder's self-attention apart
    H, KVH, D = encdec.num_heads, encdec.num_kv_heads, encdec.head_dim
    for use, B, S, T, causal, main_path in ENCDEC_FLASH:
        t = time_flash(FA, S, gen, H=H, KVH=KVH, D=D, B=B, T=T,
                       causal=causal)
        t["model"], t["use"], t["window"] = encdec.name, use, 0
        t["causal"], t["main_path"] = causal, main_path
        t["shape"] = (f"{use}: q [{B},{S},{H},{D}], k/v [{B},{T},{KVH},{D}] "
                      f"bf16, causal={causal}")
        t["max_abs_err"] = errs[encdec.name, use]
        print(f"  flash_attention at {t['shape']}: {times_text(t)}")
        print_beside("flash_attention", t)
        extra.append(t)
    # the training forward: olmo-1b's heads at its training batch
    train = f"{TRAIN_ARCH} training"
    t = time_flash(FA, TRAIN_S, gen, B=TRAIN_B)
    t["model"], t["window"], t["max_abs_err"] = train, 0, errs[train, 0]
    t["shape"] = (f"q/k/v [{TRAIN_B},{TRAIN_S},16,128] bf16 causal "
                  f"(training's forward)")
    print(f"  flash_attention at {t['shape']}: {times_text(t)}")
    extra.append(t)
    # the training paths added last: mixtral-8x7b's heads, seamless-m4t-
    # medium's encoder and cross-attention (fp32) and decoder (bf16); the
    # encoder-decoder's rows take their launches by causality (main)
    for model, use, H, KVH, D, dt, causal, window in TRAIN_FLASH:
        t = time_flash(FA, TRAIN_S, gen, H=H, KVH=KVH, D=D, B=TRAIN_B,
                       window=window, causal=causal, dtype=dt)
        t["model"], t["use"], t["window"] = model, use, window
        t["causal"], t["max_abs_err"] = causal, errs[model, use]
        t["shape"] = (f"{use}: q [{TRAIN_B},{TRAIN_S},{H},{D}], k/v "
                      f"[{TRAIN_B},{TRAIN_S},{KVH},{D}] {str(dt)[6:]} "
                      f"causal={causal}, window {window} (training)")
        print(f"  flash_attention at {t['shape']}: {times_text(t)}")
        print_beside("flash_attention", t)
        extra.append(t)
    S = max(prompt_lens)
    t = time_flash(FA, S, gen)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:82",
                max_abs_err=main_err, **t,
                shape=f"q/k/v [1,{S},16,128] bf16 causal", models=extra)


def print_beside(kernel: str, t) -> None:
    """The calls timed beside the library call: SDPA without the softcap
    (a different function), and every other call that computes the same
    function but was slower by ``ms``."""
    if "sdpa_without_softcap_ms" in t:
        print(f"  {kernel} at {t['shape']}: SDPA without the softcap (a "
              f"different function): ms={t['sdpa_without_softcap_ms']!r} "
              f"device_ms={t['sdpa_without_softcap_device_ms']!r}")
    for name in LIBRARY_CALLS:
        if f"{name}_ms" in t:
            print(f"  {kernel} at {t['shape']}: {name} (the same function, "
                  f"slower than {t['library_call']}): "
                  f"ms={t[f'{name}_ms']!r} "
                  f"device_ms={t[f'{name}_device_ms']!r}")


def flex_call(q, k, v, want, *, scale: float, softcap: float, mask_mod, B):
    """One call of ``torch.nn.attention.flex_attention`` computing the
    kernels' attention: a softcap as its score_mod, the mask as a block
    mask, GQA by enable_gqa; q [B, H, Sq, D], k/v [B, KVH, T, D].  It is
    compiled here, outside any timing, after dynamo's caches are cleared
    (a compiled graph is otherwise reused for a new mask_mod whose
    identity guard it passes), and returned only if it computes the same
    function as ``want`` (the plain version, [B, Sq, H, D]); otherwise
    None, so no time is reported for a different function."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / softcap) * softcap

    torch._dynamo.reset()
    flex = torch.compile(flex_attention, dynamic=False)
    block_mask = create_block_mask(mask_mod, B=B, H=None, Q_LEN=q.shape[2],
                                   KV_LEN=k.shape[2], device=q.device)

    def call():
        return flex(q, k, v, score_mod=score_mod if softcap else None,
                    block_mask=block_mask, scale=scale,
                    enable_gqa=q.shape[1] != k.shape[1])

    t0 = time.monotonic()
    out = call().transpose(1, 2)
    torch.cuda.synchronize()
    what = f"flex_attention (compiled in {time.monotonic() - t0:.1f} s)"
    return call if same_function(what, out, want) else None


def time_flash(FA, S: int, gen, H=16, KVH=16, D=128, window=0,
               softcap=0.0, B=1, T=None, causal=True, dtype=torch.bfloat16):
    """Kernel, plain and library times at q [B, S, H, D], k/v [B, T, KVH,
    D] in ``dtype`` (T = S unless given), causal or not, beside the card's
    bound for the (q, k) pairs the band holds (S T of them a sequence when
    not causal; fp32 at fp32's peak).  The library calls (kernel_times
    picks the fastest): SDPA (a window that binds as a boolean mask, no
    mask when not causal, GQA by enable_gqa), and under a binding window
    or a softcap flex_attention (the window as a block mask, the cap as
    its score_mod).  SDPA has no
    softcap: under one it is timed apart (``sdpa_without_softcap_*``, a
    different function)."""
    T = S if T is None else T
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, T, KVH, D, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap, causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    want = FA.flash_attention_plain(q, k, v, **kw)
    mask = None
    if window and window < S:
        pos = torch.arange(S, device="cuda")
        mask = ((pos[None] <= pos[:, None])
                & (pos[None] > pos[:, None] - window))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            scale=kw["scale"], enable_gqa=KVH != H)

    library = {}
    if not softcap and same_function("sdpa", sdpa().transpose(1, 2), want):
        library["sdpa"] = sdpa
    if softcap or mask is not None:
        if window:
            def mask_mod(b, h, q_idx, kv_idx):
                return (q_idx >= kv_idx) & (q_idx - kv_idx < window)
        else:
            def mask_mod(b, h, q_idx, kv_idx):
                return q_idx >= kv_idx
        flex = flex_call(qt, kt, vt, want, scale=kw["scale"],
                         softcap=softcap, mask_mod=mask_mod, B=None)
        if flex is not None:
            library["flex_attention"] = flex
    t = kernel_times(lambda: FA.flash_attention_cuda(q, k, v, **kw),
                     lambda: FA.flash_attention_plain(q, k, v, **kw),
                     library)
    if softcap:
        t["sdpa_without_softcap_ms"] = time_ms(sdpa, 50)
        t["sdpa_without_softcap_device_ms"] = time_held(sdpa, 50)[0]
    if not causal:
        pairs = S * T
    elif window:
        pairs = sum(min(i + 1, window) for i in range(S))
    else:
        pairs = S * (S + 1) // 2                    # causal, S = T
    flops = 4.0 * H * D * B * pairs
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, k, v, out
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS
                               if dtype == torch.bfloat16
                               else PEAK_FP32_FLOPS)
    return dict(t, bound_ms=bound_ms, bound_by=bound_by)


def paged_inputs(B, H, KVH, D, ps, maxp, dt, gen, *, identity, lengths,
                 q_boost=1.0):
    P = B * maxp + (0 if identity else 1)
    q = (torch.randn(B, H, D, generator=gen, device="cuda") * q_boost).to(dt)
    kp = torch.randn(P, ps, KVH, D, generator=gen, device="cuda").to(dt)
    vp = torch.randn(P, ps, KVH, D, generator=gen, device="cuda").to(dt)
    order = (torch.arange(P, device="cuda") if identity else
             torch.randperm(P, generator=gen, device="cuda"))
    pt = order[:B * maxp].view(B, maxp).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln


def check_paged(max_len, prompt_lens, models, encdec, gen):
    """``models``: (cfg, its prompt lengths, its max_len) for each further
    attention model; ``encdec``: the encoder-decoder's cfg, whose decode
    runs the kernel over its self cache and its cross cache."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.layers import page_size
    ps = page_size(max_len)
    main_lens = [min(n + MAX_NEW // 2, max_len)
                 for n in prompt_lens[:MAX_NUM_SEQS]]
    # (label, B, H, KVH, D, ps, maxp, dtype, identity, lengths, scale, cap,
    #  meta: q_boost and model as in flash_cases)
    cases = [("main slot cache", MAX_NUM_SEQS, 16, 16, 128, ps,
              max_len // ps, torch.bfloat16, True, main_lens, 128 ** -0.5,
              0.0, {})]
    for B, H, KVH, D, pps, maxp in [(2, 4, 1, 32, 8, 3), (3, 8, 2, 64, 16, 4),
                                    (1, 12, 4, 128, 32, 2)]:
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"sweep B={B} H={H}/{KVH} D={D} ps={pps}", B, H,
                          KVH, D, pps, maxp, dt, False,
                          [1 + (i * 7) % (pps * maxp) for i in range(B)],
                          D ** -0.5, 0.0, {}))
    cases.append(("softcap", 2, 4, 2, 32, 8, 3, torch.float32, True, [20, 9],
                  0.2, 30.0, {}))
    maxp = max_len // ps
    for dt in (torch.float32, torch.bfloat16):
        cases += [
            ("length 1", MAX_NUM_SEQS, 16, 16, 128, ps, maxp, dt, True,
             [1] * MAX_NUM_SEQS, 128 ** -0.5, 0.0, {}),
            ("full capacity", MAX_NUM_SEQS, 16, 16, 128, ps, maxp, dt, True,
             [max_len] * MAX_NUM_SEQS, 128 ** -0.5, 0.0, {}),
            # 30 splits of 32 tokens over 2 chunks: 28 splits empty
            ("more splits than chunks", 1, 2, 1, 64, 16, 60, dt, False,
             [40], 0.125, 0.0, {}),
            ("G=12 in chunks of 8", 2, 24, 2, 64, 16, 4, dt, False, [50, 7],
             0.125, 30.0, {}),
            # B * KVH = 264 >= 2 * 132 SMs: one split, no partials
            ("one split", 33, 16, 8, 128, 16, 4, dt, False,
             [1 + (i * 13) % 64 for i in range(33)], 128 ** -0.5, 0.0, {}),
        ]
    # each further model's decode at its own heads and softcap: a windowed
    # model's ring of `window` slots (the engine passes lengths up to T;
    # the kernel clamps those past it), its global cache, as the engine's
    # slot caches hold them mid-decode
    timed = ["main slot cache"]
    for cfg, lens, m_max_len in models:
        H, KVH, D, name = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.name)
        cap, W = cfg.attn_logit_softcap, cfg.sliding_window
        caches = []                     # (label, T, lengths, layer window)
        if W:
            ring_T = min(m_max_len, W)
            caches.append((f"{name} ring", ring_T, [
                min(n, ring_T) for n in decode_lens(m_max_len, lens)], W))
        if 0 in layer_windows(cfg):
            caches.append((f"{name} global", m_max_len,
                           decode_lens(m_max_len, lens), 0))
        meta = dict(model=name)
        for dt in (torch.float32, torch.bfloat16):
            for label, T, c_lens, window in caches:
                c_ps = page_size(T)
                for boost in (1.0, CAP_BOOST[dt]) if cap else (1.0,):
                    cases.append((f"{label} q*{boost:g}", MAX_NUM_SEQS, H,
                                  KVH, D, c_ps, T // c_ps, dt, True, c_lens,
                                  D ** -0.5, cap,
                                  dict(meta, q_boost=boost, window=window)))
                cases.append((f"{label} at and past T", MAX_NUM_SEQS, H, KVH,
                              D, c_ps, T // c_ps, dt, True,
                              [T, T + 1, 1, T - 1], D ** -0.5, cap, meta))
            cases += [
                (f"{name} one split", 264 // KVH, H, KVH, D, 16, 4, dt,
                 False, [1 + (i * 13) % 64 for i in range(264 // KVH)],
                 D ** -0.5, cap, meta),
            ]
        timed += [f"{label} q*1" for label, _, _, _ in caches]
    # the encoder-decoder's decode at its heads: the cross cache of
    # ENCDEC_FRAMES slots (4-token pages) at every length its capacity;
    # its self cache half way through the greedy run; and an odd encoder
    # length, whose pages hold one token
    H, KVH, D, name = (encdec.num_heads, encdec.num_kv_heads,
                       encdec.head_dim, encdec.name)
    mid = ENCDEC_PROMPT + ENCDEC_NEW // 2
    enc_caches = [(f"{name} cross q*1", ENCDEC_FRAMES,
                   [ENCDEC_FRAMES] * ENCDEC_B),
                  (f"{name} self q*1", ENCDEC_MAX_LEN, [mid] * ENCDEC_B),
                  (f"{name} cross of 1499 frames", ENCDEC_FRAMES - 1,
                   [ENCDEC_FRAMES - 1] * ENCDEC_B)]
    for dt in (torch.float32, torch.bfloat16):
        for label, T, c_lens in enc_caches:
            c_ps = page_size(T)
            cases.append((label, ENCDEC_B, H, KVH, D, c_ps, T // c_ps, dt,
                          True, c_lens, D ** -0.5, 0.0,
                          dict(model=name, window=0)))
    timed += [label for label, _, _ in enc_caches[:2]]
    main_err = 0.0
    sms = PA.sm_count(torch.device("cuda"))
    to_time = {}
    for (label, B, H, KVH, D, pps, maxp, dt, ident, lens, scale, cap,
         meta) in cases:
        args = paged_inputs(B, H, KVH, D, pps, maxp, dt, gen,
                            identity=ident, lengths=lens,
                            q_boost=meta.get("q_boost", 1.0))
        want = PA.paged_attention_plain(*args, scale=scale, softcap=cap)
        n_split, span = PA.split_plan(B, KVH, maxp * pps, sms)
        name = f"paged_attention {label} {str(dt)[6:]}"
        # twice: the second launch finds the first one's tickets reset
        for _ in range(2):
            got = PA.paged_attention_cuda(*args, scale=scale, softcap=cap)
            torch.cuda.synchronize()
            err = check_close(name, got, want, dt)
        text = f"max_abs_err={err:.3g}"
        if "model" in meta:
            text += f" rel_err={check_rel(name, got, want, dt):.3g}"
        if meta.get("q_boost", 1.0) > 1:
            uncapped = PA.paged_attention_plain(*args, scale=scale)
            text += (" (without the cap the plain output moves "
                     f"{check_cap_binds(name, want, uncapped, dt):.3g} of "
                     "its norm)")
        if label.startswith("main"):
            main_err = err
        if label in timed and dt == torch.bfloat16:
            to_time[label] = (args, scale, cap, n_split, meta, err)
        print(f"  {name} ({n_split} splits of {span}): {text}")

    extra = []
    for label in timed[1:]:
        args, scale, cap, n_split, meta, err = to_time[label]
        t = time_paged(PA, args, scale, cap)
        B, H, D = args[0].shape
        t["model"], t["window"] = meta["model"], meta["window"]
        t["capacity"] = args[3].shape[1] * args[1].shape[1]   # the cache's T
        t["shape"] = (f"{label.removesuffix(' q*1')}: q [{B},{H},{D}] over "
                      f"{tuple(args[1].shape)} bf16 pages, lengths "
                      f"{args[4].tolist()}, softcap {cap:g}, {n_split} "
                      f"splits")
        t["max_abs_err"] = err
        print(f"  paged_attention at {t['shape']}: {times_text(t)}")
        print_beside("paged_attention", t)
        extra.append(t)
    args, scale, cap, n_split, _, _ = to_time["main slot cache"]
    t = time_paged(PA, args, scale, cap)
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:77",
                max_abs_err=main_err, **t,
                shape=f"q [{MAX_NUM_SEQS},16,128], slot cache "
                      f"[{MAX_NUM_SEQS},{max_len},16,128] bf16, ps={ps}, "
                      f"lengths {main_lens}, {n_split} splits",
                models=extra)


def decode_lens(max_len: int, prompt_lens):
    """Each of the first MAX_NUM_SEQS requests' cache length half way
    through its decode."""
    return [min(n + MAX_NEW // 2, max_len) for n in prompt_lens[:MAX_NUM_SEQS]]


def time_paged(PA, args, scale: float, softcap: float = 0.0):
    """Kernel, plain and library times for one decode attention over an
    identity-paged cache (the engine's dense slot cache), beside the
    card's bound.  The library call is SDPA on the dense cache, masked to
    each length; under a softcap, flex_attention with the cap as its
    score_mod and the lengths as its block mask, and SDPA without the cap
    is timed apart (``sdpa_without_softcap_*``, a different function).
    Each is held against the plain version before it is timed."""
    q, kp, vp, pt, ln = args
    B, H, D = q.shape
    _, ps, KVH, _ = kp.shape
    T = pt.shape[1] * ps
    # identity page table: the pages are the dense [B, T, KVH, D] cache
    kd = kp.view(B, T, KVH, D).transpose(1, 2)
    vd = vp.view(B, T, KVH, D).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None] < ln[:, None].long())
    mask = mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask, scale=scale,
            enable_gqa=KVH != H)

    want = PA.paged_attention_plain(*args, scale=scale, softcap=softcap)
    library = {}
    if not softcap and same_function("sdpa", sdpa()[:, :, 0], want):
        library["sdpa"] = sdpa
    if softcap:
        held = ln.clamp(max=T)

        def mask_mod(b, h, q_idx, kv_idx):
            return kv_idx < held[b]
        flex = flex_call(q[:, :, None], kd, vd, want[:, None], scale=scale,
                         softcap=softcap, mask_mod=mask_mod, B=B)
        if flex is not None:
            library["flex_attention"] = flex
    t = kernel_times(
        lambda: PA.paged_attention_cuda(*args, scale=scale, softcap=softcap),
        lambda: PA.paged_attention_plain(*args, scale=scale,
                                         softcap=softcap),
        library)
    if softcap:
        t["sdpa_without_softcap_ms"] = time_ms(sdpa, 50)
        t["sdpa_without_softcap_device_ms"] = time_held(sdpa, 50)[0]
    lens = [min(int(n), T) for n in ln.tolist()]
    n_tok = sum(lens)
    elt = q.element_size()
    flops = 4.0 * H * D * n_tok
    nbytes = (2 * q.numel() * elt                   # q read, out written
              + 2 * n_tok * KVH * D * elt           # the K and V rows used
              + sum(math.ceil(n / ps) for n in lens) * 4
              + B * 4)                              # page-table rows, lengths
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(t, bound_ms=bound_ms, bound_by=bound_by)


def ssd_inputs(B, S, H, P, G, N, dt_type, gen, *, init):
    """tests/test_kernels.py's SSD inputs (softplus dt, A < 0, B/C * 0.5)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    args = (randn(B, S, H, P).to(dt_type), F.softplus(randn(B, S, H)),
            -torch.exp(randn(H) * 0.3), (randn(B, S, G, N) * 0.5).to(dt_type),
            (randn(B, S, G, N) * 0.5).to(dt_type))
    return args, (randn(B, H, P, N) if init else None)


def ssd_shape(cfg, S: int):
    """(B, S, H, P, G, N, chunk) of a model's SSD scan over an S-token
    prefill at batch 1."""
    s = cfg.ssm
    return (1, S, s.expand * cfg.d_model // s.head_dim, s.head_dim,
            s.ngroups, s.state_dim, s.chunk_size)


def ssd_cases(S: int, models):
    """(label, (B, S, H, P, G, N, chunk), dtype, init) — the sweeps of
    tests/test_kernels.py, the bf16 kernel's 64-row tile and chunk edges
    at mamba2-780m's widths, the reduced model's and the widest shapes,
    then the engine's prefill at the longest prompt, then each hybrid
    model's (``models``: (cfg, its longest prompt)) in both types."""
    main = (1, S, 48, 64, 1, 128, 256)          # mamba2-780m's prefill
    cases = []
    for dt_type in (torch.float32, torch.bfloat16):
        for shape in [(2, 64, 2, 16, 1, 16, 16), (2, 70, 4, 16, 2, 32, 32),
                      (2, 32, 8, 64, 1, 128, 8)]:
            cases.append(("sweep", shape, dt_type, False))
        cases.append(("initial state", (1, 40, 2, 16, 1, 16, 16), dt_type,
                      True))
    for init in (False, True):
        for S_, chunk in [(63, 256), (64, 256), (65, 256), (255, 256),
                          (256, 256), (257, 256), (1024, 256), (300, 64),
                          (300, 128)]:
            cases.append(("edge", (1, S_, 48, 64, 1, 128, chunk),
                          torch.bfloat16, init))
        cases += [("reduced", (2, 100, 16, 16, 1, 16, 32), torch.bfloat16,
                   init),
                  ("P=N=128", (1, 300, 4, 128, 1, 128, 256), torch.bfloat16,
                   init),
                  ("main", main, torch.bfloat16, init)]
    for cfg, S_ in models:
        for dt_type in (torch.float32, torch.bfloat16):
            for init in (False, True):
                cases.append((cfg.name, ssd_shape(cfg, S_), dt_type, init))
    return main, cases


def check_ssd(prompt_lens, models, gen):
    """``models``: (cfg, its longest prompt) for each hybrid model, whose
    scan runs at its own heads."""
    from repro_torch.kernels import ssd_scan as SSD
    S = max(prompt_lens)
    main, cases = ssd_cases(S, models)
    main_err, errs = 0.0, {}
    for label, (B, S_, H, P, G, N, chunk), dt_type, init in cases:
        args, st = ssd_inputs(B, S_, H, P, G, N, dt_type, gen, init=init)
        variant = "wgmma" if dt_type == torch.bfloat16 else "cuda_core"
        before = SSD.ssd_scan_cuda.variant_launches[variant]
        y, fin = SSD.ssd_scan_cuda(*args, chunk=chunk, initial_state=st)
        torch.cuda.synchronize()
        require(SSD.ssd_scan_cuda.variant_launches[variant] == before + 1,
                f"ssd_scan {label}: {str(dt_type)[6:]} did not run the "
                f"{variant} kernel")
        y_ref, fin_ref = SSD.ssd_scan_plain(*args, chunk=chunk,
                                            initial_state=st)
        name = (f"ssd_scan {label} [{B},{S_},{H},{P}] G={G} N={N} "
                f"chunk={chunk} init={init} {str(dt_type)[6:]} ({variant})")
        err = max(check_close(f"{name} y", y, y_ref, dt_type, SSD_TOL),
                  check_close(f"{name} final state", fin, fin_ref, dt_type,
                              SSD_TOL))
        if label == "main":
            main_err = max(main_err, err)
        elif dt_type == torch.bfloat16:
            errs[label] = max(errs.get(label, 0.0), err)
        print(f"  {name}: max_abs_err={err:.3g}")

    # timing at each hybrid model's shape (its own row), then at the
    # engine's longest prompt at mamba2-780m's, each with the initial state
    # the engine's prefill passes (the zeroed slot state)
    extra = []
    for cfg, S_ in models:
        t = time_ssd(SSD, ssd_shape(cfg, S_), gen)
        t["model"], t["variant"] = cfg.name, "wgmma"
        t["max_abs_err"] = errs[cfg.name]
        print(f"  ssd_scan at {t['shape']}: {times_text(t)}")
        extra.append(t)
    t = time_ssd(SSD, main, gen)
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:81",
                max_abs_err=main_err, **t, models=extra)


def time_ssd(SSD, shape, gen):
    """Kernel and plain times of one bf16 scan, beside the card's bound;
    no PyTorch call computes a selective chunked scan."""
    B, S, H, P, G, N, chunk = shape
    args, st = ssd_inputs(B, S, H, P, G, N, torch.bfloat16, gen, init=True)
    t = kernel_times(
        lambda: SSD.ssd_scan_cuda(*args, chunk=chunk, initial_state=st),
        lambda: SSD.ssd_scan_plain(*args, chunk=chunk, initial_state=st),
        {})
    flops = ssd_flops(B, S, H, P, N, chunk)
    x, dt, A, Bm, Cm = args
    nbytes = (2 * x.numel() * x.element_size()      # x read, y written
              + 2 * Bm.numel() * Bm.element_size()  # B, C read
              + dt.numel() * 4 + A.numel() * 4
              + 2 * st.numel() * 4)                 # state in and out
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(t, bound_ms=bound_ms, bound_by=bound_by,
                shape=f"x [{B},{S},{H},{P}] bf16, B/C [{B},{S},{G},{N}] "
                      f"bf16, state [{B},{H},{P},{N}] fp32, chunk {chunk}")


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int,
              backward: bool = False) -> float:
    """Operations of one scan (or its backward) over S tokens: a chunk of q
    rows and a head take q (q + 1)(N + P) + 4 q N P forward (C B^T, the
    masked W x, the state's two products), and q (q + 1)(3 N + 2 P) +
    10 q N P backward (C B^T and dy x^T again, and the three products of
    dx, dB and dC over the rows; the state terms of br, dB and dC, and
    dS_c, E_c and S_{c-1}^T dy's two products)."""
    rows = [min(chunk, S - t0) for t0 in range(0, S, chunk)]
    if backward:
        return B * H * sum(q * (q + 1) * (3 * N + 2 * P) + 10 * q * N * P
                           for q in rows)
    return B * H * sum(q * (q + 1) * (N + P) + 4 * q * N * P for q in rows)


def ssd_bwd_cases():
    """(label, (B, S, H, P, G, N, chunk), dtype, initial state and dfinal)
    of the SSD backward kernel: mamba2-780m's training batch first (the
    kernels line's row), its .reduced() widths, G > 1, jamba-1.5-large's
    256 heads over one group, a ragged tail, S below the chunk, an initial
    state with a final state's gradient, every width at its edges, the
    64-row tile edges; then fp32."""
    bf16, f32 = torch.bfloat16, torch.float32
    train = (TRAIN_B, TRAIN_S, 48, 64, 1, 128, 256)
    cases = [("mamba2-780m training", train, bf16, False),
             ("mamba2-780m .reduced()", (2, 128, 16, 16, 1, 16, 32), bf16,
              False),
             ("G=2", (2, 300, 8, 64, 2, 128, 64), bf16, False),
             ("jamba-1.5-large heads, 256 over one group",
              (1, 1024, 256, 64, 1, 128, 256), bf16, False),
             ("ragged tail", (2, 333, 4, 64, 1, 128, 128), bf16, False),
             ("S < chunk", (1, 20, 2, 32, 1, 32, 256), bf16, True),
             ("initial state and dfinal", (2, 200, 4, 32, 2, 64, 64), bf16,
              True),
             ("P=N=128", (1, 300, 4, 128, 1, 128, 256), bf16, True),
             ("P=128 N=16 G=4", (1, 150, 8, 128, 4, 16, 32), bf16, True),
             ("P=16 N=128", (2, 70, 4, 16, 1, 128, 64), bf16, False)]
    # the bf16 kernel's 64-row tile edges at mamba2-780m's widths
    edges = [(f"tile edge S={S} chunk={chunk}", (2, S, 8, 64, 1, 128, chunk),
              bf16, init)
             for chunk in (64, 256) for S in (63, 64, 65, 129)
             for init in (False, True)]
    return cases + edges + [(label, shape, f32, init)
                            for label, shape, _, init in cases
                            if label in ("mamba2-780m training",
                                         "ragged tail",
                                         "initial state and dfinal",
                                         "P=N=128")]


def ssd_bwd_inputs(shape, dtype, gen, init: bool):
    """The scan's inputs (ssd_inputs), dy in x's dtype, and with ``init``
    an initial state and a final state's gradient."""
    B, S, H, P, G, N, _ = shape
    args, st = ssd_inputs(B, S, H, P, G, N, dtype, gen, init=init)
    dy = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dtype)
    dfinal = (torch.randn(B, H, P, N, generator=gen, device="cuda")
              if init else None)
    return args, st, dy, dfinal


def check_ssd_bwd(gen):
    """The SSD backward kernel against its plain version at every case,
    from the same inputs and cotangents: each gradient within
    SSD_BWD_REL_TOL of its norm, the four passes launched once each, bf16
    on the tensor cores and fp32 on CUDA cores; then its times, and each
    pass's, at mamba2-780m's training shape, jamba-1.5-large's heads and
    in fp32."""
    from repro_torch.kernels import ssd_scan as SSD
    main_err = 0.0
    for label, shape, dt, init in ssd_bwd_cases():
        args, st, dy, dfinal = ssd_bwd_inputs(shape, dt, gen, init)
        B, S, H, P, G, N, chunk = shape
        kw = dict(chunk=chunk, initial_state=st)
        name = (f"ssd_scan_bwd {label} x [{B},{S},{H},{P}] G={G} N={N} "
                f"chunk={chunk} init={init} {str(dt)[6:]}")
        before = dict(SSD.ssd_scan_bwd_cuda.pass_launches)
        variant = "wgmma" if dt == torch.bfloat16 else "cuda_core"
        before_variant = dict(SSD.ssd_scan_bwd_cuda.variant_launches)
        got = SSD.ssd_scan_bwd_cuda(*args, dy, dfinal, **kw)
        torch.cuda.synchronize()
        require(all(SSD.ssd_scan_bwd_cuda.pass_launches[p] == before[p] + 1
                    for p in SSD.BWD_PASSES),
                f"{name}: the passes {SSD.BWD_PASSES} did not each launch "
                f"once")
        require(SSD.ssd_scan_bwd_cuda.variant_launches == {
                    v: n + (v == variant) for v, n in before_variant.items()},
                f"{name}: ran {SSD.ssd_scan_bwd_cuda.variant_launches} "
                f"(before {before_variant}), not the {variant} kernels")
        want = SSD.ssd_scan_bwd_plain(*args, dy, dfinal, **kw)
        rels, errs = [], []
        for grad, g, w in zip(SSD_GRADS, got, want):
            if w is None:
                require(g is None, f"{name}: {grad} without an initial "
                                   f"state")
                continue
            rel = rel_err(g, w)
            tol = SSD_DA_REL_TOL if grad == "dA" else SSD_BWD_REL_TOL[dt]
            require(g.dtype == w.dtype and g.shape == w.shape and rel < tol,
                    f"{name}: {grad} is {rel:.3g} of its norm from the "
                    f"plain version's (bound {tol})")
            rels.append(f"{grad} {rel:.3g}")
            errs.append(max_err(g, w))
        if label == "mamba2-780m training" and dt == torch.bfloat16:
            main_err = max(errs)
        print(f"  {name}: rel_err {', '.join(rels)}; max_abs_err "
              f"{max(errs):.3g}")
        del args, st, dy, dfinal, got, want
    t = time_ssd_bwd(SSD, ssd_bwd_cases()[0][1], torch.bfloat16, gen)
    extra = []
    for model, shape, dt in (
            ("jamba-1.5-large heads", (1, TRAIN_S, 256, 64, 1, 128, 256),
             torch.bfloat16),
            ("mamba2-780m training, fp32", ssd_bwd_cases()[0][1],
             torch.float32)):
        r = time_ssd_bwd(SSD, shape, dt, gen)
        r["model"], r["main_path"], r["launches"] = model, False, 0
        extra.append(r)
    for r in [t, *extra]:
        print(f"  ssd_scan_bwd at {r['shape']}: {times_text(r)} "
              f"(at fp32's CUDA cores: bound {r['bound_fp32_ms']!r} ms); "
              f"device ms by pass {r['pass_device_ms']} (by kernel "
              f"{r['kernel_device_ms']})")
    return dict(name="ssd_scan_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                replaces="src/repro/models/mamba2.py:79",
                replaces_note=("no Pallas kernel has a backward: the JAX "
                               "model trains Mamba-2 through ssd_chunked, "
                               "which XLA differentiates"),
                max_abs_err=main_err, **t, models=extra)


def time_logits(gen) -> None:
    """``Model._logits`` at each LOGITS_ARCHS head and LOGITS_ROWS rows:
    the product served under inference mode (``bf16_f32``: the bf16 head
    read once, fp32 sums and logits) beside the widened one the training
    loss takes (``widened_f32``: the head widened to fp32 in
    LOGITS_CHUNK_BYTES strips), each timed by time_ms and time_held, the
    kernels the served one launches with their device ms, and the bound
    (the head, x and the fp32 logits moved once) with the served
    product's share of it.  Gates: the served call counts as
    ``bf16_f32``, and it agrees with the widened one in argmax and within
    LOGITS_REL_TOL of its norm."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import model as TM
    for arch in LOGITS_ARCHS:
        cfg = get_config(arch)
        require(not cfg.tie_embeddings, f"{arch}: a tied head")
        m = build_model(cfg)
        d, V = cfg.d_model, cfg.vocab_size
        head = torch.randn(d, V, generator=gen, device="cuda",
                           dtype=torch.bfloat16).mul_(d ** -0.5)
        params = {"head": head}
        for M in LOGITS_ROWS:
            x = torch.randn(M, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16)

            def served():
                return m._logits(params, x)

            def widened():
                return m._widened_logits(head, "...d,dv->...v", 1, x)

            with torch.inference_mode():
                before = TM.LOGITS_PRODUCTS["bf16_f32"]
                got = served()
                require(TM.LOGITS_PRODUCTS["bf16_f32"] == before + 1,
                        f"logits {arch} M={M}: not the bf16_f32 product")
                want = widened()
                err = rel_err(got, want)
                require(err < LOGITS_REL_TOL and torch.equal(
                    got.argmax(-1), want.argmax(-1)),
                    f"logits {arch} M={M}: {err!r} of the widened product's "
                    f"norm, or another argmax")
                del got, want
                ms, wide_ms = time_ms(served, 50), time_ms(widened, 10)
                device_ms, host_us = time_held(served, 50)
                wide_device_ms, _ = time_held(widened, 10)
                kernels = kernel_device_ms(served, 20)
            bound_ms, by = bound(2.0 * M * d * V,
                                 2.0 * d * V + 2.0 * M * d + 4.0 * M * V)
            print(f"[logits] {arch} head [{d}, {V}] bf16, M={M}: bf16_f32 "
                  f"ms={ms!r} device_ms={device_ms!r} host_us={host_us!r} "
                  f"(" + ", ".join(f"{k} {v!r}" for k, v in kernels.items())
                  + f"); widened_f32 ms={wide_ms!r} "
                  f"device_ms={wide_device_ms!r}; bound_ms={bound_ms!r} "
                  f"({by}), {100.0 * bound_ms / device_ms!r} % of the "
                  f"served device ms; rel diff {err!r}, argmax agrees")
        del head, params
        torch.cuda.empty_cache()


def kernel_device_ms(call, iters: int):
    """Device ms of each kernel a call launches, from a torch.profiler
    trace of ``iters`` calls after one warm-up call, by the kernel's
    name (``ssd_bwd_rows_i<64, 128>`` as ``ssd_bwd_rows_i``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^(?:void )?(?:\(anonymous namespace\)::)?", "",
                          e.key).split("<")[0]
            out[name] = out.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / iters
    return out


def time_ssd_bwd(SSD, shape, dtype, gen):
    """Kernel and plain times of the backward (no initial state, as in
    training), beside the card's bound: ssd_flops' backward operations at
    the inputs' type's peak (bf16: the tensor cores'; the kernel runs them
    on fp32 CUDA cores, whose bound stands beside it as bound_fp32_ms), x,
    dy, B, C and dt read once, dx, dB, dC and ddt written once.  No
    PyTorch call computes it."""
    B, S, H, P, G, N, chunk = shape
    args, _, dy, _ = ssd_bwd_inputs(shape, dtype, gen, False)
    kw = dict(chunk=chunk)
    t = kernel_times(lambda: SSD.ssd_scan_bwd_cuda(*args, dy, **kw),
                     lambda: SSD.ssd_scan_bwd_plain(*args, dy, **kw), {},
                     iters=10)
    x, dt, A, Bm, Cm = args
    flops = ssd_flops(B, S, H, P, N, chunk, backward=True)
    nbytes = (3 * x.numel() * x.element_size()      # x, dy read, dx written
              + 4 * Bm.numel() * Bm.element_size()  # B, C read, dB, dC
              + 2 * dt.numel() * 4 + 2 * A.numel() * 4)   # dt/ddt, A/dA
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    bound_ms, bound_by = bound(flops, nbytes, peak)
    by_kernel = kernel_device_ms(
        lambda: SSD.ssd_scan_bwd_cuda(*args, dy, **kw), 5)
    t["kernel_device_ms"] = by_kernel
    t["pass_device_ms"] = {
        p: sum(ms for k, ms in by_kernel.items()
               if k.startswith(f"ssd_bwd_{p}")) for p in SSD.BWD_PASSES}
    return dict(t, bound_ms=bound_ms, bound_by=bound_by,
                bound_fp32_ms=bound(flops, nbytes, PEAK_FP32_FLOPS)[0],
                flops=flops, bytes=nbytes,
                shape=f"x/dy [{B},{S},{H},{P}] {str(dtype)[6:]}, B/C "
                      f"[{B},{S},{G},{N}], chunk {chunk}, no initial state")


def flash_bwd_cases():
    """(label, B, S, H, KVH, D, dtype, kwargs) of the backward kernel: the
    training shape of olmo-1b first (timed), seamless-m4t-medium's encoder
    (D = 64, not causal), G = 2 and 4, a window, a softcap that binds (q
    scaled by CAP_BOOST, as the forward's cases), and the 64-row tile
    edges (S = 1 has dq = dk = 0, rounding noise only: S = 2 stands in);
    then every other head dim the forward takes (32, 192, 256) in both
    dtypes, nemotron-4-340b's heads (96/8 at D = 192) and gemma2-2b's (8/4
    at D = 256, its softcap of 50 binding, with and without a window of
    1024) at 2048 tokens, a kv_len below T, and the 64-row edges at
    D = 256; the training shapes of TRAIN_FLASH sit before nemotron's."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"{TRAIN_ARCH} training", TRAIN_B, TRAIN_S, 16, 16, 128, bf16,
              {}),
             (f"{ENCDEC} encoder, not causal", ENCDEC_B, ENCDEC_FRAMES, 16,
              16, 64, bf16, dict(causal=False)),
             ("G=2", 1, 1024, 16, 8, 128, bf16, {}),
             ("G=4 window 256", 1, 1024, 16, 4, 128, bf16,
              dict(window=256))]
    for dt in (f32, bf16):
        cases += [("softcap 50, q*boost", 1, 300, 8, 4, 128, dt,
                   dict(softcap=50.0, q_boost=CAP_BOOST[dt])),
                  ("G=4 D=64 window 40 softcap 50, q*boost", 1, 300, 8, 2,
                   64, dt, dict(window=40, softcap=50.0,
                                q_boost=CAP_BOOST[dt])),
                  ("G=2 D=64 not causal", 2, 200, 8, 4, 64, dt,
                   dict(causal=False))]
        cases += [(f"edge S={S}", 1, S, 4, 2, 128, dt, {})
                  for S in (2, 63, 64, 65, 129)]
    cases += [(f"{model} {use}", TRAIN_B, TRAIN_S, H, KVH, D, dt,
               dict(causal=causal, window=window))
              for model, use, H, KVH, D, dt, causal, window in TRAIN_FLASH]
    cases += [("nemotron-4-340b heads, causal", 1, TRAIN_S, 96, 8, 192, bf16,
               {})]
    for window in (0, 1024):
        cases.append((f"gemma2-2b heads, softcap 50, window {window}, "
                      f"q*boost", 1, TRAIN_S, 8, 4, 256, bf16,
                      dict(softcap=50.0, window=window,
                           q_boost=CAP_BOOST[bf16])))
    for dt in (f32, bf16):
        for D in (32, 192, 256):
            cases += [(f"G=2 D={D}", 1, 200, 8, 4, D, dt, {}),
                      (f"G=4 D={D} window 40 softcap 50, q*boost", 1, 150, 8,
                       2, D, dt, dict(window=40, softcap=50.0,
                                      q_boost=CAP_BOOST[dt])),
                      (f"D={D} not causal, kv_len 150 of T=200", 1, 200, 4,
                       2, D, dt, dict(causal=False, kv_len=150))]
        cases += [("D=256 causal, kv_len 300 of T=400", 1, 400, 8, 4, 256,
                   dt, dict(kv_len=300))]
        cases += [(f"edge S={S} D=256", 1, S, 4, 2, 256, dt, {})
                  for S in (2, 63, 64, 65, 129)]
    return cases


def lse_want(q, k, *, causal=True, scale, window=0, softcap=0.0,
             kv_len=None):
    """torch.logsumexp of the plain scores: scaled, capped, masked, fp32
    [B, H, S]."""
    S, G = q.shape[1], q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, dim=2)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)
    ok = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[None] <= pos[:, None]
    if window:
        ok &= pos[None] > pos[:, None] - window
    if kv_len is not None:
        ok &= pos[None] < kv_len
    return torch.logsumexp(torch.where(ok, s, -1e30), dim=-1)


def check_flash_bwd(gen):
    """The backward kernel against its plain version at every case, from
    the same q, k, v, dO and the forward kernel's own output and lse (the
    lse first held against torch.logsumexp of the plain scores); then its
    times at the training shape."""
    from repro_torch.kernels import flash_attention as FA
    main_err = 0.0
    for label, B, S, H, KVH, D, dt, kw in flash_bwd_cases():
        kw = dict(kw, scale=D ** -0.5)
        boost = kw.pop("q_boost", 1.0)
        q = (torch.randn(B, S, H, D, generator=gen, device="cuda")
             * boost).to(dt)
        k, v = (torch.randn(B, S, KVH, D, generator=gen, device="cuda")
                .to(dt) for _ in range(2))
        dout = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
        name = (f"flash_attention_bwd {label} q [{B},{S},{H},{D}] k/v "
                f"[{B},{S},{KVH},{D}] {str(dt)[6:]}")
        out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        want_lse = lse_want(q, k, **kw)
        lse_err = max_err(lse, want_lse)
        require(bool(torch.allclose(lse, want_lse, rtol=LSE_TOL,
                                    atol=LSE_TOL)),
                f"{name}: the forward's lse is {lse_err:.3g} from "
                f"logsumexp of the plain scores")
        del want_lse
        before = dict(FA.flash_attention_bwd_cuda.pass_launches)
        got = FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        require(all(FA.flash_attention_bwd_cuda.pass_launches[p]
                    == before[p] + 1 for p in FA.BWD_PASSES),
                f"{name}: the passes {FA.BWD_PASSES} did not each launch "
                f"once")
        want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
        errs, rels = [], []
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            rel = rel_err(g, w)
            require(rel < BWD_REL_TOL[dt],
                    f"{name}: {grad} is {rel:.3g} of its norm from the plain "
                    f"version's (bound {BWD_REL_TOL[dt]})")
            errs.append(max_err(g, w))
            rels.append(rel)
        if kw.get("kv_len") is not None:    # keys past kv_len: no gradient
            require(all(float(g[:, kw["kv_len"]:].abs().max()) == 0.0
                        for g in got[1:]),
                    f"{name}: dk or dv is not zero past kv_len")
        text = (f"lse max_abs_err={lse_err:.3g}; dq/dk/dv rel_err="
                f"{'/'.join(f'{r:.3g}' for r in rels)} max_abs_err="
                f"{max(errs):.3g}")
        if kw.get("softcap"):
            o0, lse0 = FA.flash_attention_plain(q, k, v, return_lse=True,
                                                **dict(kw, softcap=0.0))
            uncapped = FA.flash_attention_bwd_plain(
                q, k, v, o0, lse0, dout, **dict(kw, softcap=0.0))
            moved = rel_err(uncapped[0], want[0])
            require(moved > 10 * BWD_REL_TOL[dt],
                    f"{name}: the softcap does not bind (without it dq "
                    f"moves {moved:.3g} of its norm)")
            text += f" (without the cap the plain dq moves {moved:.3g})"
        if label == f"{TRAIN_ARCH} training":
            main_err = max(errs)
        print(f"  {name}: {text}")
        del q, k, v, dout, out, lse, got, want
    # olmo-1b's training shape (the kernels line's own), then gemma2-2b's
    # and nemotron-4-340b's heads at 2048 tokens, then olmo-1b's in fp32
    t = time_flash_bwd(FA, gen, TRAIN_B, 16, 16, 128)
    extra = []
    for model, B, H, KVH, D, cap, dt, main_path in (
            ("gemma2-2b training", TRAIN_B, 8, 4, 256, 50.0, torch.bfloat16,
             True),
            ("nemotron-4-340b", 1, 96, 8, 192, 0.0, torch.bfloat16, False),
            (f"{TRAIN_ARCH}, fp32", TRAIN_B, 16, 16, 128, 0.0, torch.float32,
             False)):
        r = time_flash_bwd(FA, gen, B, H, KVH, D, softcap=cap, dtype=dt)
        r["model"], r["main_path"] = model, main_path
        if not main_path:
            r["launches"] = 0           # no main path trains it
        print(f"  flash_attention_bwd at {r['shape']}: {times_text(r)}")
        print_beside("flash_attention_bwd", r)
        extra.append(r)
    # the training paths added last (the encoder-decoder's rows take their
    # launches by causality in main)
    for model, use, H, KVH, D, dt, causal, window in TRAIN_FLASH:
        r = time_flash_bwd(FA, gen, TRAIN_B, H, KVH, D, dtype=dt,
                           causal=causal, window=window)
        r["model"], r["use"], r["causal"] = model, use, causal
        print(f"  flash_attention_bwd at {r['shape']}: {times_text(r)}")
        print_beside("flash_attention_bwd", r)
        extra.append(r)
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/layers.py:170",
                replaces_note=("no Pallas kernel has a backward: the JAX "
                               "model trains through blocked_attention, "
                               "which XLA differentiates"),
                max_abs_err=main_err, **t, models=extra)


def flex_backward_call(q, k, v, dout, *, scale: float, softcap: float):
    """``torch.autograd.grad`` through one compiled ``flex_attention``
    forward (causal block mask, the softcap as its score_mod, GQA by
    enable_gqa), kept with retain_graph: (dq, dk, dv) as [B, H, S, D]
    views.  Compiled here, outside any timing, after dynamo's caches are
    cleared."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / softcap) * softcap

    def mask_mod(b, h, q_idx, kv_idx):
        return q_idx >= kv_idx

    torch._dynamo.reset()
    flex = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    block_mask = create_block_mask(mask_mod, B=None, H=None,
                                   Q_LEN=q.shape[1], KV_LEN=k.shape[1],
                                   device=q.device)
    out = flex(qt, kt, vt, score_mod=score_mod, block_mask=block_mask,
               scale=scale, enable_gqa=q.shape[2] != k.shape[2])
    dout_t = dout.transpose(1, 2)

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dout_t,
                                   retain_graph=True)
    return call


def library_backward(what: str, call, want):
    """``{what: call}`` if the call's gradients are each within the
    kernel's own bound of the plain version's (then it computes the same
    function, and its time may stand beside the kernel's), else {}."""
    t0 = time.monotonic()
    got = call()
    torch.cuda.synchronize()
    dt = want[0].dtype
    rels = [rel_err(g.transpose(1, 2), w) for g, w in zip(got, want)]
    agrees = all(r < BWD_REL_TOL[dt] for r in rels)
    print(f"    {what} (first call {time.monotonic() - t0:.1f} s) against "
          f"the plain version: dq/dk/dv rel_err="
          f"{'/'.join(f'{r:.3g}' for r in rels)}: "
          + ("the same function" if agrees else
             "DISAGREES, so no library time is reported for it"))
    return {what: call} if agrees else {}


def time_flash_bwd(FA, gen, B, H, KVH, D, softcap=0.0,
                   dtype=torch.bfloat16, causal=True, window=0):
    """Kernel, plain and library times of the backward at q/dO
    [B, 2048, H, D], k/v [B, 2048, KVH, D], causal or not, under a window
    (one of 2048 or more binds nowhere), beside the card's bound (fp32 at
    fp32's peak): five products of 2 D operations a (q, k) pair and head; q, k,
    v, o, dO and lse read once, dq, dk, dv written once.  The library call
    (``torch.autograd.grad`` through one forward, kept with retain_graph,
    held against the plain version first) is SDPA's backward, or under a
    softcap flex_attention's with the cap as its score_mod; SDPA's
    backward without the cap (a different function) stands beside it."""
    S = TRAIN_S
    if window and window < S:
        raise ValueError("time_flash_bwd: SDPA's backward is timed without "
                         "a window mask; a window must not bind")
    kw = dict(causal=causal, scale=D ** -0.5, softcap=softcap, window=window)
    q, dout = (torch.randn(B, S, H, D, generator=gen, device="cuda")
               .to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, KVH, D, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            scale=kw["scale"],
                                            enable_gqa=KVH != H)
    dout_t = dout.transpose(1, 2)

    def sdpa_backward():
        return torch.autograd.grad(o_sdpa, (qt, kt, vt), dout_t,
                                   retain_graph=True)

    if softcap:
        library = library_backward(
            "flex_attention_backward",
            flex_backward_call(q, k, v, dout, scale=kw["scale"],
                               softcap=softcap), want)
    else:
        library = library_backward("sdpa_backward", sdpa_backward, want)
    del want
    t = kernel_times(
        lambda: FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw),
        lambda: FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw),
        library, iters=10)
    if softcap:
        t["sdpa_without_softcap_ms"] = time_ms(sdpa_backward, 10)
        t["sdpa_without_softcap_device_ms"] = time_held(sdpa_backward, 10)[0]
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 10.0 * H * D * B * pairs
    # q, o, dO, dq and k, v, dk, dv, once each, and lse
    nbytes = 4 * (q.numel() + k.numel()) * q.element_size() + lse.numel() * 4
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS
                               if dtype == torch.bfloat16
                               else PEAK_FP32_FLOPS)
    return dict(t, bound_ms=bound_ms, bound_by=bound_by,
                shape=(f"q/dO [{B},{S},{H},{D}], k/v [{B},{S},{KVH},{D}] "
                       f"{str(dtype)[6:]} " + ("causal" if causal else
                                               "not causal")
                       + (f", window {window}" if window else "")
                       + (f", softcap {softcap:g}" if softcap else "")))


# -------------------------------------------------------------------- model

def prefill_decode(model, params, toks, P: int, batch=None):
    """Prefill ``toks[:, :P]`` (or ``batch``: a VLM's first P embeds and
    positions, an encoder-decoder's frames and first P target tokens),
    then decode the rest of ``toks`` teacher-forced.  Returns
    (logits [B, S-P+1, V], prefill ms, ms a decode step, the cache), the
    times on the host clock to a synchronize."""
    B, S = toks.shape
    cache = model.init_cache(B, S, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    lg, cache, _ = model.prefill(
        params, batch or {"tokens": toks[:, :P]}, cache)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    steps = [lg]
    for t in range(P, S):
        lg, cache = model.decode(params, toks[:, t], cache,
                                 torch.full((B,), t, dtype=torch.int32,
                                            device="cuda"))
        steps.append(lg)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    return (torch.stack(steps, 1), 1e3 * (t1 - t0),
            1e3 * (t2 - t1) / (S - P), cache)


def compare_logits(what: str, got, ref, moe: bool = False) -> float:
    """Print and gate logits [B, n, V]: max softmax error below 0.05 and
    tie-aware argmax agreement at every position
    (tests/test_models_decode.py); an MoE model (``moe``) under that
    file's MoE bounds: the median over positions of each one's softmax
    error below 0.05, tie-aware agreement at MOE_MIN_AGREE of them."""
    p_got, p_ref = got.softmax(-1), ref.softmax(-1)
    prob_err = max_err(p_got, p_ref)
    a_got, a_ref = got.argmax(-1), ref.argmax(-1)
    p_top = p_ref.gather(-1, a_ref[..., None])[..., 0]
    p_picked = p_ref.gather(-1, a_got[..., None])[..., 0]
    agree = ((a_got == a_ref) | (p_top - p_picked < TIE_EPS)).all(0)
    tie_agree = bool(agree.all())
    exact = float((a_got == a_ref).float().mean())
    print(f"  model: {what}: max softmax err {prob_err:.3g} (bound 0.05; "
          f"prefill position {max_err(p_got[:, 0], p_ref[:, 0]):.3g}), "
          f"logits max abs diff {max_err(got, ref):.3g}, exact argmax "
          f"agreement {exact:.3f}, tie-aware agreement {tie_agree}")
    if moe:
        per_pos = (p_got.float() - p_ref.float()).abs().amax(dim=(0, 2))
        median = float(per_pos.median())
        share = float(agree.float().mean())
        print(f"  model: {what}: MoE bounds: median softmax err {median:.3g} "
              f"(bound 0.05), tie-aware agreement at {share:.3f} of the "
              f"positions (bound {MOE_MIN_AGREE})")
        require(median < 0.05, f"model: {what}: median softmax error "
                               f"{median}")
        require(share >= MOE_MIN_AGREE, f"model: {what}: tie-aware "
                                        f"agreement {share}")
        return prob_err
    require(prob_err < 0.05, f"model: {what}: softmax error {prob_err}")
    require(tie_agree, f"model: {what}: argmax disagrees beyond tie_eps")
    return prob_err


def check_model(cfg, params, seed: int, B: int = 2, P: int = 256):
    """The kernel path's prefill of B x P tokens plus decode against the
    plain path's teacher-forced forward (the gate of
    tests/test_models_decode.py), and against the plain path's own prefill
    plus decode (the same steps, so only the kernels, and an MoE model's
    dispatch, differ).  The plain forward routes dropless, as prefill and
    decode do.  The fp32 logits are built only at the positions compared."""
    from repro_torch.models import build_model
    kernel = build_model(cfg)
    plain = build_model(cfg, attn_impl="plain")
    rng = np.random.default_rng(seed + 1)
    S = P + MODEL_DECODE_STEPS
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                        dtype=torch.long, device="cuda")
    with torch.inference_mode():
        x, _ = plain.forward(params, {"tokens": toks}, dropless=True)
        ref = plain._logits(params, x[:, P - 1:])          # [B, 17, V]
    got, prefill_ms, step_ms, _ = prefill_decode(kernel, params, toks, P)
    print(f"  model: kernel path, host clock to a synchronize: prefill "
          f"{B}x{P} {prefill_ms!r} ms, decode step (batch {B}) "
          f"{step_ms!r} ms")
    require(bool(torch.isfinite(got).all()), "model: non-finite logits")
    require(tuple(got.shape) == (B, S - P + 1, cfg.vocab_size),
            f"model: logits shape {tuple(got.shape)}")
    steps = f"{B}x{P} prompt + {MODEL_DECODE_STEPS} decode steps"
    moe = cfg.moe is not None
    prob_err = compare_logits(
        f"{steps}, kernel path vs plain path teacher-forced", got, ref, moe)
    if cfg.attention_free:
        where = "within" if prob_err < SSM_DECODE_EXACT else "above"
        print(f"  model: max softmax err {prob_err:.3g} is {where} the "
              f"{SSM_DECODE_EXACT} of tests/test_models_decode.py::"
              f"test_mamba2_decode_exact (reported, not gated)")
    same = prefill_decode(plain, params, toks, P)[0]
    compare_logits(f"{steps}, kernel path vs plain path, the same steps",
                   got, same, moe)


def check_softcap_binds(cfg, params, seed: int, boost: float = 100.0,
                        P: int = 256) -> None:
    """The model phase's check at B = 1 and P tokens with every query
    projection scaled by ``boost``, so the attention scores pass the logit
    softcap: the kernel path must match the plain path under
    compare_logits' gates, and its logits must lie five times closer (mean
    absolute difference) to the plain path's than the plain path without
    the cap does, so a kernel path that lost the cap would fail."""
    from repro_torch.models import build_model
    boosted = dict(params, blocks=[
        dict(b, attn=dict(b["attn"], wq=b["attn"]["wq"] * boost))
        for b in params["blocks"]])
    rng = np.random.default_rng(seed + 3)
    S = P + MODEL_DECODE_STEPS
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                        dtype=torch.long, device="cuda")
    refs = []
    with torch.inference_mode():
        for c in (cfg, dataclasses.replace(cfg, attn_logit_softcap=0.0)):
            plain = build_model(c, attn_impl="plain")
            x, _ = plain.forward(boosted, {"tokens": toks})
            refs.append(plain._logits(boosted, x[:, P - 1:]).float())
    got = prefill_decode(build_model(cfg), boosted, toks, P)[0]
    what = (f"query projections x{boost:g}, 1x{P} prompt + "
            f"{MODEL_DECODE_STEPS} decode steps")
    compare_logits(f"{what}, kernel path vs plain path teacher-forced",
                   got, refs[0])
    err = float((got.float() - refs[0]).abs().mean())
    moved = float((refs[1] - refs[0]).abs().mean())
    p_moved = max_err(refs[0].softmax(-1), refs[1].softmax(-1))
    print(f"  model: {what}: mean |logit difference| kernel vs plain "
          f"{err:.3g}, plain without the softcap vs plain {moved:.3g} "
          f"(gate: 5x apart; the softmax moves {p_moved:.3g})")
    require(5 * err < moved, f"model: {what}: the logit softcap does not "
                             f"bind (kernel path {err:.3g} from the plain "
                             f"path, without the cap {moved:.3g})")


def print_ring_wrap(cfg, longest: int, max_len: int) -> None:
    from repro_torch.models.transformer import block_pattern, num_repeats
    T = min(max_len, cfg.sliding_window)
    rings = num_repeats(cfg) * sum(1 for d in block_pattern(cfg)
                                   if d.window)
    require(longest > T, f"{cfg.name}: the longest prompt ({longest}) "
                         f"does not pass the {T}-slot ring")
    print(f"  model: {cfg.name}'s longest engine prompt, {longest} tokens, "
          f"wraps all {rings} of its {cfg.num_layers} layers' {T}-slot ring "
          f"caches (window {cfg.sliding_window}, slot cache {max_len})")


def image_batch(cfg, params, toks, P: int, seed: int):
    """A VLM's embeds [B, S, d] and M-RoPE positions [3, B, S] for
    ``toks``: text embedded from the tokens at positions i, i, i, and an
    IMAGE_GRID x IMAGE_GRID patch grid of random bf16 embeds (std
    d_model^-0.5, as the embedding's) ending 32 tokens before P, its rows
    at t = s0, h = s0 + row, w = s0 + col.  Returns (embeds, positions,
    s0)."""
    B, S = toks.shape
    n_img = IMAGE_GRID * IMAGE_GRID
    s0 = P - 32 - n_img
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 4)
    emb = params["embed"][toks].clone()
    emb[:, s0:s0 + n_img] = (torch.randn(B, n_img, cfg.d_model,
                                         generator=gen, device="cuda")
                             * cfg.d_model ** -0.5).bfloat16()
    pos = torch.arange(S, device="cuda")[None, None].repeat(3, B, 1)
    patch = torch.arange(n_img, device="cuda")
    pos[0, :, s0:s0 + n_img] = s0
    pos[1, :, s0:s0 + n_img] = s0 + patch // IMAGE_GRID
    pos[2, :, s0:s0 + n_img] = s0 + patch % IMAGE_GRID
    return emb, pos, s0


def check_mrope(cfg, params, seed: int, B: int = 2, P: int = 320) -> None:
    """A VLM fed embeds with M-RoPE positions whose rows differ
    (``image_batch``): the kernel path's prefill of the first P positions
    plus teacher-forced decode against the plain path's forward under
    compare_logits' gates; and the plain path at replicated positions
    (plain RoPE over the same embeds) must lie five times farther
    (mean absolute logit difference) from it than the kernel path does,
    so the sections reached the logits."""
    from repro_torch.models import build_model
    rng = np.random.default_rng(seed + 5)
    S = P + MODEL_DECODE_STEPS
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                        dtype=torch.long, device="cuda")
    emb, pos, s0 = image_batch(cfg, params, toks, P, seed)
    plain = build_model(cfg, attn_impl="plain")
    refs = []
    with torch.inference_mode():
        for p in (pos, None):                 # None: arange, replicated
            x, _ = plain.forward(params, {"embeds": emb, "positions": p})
            refs.append(plain._logits(params, x[:, P - 1:]).float())
    got, prefill_ms, step_ms, _ = prefill_decode(
        build_model(cfg), params, toks, P,
        batch={"embeds": emb[:, :P], "positions": pos[..., :P]})
    what = (f"embeds {B}x{P} with a {IMAGE_GRID}x{IMAGE_GRID} patch grid at "
            f"{s0} (M-RoPE rows t/h/w differ) + {MODEL_DECODE_STEPS} "
            f"decode steps")
    print(f"  model: {what}: kernel path prefill {prefill_ms!r} ms, decode "
          f"step {step_ms!r} ms (host clock)")
    require(tuple(got.shape) == (B, S - P + 1, cfg.vocab_size),
            f"model: {what}: logits shape {tuple(got.shape)}")
    compare_logits(f"{what}, kernel path vs plain path teacher-forced",
                   got, refs[0])
    err = float((got.float() - refs[0]).abs().mean())
    moved = float((refs[1] - refs[0]).abs().mean())
    print(f"  model: {what}: mean |logit difference| kernel vs plain "
          f"{err:.3g}, replicated positions vs the image's {moved:.3g} "
          f"(gate: 5x apart; the softmax moves "
          f"{max_err(refs[0].softmax(-1), refs[1].softmax(-1)):.3g})")
    require(5 * err < moved, f"model: {what}: the M-RoPE rows do not move "
                             f"the logits (kernel path {err:.3g} from the "
                             f"plain path, replicated positions {moved:.3g})")


def check_int8(cfg, params, seed: int, B: int = 2, P: int = 256) -> None:
    """An int8 KV cache on the card: the kernel path's prefill of B x P
    tokens plus teacher-forced decode leaves every attention layer's cache
    holding torch.int8 values with scales above zero at every filled slot
    (a hybrid's Mamba layers keep their fp32 conv and SSM state); and its
    logits differ from the same model's with bf16 caches (so quantization
    ran) but stay within compare_logits' gates of them (an MoE model's
    under its MoE bounds)."""
    from repro_torch.models import build_model
    rng = np.random.default_rng(seed + 6)
    S = P + MODEL_DECODE_STEPS
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                        dtype=torch.long, device="cuda")
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    got, prefill_ms, step_ms, cache = prefill_decode(build_model(int8),
                                                     params, toks, P)
    cache = [c for c in cache if "k" in c]           # the attention layers
    for c in cache:
        require(c["k"].dtype == torch.int8 and c["v"].dtype == torch.int8,
                f"model: int8 cache holds {c['k'].dtype}/{c['v'].dtype}")
        for name in ("k_scale", "v_scale"):    # a ring is filled: T < S
            filled = c[name][:, :, :S]
            require(bool((filled > 0).all()),
                    f"model: int8 cache: {name} is zero at a filled slot")
    scales = torch.cat([c["k_scale"][:, :, :S].reshape(-1) for c in cache])
    print(f"  model: {cfg.name} int8 KV cache: k/v {cache[0]['k'].dtype}, "
          f"{tuple(cache[0]['k'].shape)} a layer group; k scales at the "
          f"{min(S, cache[0]['k'].shape[2])} filled slots in "
          f"[{float(scales.min()):.3g}, {float(scales.max()):.3g}], none "
          f"zero; kernel path prefill {B}x{P} {prefill_ms!r} ms, decode "
          f"step {step_ms!r} ms (host clock)")
    del cache
    bf16 = dataclasses.replace(cfg, kv_cache_dtype="bfloat16")
    other = prefill_decode(build_model(bf16), params, toks, P)[0]
    diff = float((got[:, 1:].float() - other[:, 1:].float()).abs().max())
    print(f"  model: int8 vs bf16 KV caches, decode steps: logits max abs "
          f"diff {diff:.3g}")
    require(diff > 0, "model: int8 and bf16 caches give the same decode "
                      "logits: the cache was not quantized")
    compare_logits(f"{B}x{P} prompt + {MODEL_DECODE_STEPS} decode steps, "
                   f"int8 KV cache vs bf16 KV cache", got, other,
                   cfg.moe is not None)


def check_moe_layer(cfg, params, prompt_len: int, seed: int) -> None:
    """The model's first MoE layer on the card (layer ``first``), at its
    full width: the
    kernel dispatch (sorted per-expert products; one-token steps batched
    over the experts) against the plain one-hot dispatch, dropless, on a
    prefill of ``prompt_len`` unit-RMS rows (the norm before the layer
    gives such rows) and on a decode step of MAX_NUM_SEQS rows
    (chunk_size=1): y within 2e-2 of the plain output's largest magnitude
    (the experts' outputs reach the hundreds, where a bf16 step is a unit
    or more) and 1e-2 of its norm, the loss within 2e-5.  The prefill's
    routing must reach every expert.  Both dispatches are timed (CUDA
    events around back-to-back calls; the prefill's kernel dispatch reads
    its expert counts to the host once a call) beside the bound of the
    expert products the routing asks for."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.transformer import (_layer, block_pattern,
                                                num_repeats)
    pattern = block_pattern(cfg)
    first = next(j for j, d in enumerate(pattern) if d.ffn == "moe")
    n_moe = num_repeats(cfg) * sum(d.ffn == "moe" for d in pattern)
    p = _layer(params["blocks"][first], 0)["moe"]
    E, k, d, f = (cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model,
                  cfg.d_ff)
    mats = 3 if "w_gate" in p else 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 7)
    for phase, B, S in (("prefill", 1, prompt_len),
                        ("decode", MAX_NUM_SEQS, 1)):
        x = torch.randn(B, S, d, generator=gen, device="cuda").bfloat16()
        kw = dict(dropless=True, chunk_size=1 if S == 1 else 0)

        def kernel():
            return MOE.apply_moe(cfg, p, x, **kw)

        def plain():
            return MOE.apply_moe(cfg, p, x, attn_impl="plain", **kw)

        with torch.inference_mode():
            (y, aux), (y_ref, aux_ref) = kernel(), plain()
            idx = MOE.route(cfg, p, x, S * k).idx
            slots = torch.bincount(idx.reshape(-1), minlength=E).tolist()
            torch.cuda.synchronize()
            ms = time_ms(kernel, 10)
            plain_ms = time_ms(plain, 3, warmup=1)
        scale = float(y_ref.float().abs().max())
        err = max_err(y, y_ref) / scale
        rel = rel_err(y, y_ref)
        name = f"moe {cfg.name} layer {first} {phase} {B}x{S}"
        require(bool(torch.isfinite(y).all()) and y.shape == x.shape,
                f"{name}: output {tuple(y.shape)}, not finite or not "
                f"{tuple(x.shape)}")
        require(bool(torch.allclose(y.float() / scale, y_ref.float() / scale,
                                    rtol=TOL[torch.bfloat16],
                                    atol=TOL[torch.bfloat16]))
                and rel < REL_TOL[torch.bfloat16],
                f"{name}: kernel dispatch disagrees with the one-hot one "
                f"({err:.3g} of the output's largest magnitude, {rel:.3g} "
                f"of its norm)")
        require(abs(float(aux) - float(aux_ref))
                <= TOL[torch.float32] * (1 + abs(float(aux_ref))),
                f"{name}: loss {float(aux)!r} against {float(aux_ref)!r}")
        reached = sum(1 for n in slots if n)
        if phase == "prefill":
            require(reached == E, f"{name}: routing reached only {reached} "
                                  f"of {E} experts ({slots})")
        # the routed slots' products, and each reached expert's weights
        # read once (x read and y written besides)
        flops = 2.0 * mats * d * f * B * S * k
        nbytes = reached * mats * d * f * 2 + 2 * x.numel() * 2
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"[{name}] (d_model {d}, {E} experts of d_ff {f}, "
              f"top-{k}, dropless): kernel dispatch vs plain one-hot "
              f"dispatch: max_abs_err {err:.3g} of the output's largest "
              f"magnitude {scale:.4g}, rel_err {rel:.3g}, loss "
              f"{float(aux):.6g} vs {float(aux_ref):.6g}; slots per expert "
              f"{slots} ({reached} of {E} reached); ms={ms!r} "
              f"plain_ms={plain_ms!r} bound_ms={bound_ms!r} ({bound_by}); "
              f"x{n_moe} MoE layers: ms={ms * n_moe!r} "
              f"plain_ms={plain_ms * n_moe!r}")


def print_trace(prof, per: int, host_ms: float, what: str, top: int = 6):
    """From a torch.profiler trace of ``per`` runs: the device's busy time
    a run, its share of ``host_ms``, the kernel launches and the ``top``
    costliest kernels.  Returns (busy ms, launches, {kernel: ms}), a run
    each."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / per
    n_launch = sum(e.count for e in kernels) / per
    print(f"  {what}: profiler: device busy {busy_ms!r} ms "
          f"({n_launch:.0f} kernel launches)")
    by_kernel = {e.key: e.self_device_time_total / 1e3 / per
                 for e in kernels}
    if busy_ms == 0:
        print(f"  {what}: device busy share: not measured (the profiler saw "
              f"no CUDA kernel)")
        return busy_ms, n_launch, by_kernel
    print(f"  {what}: device busy share {busy_ms / host_ms!r}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3 / per:8.4f} ms "
              f"x{e.count // per:<4d} {e.key[:90]}")
    return busy_ms, n_launch, by_kernel


def host_and_trace(run, what: str, per: int = 1, runs: int = 5,
                   top: int = 6):
    """``run`` (``per`` steps, ending in a synchronize) warmed up, timed on
    the host clock ``runs`` times (the host clock spreads: the median is
    reported, ms a step) and traced once with torch.profiler
    (print_trace).  Returns (host ms a step of each run, print_trace's
    numbers)."""
    from torch.profiler import ProfilerActivity, profile
    run()                                           # warm up
    host_ms = []
    for _ in range(runs):
        t0 = time.monotonic()
        run()
        host_ms.append(1e3 * (time.monotonic() - t0) / per)
    median = float(np.median(host_ms))
    print(f"  {what}: host clock {median!r} ms (median of {runs}"
          + (f" runs of {per} steps" if per > 1 else "") + ": "
          + ", ".join(f"{t:.3f}" for t in sorted(host_ms)) + ")")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    return host_ms, print_trace(prof, per, median, what, top)


def profile_prefill(cfg, params, prompt_len: int, seed: int):
    """One prefill of a ``prompt_len``-token prompt (batch 1) into a cache
    of that length, as the engine runs it, timed and traced
    (host_and_trace)."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    cache = model.init_cache(1, prompt_len, device="cuda")
    rng = np.random.default_rng(seed + 2)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)),
                        dtype=torch.long, device="cuda")

    def run():
        model.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()

    host_and_trace(run, f"prefill of {prompt_len} tokens")


def profile_decode(cfg, params, prompt_lens, max_len, steps: int = 8):
    """One decode step at the engine's shape (MAX_NUM_SEQS sequences over a
    max_len slot cache), timed and traced (host_and_trace).  Returns (host
    ms, busy ms) a step."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    B = MAX_NUM_SEQS
    cache = model.init_cache(B, max_len, device="cuda")
    lens = torch.tensor(prompt_lens[:B], dtype=torch.int32, device="cuda")
    toks = torch.zeros(B, dtype=torch.long, device="cuda")

    def run():
        for _ in range(steps):
            model.decode(params, toks, cache, lens)
        torch.cuda.synchronize()

    host_ms, (busy_ms, _, _) = host_and_trace(
        run, f"decode step at the engine's shape (batch {B}, cache "
             f"{max_len}, {cfg.kv_cache_dtype} KV)", per=steps)
    return float(np.median(host_ms)), busy_ms


# ---------------------------------------------------------- encoder-decoder

def encdec_inputs(cfg, seed: int, n_tokens: int):
    """ENCDEC_B sequences of ENCDEC_FRAMES bf16 frame embeddings, N(0, 1)
    from a torch.Generator seeded from ``seed``, and ``n_tokens`` target
    tokens each, from numpy."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    src = torch.randn(ENCDEC_B, ENCDEC_FRAMES, cfg.d_model, generator=gen,
                      device="cuda").bfloat16()
    rng = np.random.default_rng(seed)
    tgt = torch.tensor(rng.integers(0, cfg.vocab_size, (ENCDEC_B, n_tokens)),
                       dtype=torch.long, device="cuda")
    return src, tgt


def check_encdec(cfg, params, seed: int) -> None:
    """The encoder-decoder's prefill of ENCDEC_B x ENCDEC_FRAMES frames
    and an ENCDEC_PROMPT-token prompt, plus MODEL_DECODE_STEPS decode
    steps teacher-forced, on the kernel path against the plain path's
    teacher-forced forward and against its own prefill plus decode, under
    compare_logits' gates.  The cache is made with as many cross slots as
    self slots (32), not 1500: the prefill replaces them."""
    from repro_torch.models import build_model
    kernel = build_model(cfg)
    plain = build_model(cfg, attn_impl="plain")
    P = ENCDEC_PROMPT
    src, toks = encdec_inputs(cfg, seed + 8, P + MODEL_DECODE_STEPS)
    batch = {"src_embeds": src, "tgt_tokens": toks[:, :P]}
    with torch.inference_mode():
        x, _ = plain.forward(params, {"src_embeds": src, "tgt_tokens": toks})
        ref = plain._logits(params, x[:, P - 1:])
    got, prefill_ms, step_ms, cache = prefill_decode(kernel, params, toks, P,
                                                     batch=batch)
    print(f"  model: kernel path, host clock to a synchronize: prefill "
          f"{ENCDEC_B}x{ENCDEC_FRAMES} frames + {ENCDEC_B}x{P} tokens "
          f"{prefill_ms!r} ms, decode step (batch {ENCDEC_B}) {step_ms!r} "
          f"ms; cross cache {tuple(cache['cross_k'].shape)}")
    require(cache["cross_k"].shape[2] == ENCDEC_FRAMES,
            f"model: the prefill left a cross cache of "
            f"{cache['cross_k'].shape[2]} slots, not the encoder's "
            f"{ENCDEC_FRAMES}")
    del cache
    require(bool(torch.isfinite(got).all()), "model: non-finite logits")
    require(tuple(got.shape) == (ENCDEC_B, MODEL_DECODE_STEPS + 1,
                                 cfg.vocab_size),
            f"model: logits shape {tuple(got.shape)}")
    steps = (f"{ENCDEC_B}x{ENCDEC_FRAMES} frames, {ENCDEC_B}x{P} prompt + "
             f"{MODEL_DECODE_STEPS} decode steps")
    compare_logits(f"{steps}, kernel path vs plain path teacher-forced",
                   got, ref)
    same = prefill_decode(plain, params, toks, P, batch=batch)[0]
    compare_logits(f"{steps}, kernel path vs plain path, the same steps",
                   got, same)


def run_encdec(cfg, params, seed: int):
    """The encoder-decoder's main path, through ``Model.prefill`` and
    ``Model.decode`` (the engine has no path for it): ENCDEC_B sequences of
    ENCDEC_FRAMES frames and an ENCDEC_PROMPT-token prompt, then greedy
    decoding to ENCDEC_NEW new tokens, into a cache made with
    ENCDEC_ENC_LEN cross slots, which the prefill must replace.  The
    launch counters are reset just before and read just after; they must
    show flash once a prefill in every encoder layer and twice in every
    decoder layer (the self-attention causal, the cross-attention not),
    and paged twice a decode step in every decoder layer, once over the
    self cache's capacity and once over the cross cache's.  The greedy
    logits are then held against the teacher-forced forward over the
    generated sequence (compare_logits).  Returns the launches of each
    kernel, its launches by kind, and flash's launches that were not
    causal."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    model = build_model(cfg)
    src, prompt = encdec_inputs(cfg, seed + 9, ENCDEC_PROMPT)
    cache = model.init_cache(ENCDEC_B, ENCDEC_MAX_LEN, ENCDEC_ENC_LEN,
                             device="cuda")
    reset_launch_counts()
    t0 = time.monotonic()
    lg, cache, lens = model.prefill(
        params, {"src_embeds": src, "tgt_tokens": prompt}, cache)
    steps, toks = [lg], [lg.argmax(-1)]
    for i in range(ENCDEC_NEW - 1):
        lg, cache = model.decode(params, toks[-1], cache, lens + i)
        steps.append(lg)
        toks.append(lg.argmax(-1))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    kinds = launch_kinds()
    noncausal = FA.flash_attention_cuda.noncausal_launches
    L, E, decodes = cfg.num_layers, cfg.encoder_layers, ENCDEC_NEW - 1
    print(f"  main path[{cfg.name}]: prefill + {decodes} greedy decode "
          f"steps, batch {ENCDEC_B}, wall_s={wall!r}; launches={counts} by "
          f"kind={kinds}, flash not causal {noncausal}")
    require(cache["cross_k"].shape[2] == ENCDEC_FRAMES,
            f"main path: the cache made with {ENCDEC_ENC_LEN} cross slots "
            f"holds {cache['cross_k'].shape[2]} after the prefill, not the "
            f"encoder's {ENCDEC_FRAMES}")
    want = {"flash_attention": E + 2 * L, "flash_attention_bwd": 0,
            "paged_attention": 2 * L * decodes, "ssd_scan": 0,
            "ssd_scan_bwd": 0}
    require(counts == want, f"main path: launches {counts}, expected {want}")
    require(noncausal == E + L, f"main path: {noncausal} flash launches not "
                                f"causal, expected {E + L}")
    want_pages = {ENCDEC_MAX_LEN: L * decodes, ENCDEC_FRAMES: L * decodes}
    require(kinds["paged_attention"] == want_pages,
            f"main path: paged launches by capacity "
            f"{kinds['paged_attention']}, expected {want_pages}")
    got = torch.stack(steps, 1)
    seq = torch.cat([prompt, torch.stack(toks[:-1], 1)], 1)
    with torch.inference_mode():
        x, _ = model.forward(params, {"src_embeds": src, "tgt_tokens": seq})
        ref = model._logits(params, x[:, ENCDEC_PROMPT - 1:])
    nbytes = {name: sum(t.numel() * t.element_size()
                        for t in _leaves(cache[name])) // ENCDEC_B
              for name in ("self", "cross_k", "cross_v")}
    print(f"  main path: {ENCDEC_NEW} greedy tokens a sequence, "
          f"{len(torch.unique(seq[:, ENCDEC_PROMPT:]))} distinct; one "
          f"sequence's cache: {nbytes} bytes")
    compare_logits(f"greedy prefill + {decodes} decode steps vs "
                   f"teacher-forced forward over the generated sequence",
                   got, ref)
    return counts, kinds, noncausal


def profile_encdec(cfg, params, seed: int, steps: int = 8) -> None:
    """The encoder-decoder's prefill (the encoder over ENCDEC_B x
    ENCDEC_FRAMES frames, the cross caches, the decoder over the prompt)
    and one decode step at batch ENCDEC_B over the self cache and the
    cross cache, each timed and traced (host_and_trace)."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    src, prompt = encdec_inputs(cfg, seed + 10, ENCDEC_PROMPT)
    cache = model.init_cache(ENCDEC_B, ENCDEC_MAX_LEN, device="cuda")
    batch = {"src_embeds": src, "tgt_tokens": prompt}

    def prefill():
        model.prefill(params, batch, cache)
        torch.cuda.synchronize()

    host_and_trace(prefill, f"prefill of {ENCDEC_B}x{ENCDEC_FRAMES} frames "
                            f"and {ENCDEC_B}x{ENCDEC_PROMPT} tokens")
    lens = torch.full((ENCDEC_B,), ENCDEC_PROMPT, dtype=torch.int32,
                      device="cuda")

    def decode():
        for _ in range(steps):
            model.decode(params, prompt[:, -1], cache, lens)
        torch.cuda.synchronize()

    host_and_trace(decode, f"decode step (batch {ENCDEC_B}, self cache "
                           f"{ENCDEC_MAX_LEN}, cross cache {ENCDEC_FRAMES})",
                   per=steps)


# ------------------------------------------------------------------- engine

def path_kernels(cfg):
    """The kernels a model's serving path runs, each with the phase that
    launches it, "prefill" (once a request) or "decode" (once a decode
    step), and the layers that launch it once each: flash and paged every
    attention layer, the SSD scan every Mamba layer (a hybrid runs all
    three)."""
    from repro_torch.models.transformer import block_pattern, num_repeats
    pattern = block_pattern(cfg)
    n_attn = num_repeats(cfg) * sum(d.is_attn for d in pattern)
    n_mamba = cfg.num_layers - n_attn
    kernels = {}
    if n_attn:
        kernels["flash_attention"] = ("prefill", n_attn)
        kernels["paged_attention"] = ("decode", n_attn)
    if n_mamba:
        kernels["ssd_scan"] = ("prefill", n_mamba)
    return kernels


def launch_kinds():
    """Each wrapper's launches by kind (KIND_COUNTS), the kinds counted."""
    from repro_torch.kernels.ops import CUDA_WRAPPERS, KIND_COUNTS
    return {name: {kind: n for kind, n in
                   getattr(fn, KIND_COUNTS[name]).items() if n}
            for name, fn in CUDA_WRAPPERS.items()}


def kind_of(name: str) -> str:
    """What a kernel's wrapper counts its launches by: "window" (flash),
    "capacity" (paged) or "variant" (the SSD scan)."""
    from repro_torch.kernels.ops import KIND_COUNTS
    return KIND_COUNTS[name].removesuffix("_launches")


def layers_by_kind(cfg, max_len: int):
    """A model's attention layers counted by the kind each kernel's wrapper
    counts them under: flash by window, paged by the slot cache's capacity
    (a windowed layer's ring holds min(max_len, window) slots)."""
    from repro_torch.models.transformer import block_pattern, num_repeats
    kinds = {"flash_attention": {}, "paged_attention": {}}
    for d in block_pattern(cfg):
        if d.is_attn:
            T = min(max_len, d.window) if d.window else max_len
            for name, kind in (("flash_attention", d.window),
                               ("paged_attention", T)):
                kinds[name][kind] = kinds[name].get(kind, 0) + num_repeats(cfg)
    return kinds


def check_launches(cfg, mode: str, counts, kinds, max_len: int) -> None:
    """Gate one mode's launch counts on the model's path kernels, by mixer:
    each kernel launched once a prefill or a decode step by every layer of
    the mixer it serves (path_kernels); and an attention model's counts by
    kind: every attention layer of every kind launched each of its
    kernels."""
    kernels = path_kernels(cfg)
    for name, n in counts.items():
        phase, n_layers = kernels.get(name, (None, 0))
        if phase is None:
            require(n == 0, f"engine[{mode}]: {name} launched {n} times, "
                            f"off {cfg.name}'s path")
            continue
        # every request is prefilled once, then needs MAX_NEW - 1 decode
        # steps
        least = N_REQUESTS if phase == "prefill" else MAX_NEW - 1
        require(n >= n_layers * least and n % n_layers == 0,
                f"engine[{mode}]: {name} launched {n} times, expected a "
                f"multiple of its {n_layers} layers and "
                f">= {n_layers * least}")
        print(f"  engine[{mode}]: {name}: {n // n_layers} "
              f"{'prefills' if phase == 'prefill' else 'decode steps'} of "
              f"{n_layers} of {cfg.num_layers} layers")
    if "flash_attention" not in kernels:
        return
    n_layers = kernels["flash_attention"][1]
    for name, layers in layers_by_kind(cfg, max_len).items():
        calls = counts[name] // n_layers
        want = {kind: calls * n for kind, n in layers.items()}
        require(counts[name] % n_layers == 0 and kinds[name] == want,
                f"engine[{mode}]: {name} launched {kinds[name]} by "
                f"{kind_of(name)}, expected {want} ({calls} calls of "
                f"{n_layers} layers)")


def run_engine(cfg, params, prompts, max_len):
    """Serve ``prompts`` in every mode.  Returns the launches of each
    kernel, and each kernel's launches by kind (kind_of), summed over the
    modes, and the requests' tokens (the same in every mode)."""
    from repro_torch.kernels.ops import (CUDA_WRAPPERS, launch_counts,
                                         reset_launch_counts)
    from repro_torch.models import build_model
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.request import Request

    model = build_model(cfg)
    one = model.init_cache(1, max_len, device="cuda")
    per_req = sum(t.numel() * t.element_size() for t in _leaves(one))
    print(f"  {cfg.name}: one request's cache is {per_req} bytes (what "
          f"disagg moves through host memory)")
    del one
    tokens, totals = {}, dict.fromkeys(launch_counts(), 0)
    kind_totals = {name: {} for name in CUDA_WRAPPERS}
    for mode in MODES:
        reqs = [Request(prompt_len=len(p), max_new_tokens=MAX_NEW,
                        prompt_tokens=p, arrival_time=0.0) for p in prompts]
        reset_launch_counts()
        t0 = time.monotonic()
        eng = RealEngine(model, params, mode=mode,
                         max_num_seqs=MAX_NUM_SEQS, max_len=max_len,
                         device="cuda")
        try:
            res = eng.run(reqs, timeout=600)
        finally:
            eng.shutdown()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = launch_counts()
        kinds = launch_kinds()
        for name, n in counts.items():
            totals[name] += n
            for kind, m in kinds[name].items():
                kind_totals[name][kind] = kind_totals[name].get(kind, 0) + m
        tokens[mode] = [r.output_tokens for r in reqs]
        ENGINE_RESULTS[cfg.name, mode] = res
        print(f"  engine[{cfg.name} {mode}]: completed={res['completed']} "
              f"failed={res['failed']} ttft_mean_s={res['ttft_mean_s']!r} "
              f"ttft_p95_s={res['ttft_p95_s']!r} "
              f"tpot_mean_s={res['tpot_mean_s']!r} wall_s={wall!r} "
              f"launches={counts} by kind={kinds}")
        require(res["completed"] == N_REQUESTS and res["failed"] == 0,
                f"engine[{mode}]: {res['completed']}/{N_REQUESTS} completed")
        require(all(len(t) == MAX_NEW for t in tokens[mode]),
                f"engine[{mode}]: a request stopped short")
        check_launches(cfg, mode, counts, kinds, max_len)
        # the model runs in bf16: every prefill scan on the tensor cores
        require(kinds["ssd_scan"].get("wgmma", 0) == counts["ssd_scan"],
                f"engine[{mode}]: ssd_scan variants {kinds['ssd_scan']}, "
                f"{counts['ssd_scan']} launches")
    for mode in MODES[1:]:
        require(tokens[mode] == tokens[MODES[0]],
                f"engine: {mode} tokens differ from {MODES[0]}")
    print(f"  engine: tokens identical across {', '.join(MODES)}")
    return totals, kind_totals, tokens[MODES[0]]


def run_sanitized(cfg, params, prompts, max_len, want_tokens) -> None:
    """Serve ``prompts`` again with FLEX_SANITIZE=1 in SANITIZED_MODES:
    each session builds a happens-before hazard sanitizer that checks
    every op its daemons complete (disagg moves each request's KV cache
    by memcpy_peer under a shared event), and ``Session.close()`` raises
    on any hazard.  Every request must complete with ``want_tokens``,
    the tokens of the unsanitized run."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.request import Request
    model = build_model(cfg)
    before = os.environ.get("FLEX_SANITIZE")
    os.environ["FLEX_SANITIZE"] = "1"
    try:
        for mode in SANITIZED_MODES:
            reqs = [Request(prompt_len=len(p), max_new_tokens=MAX_NEW,
                            prompt_tokens=p, arrival_time=0.0)
                    for p in prompts]
            t0 = time.monotonic()
            eng = RealEngine(model, params, mode=mode,
                             max_num_seqs=MAX_NUM_SEQS, max_len=max_len,
                             device="cuda")
            try:
                res = eng.run(reqs, timeout=600)
                san = eng.session.sanitizer
                require(san is not None, f"sanitize[{mode}]: the session "
                                         f"built no sanitizer")
                # each completed op advanced its own stream's component
                n_ops = sum(c[k] for k, c in san._stream_clock.items())
                hazards = list(san.hazards)
            finally:
                eng.shutdown()          # raises on any hazard
            wall = time.monotonic() - t0
            print(f"  sanitize[{cfg.name} {mode}]: completed="
                  f"{res['completed']} hazards={len(hazards)} over {n_ops} "
                  f"ops on {len(san._stream_clock)} streams, "
                  f"wall_s={wall!r}")
            require(not hazards, f"sanitize[{mode}]: {hazards}")
            require(res["completed"] == N_REQUESTS and res["failed"] == 0,
                    f"sanitize[{mode}]: {res['completed']}/{N_REQUESTS} "
                    f"completed")
            require([r.output_tokens for r in reqs] == want_tokens,
                    f"sanitize[{mode}]: the tokens differ from the "
                    f"unsanitized run's")
    finally:
        if before is None:
            os.environ.pop("FLEX_SANITIZE")
        else:
            os.environ["FLEX_SANITIZE"] = before


# ---------------------------------------------------------------------- sim

def sim_measure(cfg, params, seed: int):
    """olmo-1b's step times on the card: a prefill at batch 1 of each of
    SIM_PREFILL_LENS tokens, and a decode step at each batch of
    SIM_DECODE_BATCHES over each context of SIM_DECODE_CONTEXTS, each on
    the host clock (median of 5, as the engine's own calls) beside the
    profiler's busy time.  Returns the points, one dict each."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    rng = np.random.default_rng(seed + 5)
    points = []
    for n in SIM_PREFILL_LENS:
        cache = model.init_cache(1, n, device="cuda")
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                            dtype=torch.long, device="cuda")

        def prefill():
            model.prefill(params, {"tokens": toks}, cache)
            torch.cuda.synchronize()
        host_ms, (busy_ms, _, _) = host_and_trace(
            prefill, f"sim: prefill of {n} tokens at batch 1", top=0)
        points.append(dict(kind="prefill", tokens=n, ctx=0,
                           host_s=float(np.median(host_ms)) * 1e-3,
                           busy_s=busy_ms * 1e-3))
        del cache
    for ctx in SIM_DECODE_CONTEXTS:
        for B in SIM_DECODE_BATCHES:
            cache = model.init_cache(B, ctx + 64, device="cuda")
            lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
            toks = torch.zeros(B, dtype=torch.long, device="cuda")

            def decode():
                for _ in range(SIM_DECODE_STEPS):
                    model.decode(params, toks, cache, lens)
                torch.cuda.synchronize()
            host_ms, (busy_ms, _, _) = host_and_trace(
                decode, f"sim: decode step at batch {B}, context {ctx}",
                per=SIM_DECODE_STEPS, top=0)
            points.append(dict(kind="decode", batch=B, ctx=ctx,
                               host_s=float(np.median(host_ms)) * 1e-3,
                               busy_s=busy_ms * 1e-3))
            del cache
    return points


def unit_terms(cost, point):
    """(t_compute, t_memory) of a point in the cost model at one chip and
    unit efficiencies (``CostModel``'s roofline terms)."""
    from repro_torch.serving.costmodel import InstanceSpec
    unit = InstanceSpec("unit", 1, compute_eff=1.0, bw_eff=1.0)
    if point["kind"] == "prefill":
        return cost._prefill_terms(unit, point["tokens"], point["ctx"])
    return cost._decode_terms(unit, point["batch"], point["ctx"])


def predicted_s(cost, spec, point) -> float:
    """``CostModel.prefill_time``/``decode_time`` of a point under
    ``spec``."""
    if point["kind"] == "prefill":
        return cost.prefill_time(spec, point["tokens"], point["ctx"])
    return cost.decode_time(spec, point["batch"], point["ctx"])


def fit_derates(cost, points, collective_frac: float):
    """InstanceSpec's compute_eff, bw_eff and launch_overhead_s fitted by
    least squares to the points' host times: t = max(t_c / compute_eff,
    t_m / bw_eff) (1 + collective_frac) + launch_overhead_s.  The two
    efficiencies are searched over a log grid in (0, 1] (0.001 to 1, 801
    values each); for each pair the overhead is the closed-form least
    squares constant, at least 0.  Returns (compute_eff, bw_eff,
    launch_overhead_s, root mean square error in s)."""
    terms = np.array([unit_terms(cost, p) for p in points])    # [P, 2]
    y = np.array([p["host_s"] for p in points])
    grid = np.geomspace(1e-3, 1.0, 801)
    tc = terms[:, 0][None, None, :] / grid[:, None, None]
    tm = terms[:, 1][None, None, :] / grid[None, :, None]
    roof = np.maximum(tc, tm) * (1.0 + collective_frac)          # [C, M, P]
    over = np.maximum((y - roof).mean(-1), 0.0)
    sse = ((y - roof - over[..., None]) ** 2).sum(-1)
    i, j = np.unravel_index(np.argmin(sse), sse.shape)
    return (float(grid[i]), float(grid[j]), float(over[i, j]),
            float(np.sqrt(sse[i, j] / len(points))))


def sim_derates(cfg, points) -> None:
    """(a): the derates fitted to ``points`` beside the committed ones,
    each point measured beside both predictions.  Gates: each fitted
    efficiency in (0, 1]; the committed derates predict each measured
    host time within SIM_PREDICT_FACTOR."""
    from repro_torch.serving.costmodel import CostModel, InstanceSpec
    cost = CostModel(cfg)
    committed = InstanceSpec("h100", 1)
    ce, be, over, rms = fit_derates(cost, points, committed.collective_frac)
    fitted = dataclasses.replace(committed, compute_eff=ce, bw_eff=be,
                                 launch_overhead_s=over)
    print(f"  sim: derates fitted to {len(points)} points of {cfg.name} "
          f"(least squares, host clock): compute_eff {ce!r}, bw_eff {be!r},"
          f" launch_overhead_s {over!r} (rms error {rms!r} s); committed "
          f"in serving/costmodel.py: compute_eff {committed.compute_eff!r},"
          f" bw_eff {committed.bw_eff!r}, launch_overhead_s "
          f"{committed.launch_overhead_s!r}, collective_frac "
          f"{committed.collective_frac!r} (one card: no collective)")
    require(0 < ce <= 1 and 0 < be <= 1,
            f"sim: fitted efficiencies {ce}, {be} outside (0, 1]")
    for p in points:
        what = (f"prefill {p['tokens']} tokens" if p["kind"] == "prefill"
                else f"decode batch {p['batch']} context {p['ctx']}")
        want = predicted_s(cost, committed, p)
        print(f"  sim: {what}: host {p['host_s']!r} s (busy "
              f"{p['busy_s']!r} s); predicted, fitted "
              f"{predicted_s(cost, fitted, p)!r} s, committed {want!r} s "
              f"({want / p['host_s']!r} of the host time)")
        require(1 / SIM_PREDICT_FACTOR <= want / p["host_s"]
                <= SIM_PREDICT_FACTOR,
                f"sim: the committed derates predict {what} at {want} s, "
                f"measured {p['host_s']} s: refit them")


def sim_trace_fit(cfg, params, prompts, max_len) -> None:
    """(b): the engine in dynamic_pd on the engine phase's traffic under
    FLEX_PROFILE=1, and the reference's LatencyModel fitted to its trace
    through the registry (``make_predictor("ridge_latency", trace=...)``),
    with its calibration report."""
    import tempfile

    from repro_torch.models import build_model
    from repro_torch.predict import load_samples, make_predictor
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.request import Request
    directory = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    before = {k: os.environ.get(k) for k in ("FLEX_PROFILE",
                                             "FLEX_PROFILE_DIR")}
    os.environ.update(FLEX_PROFILE="1", FLEX_PROFILE_DIR=directory)
    try:
        reqs = [Request(prompt_len=len(p), max_new_tokens=MAX_NEW,
                        prompt_tokens=p, arrival_time=0.0) for p in prompts]
        eng = RealEngine(build_model(cfg), params, mode="dynamic_pd",
                         max_num_seqs=MAX_NUM_SEQS, max_len=max_len,
                         device="cuda")
        try:
            res = eng.run(reqs, timeout=600)
        finally:
            eng.shutdown()
        require(res["completed"] == N_REQUESTS,
                f"sim: the traced engine run completed {res['completed']}")
        path = eng.session.trace_path
        samples = load_samples(path)
        model = make_predictor("ridge_latency", trace=path)
        print(f"  sim: LatencyModel fitted to the dynamic_pd engine trace "
              f"({len(samples)} ops: "
              f"{sum(s.phase == 'prefill' for s in samples)} prefill, "
              f"{sum(s.phase == 'decode' for s in samples)} decode): "
              f"report {model.report()}")
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for name in os.listdir(directory):
            os.remove(os.path.join(directory, name))
        os.rmdir(directory)


def sim_cluster() -> None:
    """(c): ``run_sim`` for mixtral-8x7b x 1k1k under each of
    SIM_DEPLOYMENTS at the H100's constants and the committed derates; every
    request must complete."""
    from repro_torch.launch.serve import run_sim
    for deployment in SIM_DEPLOYMENTS:
        t0 = time.monotonic()
        res = run_sim("mixtral-8x7b", deployment, "1k1k", verbose=False)
        print(f"  sim[mixtral-8x7b {deployment} 1k1k]: completed="
              f"{res['completed']} failed={res['failed']} chips="
              f"{res['chips']} requests_per_s={res['requests_per_s']!r} "
              f"output_tokens_per_s={res['output_tokens_per_s']!r} "
              f"ttft_mean_s={res['ttft_mean_s']!r} "
              f"ttft_p99_s={res['ttft_p99_s']!r} "
              f"tpot_mean_s={res['tpot_mean_s']!r} "
              f"tpot_p99_s={res['tpot_p99_s']!r} (simulated in "
              f"{time.monotonic() - t0:.1f} s)")
        require(res["completed"] == 2000 and res["failed"] == 0,
                f"sim[{deployment}]: {res['completed']} of 2000 completed, "
                f"{res['failed']} failed")


def sim_one_card(cfg, prompts) -> None:
    """(d): one instance of one card, max_num_seqs MAX_NUM_SEQS, the engine
    phase's prompts, MAX_NEW new tokens and arrival times, in each of
    SIM_ENGINE_MODES, beside the engine's measured TTFT and TPOT there.
    Not a gate: a ratio outside SIM_RATIO_BOUNDS is printed as a fault."""
    from repro_torch.serving import Cluster, SimConfig
    from repro_torch.serving.request import Request
    from repro_torch.serving.simulator import DeploymentSpec
    lo, hi = SIM_RATIO_BOUNDS
    for mode in SIM_ENGINE_MODES:
        reqs = [Request(prompt_len=len(p), max_new_tokens=MAX_NEW,
                        arrival_time=0.0) for p in prompts]
        cluster = Cluster(cfg, DeploymentSpec(
            mode=mode, colocated_instances=1, colocated_chips=1),
            sim_cfg=SimConfig(max_num_seqs=MAX_NUM_SEQS))
        sim = cluster.run(reqs, until=600)
        real = ENGINE_RESULTS[cfg.name, mode]
        ratios = {k: sim[k] / real[k] for k in ("ttft_mean_s", "ttft_p95_s",
                                                "tpot_mean_s")}
        outside = [k for k, r in ratios.items() if not lo <= r <= hi]
        print(f"  sim[{cfg.name} {mode}, one card]: completed="
              f"{sim['completed']} ttft_mean_s={sim['ttft_mean_s']!r} "
              f"ttft_p95_s={sim['ttft_p95_s']!r} "
              f"tpot_mean_s={sim['tpot_mean_s']!r}; measured "
              f"ttft_mean_s={real['ttft_mean_s']!r} "
              f"ttft_p95_s={real['ttft_p95_s']!r} "
              f"tpot_mean_s={real['tpot_mean_s']!r}; simulated / measured "
              f"{ratios}" + (f"; FAULT: {', '.join(outside)} outside "
                             f"[{lo}, {hi}]" if outside else ""))
        require(sim["completed"] == N_REQUESTS,
                f"sim[{mode}, one card]: {sim['completed']} completed")


def run_sim_phase(traffic, seed: int) -> None:
    """The sim phase: (a) to (d) on olmo-1b at full width, then the
    cluster's runs; its seconds printed."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    t0 = time.monotonic()
    cfg = get_config(SIM_ARCH)
    prompts, max_len = traffic[cfg.name]
    params = build_model(cfg).init(seed, device="cuda")
    print(f"[sim] {cfg.name} full width: InstanceSpec's derates fitted to "
          f"its own step times, its engine trace, then the simulator")
    points = sim_measure(cfg, params, seed)
    print(f"  (sim: measured {time.monotonic() - t0:.1f} s into the phase)")
    sim_derates(cfg, points)
    sim_trace_fit(cfg, params, prompts, max_len)
    print(f"  (sim: traced {time.monotonic() - t0:.1f} s into the phase)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    sim_cluster()
    sim_one_card(cfg, prompts)
    print(f"[sim] the phase took {time.monotonic() - t0:.1f} s")


# ----------------------------------------------------------------- training

def train_batch(cfg, step: int, seed: int):
    """make_batch's batch on the card; the encoder-decoder's target tokens
    from the synthetic LM that make_batch gives a decoder (SyntheticLM at
    the same seed and step), beside make_batch's fp32 frames.  make_batch
    draws an encoder-decoder's targets uniformly over the vocab: their
    least loss is ln 256,206 = 12.454, 0.50 under seamless-m4t-medium's
    first step (12.955), so no trainer could take them down by
    TRAIN_MIN_DROP (15 steps took them to 12.930 on the card)."""
    from repro_torch.training import make_batch
    from repro_torch.training.data import DataConfig, SyntheticLM
    batch = make_batch(cfg, TRAIN_B, TRAIN_S, step=step, seed=seed)
    if cfg.is_encdec:
        batch["tgt_tokens"] = SyntheticLM(DataConfig(
            TRAIN_B, TRAIN_S, cfg.vocab_size, seed)).batch_at(step)["tokens"]
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def train_attention(cfg):
    """(causal, not causal): the attention layers of one training pass.
    A decoder's attention blocks are causal; the encoder-decoder's decoder
    self-attention is, its encoder's and its cross-attention's are not."""
    if cfg.is_encdec:
        return cfg.num_layers, cfg.encoder_layers + cfg.num_layers
    from repro_torch.models.transformer import block_pattern, num_repeats
    return num_repeats(cfg) * sum(d.is_attn for d in block_pattern(cfg)), 0


def train_windows(cfg):
    """A training pass's attention layers by window, as the forward
    wrapper counts its launches."""
    from repro_torch.models.transformer import block_pattern, num_repeats
    if cfg.is_encdec:
        return {0: sum(train_attention(cfg))}
    out = {}
    for d in block_pattern(cfg):
        if d.is_attn:
            out[d.window] = out.get(d.window, 0) + num_repeats(cfg)
    return out


def train_launch_counts(cfg, counts, kinds, steps: int, what: str) -> None:
    """Gate a training run's launches, by mixer: every attention layer's
    flash kernel and every Mamba layer's SSD scan twice a step (the
    forward, and remat's recompute in the backward pass; the scan on the
    tensor cores), each layer's backward kernel once a step in each of its
    passes (the SSD backward on the tensor cores), and nothing else; flash
    by window, and its launches and its backward's calls not causal (the
    encoder-decoder's encoder and cross-attention) apart."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    causal, noncausal = train_attention(cfg)
    n_attn = causal + noncausal
    n_mamba = 0 if cfg.is_encdec else cfg.num_layers - n_attn
    want = {"flash_attention": 2 * n_attn * steps,
            "flash_attention_bwd": n_attn * steps,
            "paged_attention": 0, "ssd_scan": 2 * n_mamba * steps,
            "ssd_scan_bwd": n_mamba * steps}
    require(counts == want, f"{what}: launches {counts}, expected {want}")
    want = {w: 2 * n * steps for w, n in train_windows(cfg).items()}
    require(kinds["flash_attention"] == want,
            f"{what}: flash_attention by window {kinds['flash_attention']}, "
            f"expected {want}")
    got = (FA.flash_attention_cuda.noncausal_launches,
           FA.flash_attention_bwd_cuda.noncausal_launches)
    require(got == (2 * noncausal * steps, noncausal * steps),
            f"{what}: flash_attention and its backward not causal {got}, "
            f"expected {(2 * noncausal * steps, noncausal * steps)}")
    require(kinds["ssd_scan"] == ({"wgmma": counts["ssd_scan"]}
                                  if n_mamba else {}),
            f"{what}: ssd_scan variants {kinds['ssd_scan']}")
    for name, passes, layers in (
            ("flash_attention_bwd", FA.BWD_PASSES, n_attn),
            ("ssd_scan_bwd", SSD.BWD_PASSES, n_mamba)):
        want = {p: layers * steps for p in passes} if layers else {}
        require(kinds[name] == want,
                f"{what}: {name} passes {kinds[name]}, expected {want}")
    want = {"wgmma": n_mamba * steps, "cuda_core": 0}
    require(SSD.ssd_scan_bwd_cuda.variant_launches == want,
            f"{what}: ssd_scan_bwd variants "
            f"{SSD.ssd_scan_bwd_cuda.variant_launches}, expected {want}")
    print(f"  {what}: launches {counts}, flash by window "
          f"{kinds['flash_attention']}, not causal {got[0]} forward and "
          f"{got[1]} backward, backward passes "
          f"{kinds['flash_attention_bwd'] or kinds['ssd_scan_bwd']}")


def check_train_step(cfg, params, seed: int) -> None:
    """One loss and gradient of the first batch on the kernel path (the
    flash or SSD forward and backward kernels, the sorted MoE dispatch,
    remat), twice: the two must agree bit for bit; then against the plain
    path (blocked_attention, ssd_chunked or the one-hot MoE dispatch under
    autograd) from the same parameters."""
    from repro_torch import tree as TR
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import loss_and_grads
    batch = train_batch(cfg, 0, seed)
    runs = []
    for run in ("", ", again"):
        reset_launch_counts()
        runs.append(loss_and_grads(build_model(cfg), params, batch))
        torch.cuda.synchronize()
        train_launch_counts(cfg, launch_counts(), launch_kinds(), 1,
                            f"train check, kernel path{run}")
    (loss_k, _, grads_k), (loss_2, _, grads_2) = runs
    same = torch.equal(loss_k, loss_2) and all(
        torch.equal(a, b) for a, b in zip(TR.leaves(grads_k),
                                          TR.leaves(grads_2)))
    require(same, "train check: two identical kernel-path steps gave "
                  "different losses or gradients")
    print(f"  train check: two identical kernel-path steps gave the same "
          f"loss and the same bits in all {len(TR.leaves(grads_k))} "
          f"gradients")
    del runs, grads_2
    loss_p, _, grads_p = loss_and_grads(
        build_model(cfg, attn_impl="plain"), params, batch)
    dl = abs(float(loss_k) - float(loss_p))
    require(dl < TRAIN_LOSS_TOL,
            f"train check: loss {float(loss_k)!r} on the kernel path, "
            f"{float(loss_p)!r} on the plain path")
    worst = (2.0, "")
    for (path, a), b in zip(TR.flatten_with_paths(grads_k),
                            TR.leaves(grads_p)):
        a, b = a.float().flatten(), b.float().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        worst = min(worst, (cos, path))
    require(worst[0] >= TRAIN_MIN_COS,
            f"train check: gradient {worst[1]}'s cosine with the plain "
            f"path's is {worst[0]:.4f} (bound {TRAIN_MIN_COS})")
    gk, gp = float(global_norm(grads_k)), float(global_norm(grads_p))
    dn = abs(gk - gp) / gp
    require(dn <= TRAIN_GNORM_TOL,
            f"train check: global gradient norm {gk!r} against {gp!r}")
    print(f"  train check: loss {float(loss_k)!r} kernel path, "
          f"{float(loss_p)!r} plain path (|diff| {dl:.3g}); worst "
          f"gradient cosine {worst[0]:.5f} ({worst[1]}); global norm "
          f"{gk!r} against {gp!r} (rel diff {dn:.3g})")


def train_model_flops(cfg, params, n_params: int):
    """(model FLOPs of one training step, how they were counted): 6 x the
    parameters each token's products use x tokens, forward and backward
    (remat's recompute not counted), plus 12 H D a (q, k) pair and
    attention layer (pairs causal or S x T) and a Mamba layer's scan
    operations, forward and backward.  A decoder's tokens use every
    parameter; an MoE decoder's its attention, router, head and k of E
    experts (not the embedding's lookup); the encoder-decoder's frames its
    encoder, its target tokens its decoder and the tied head."""
    tokens = TRAIN_B * TRAIN_S
    causal, noncausal = train_attention(cfg)
    pairs = TRAIN_S * (TRAIN_S + 1) // 2   # no window binds at 2048
    attn = 12.0 * cfg.num_heads * cfg.head_dim * TRAIN_B * (
        causal * pairs + noncausal * TRAIN_S * TRAIN_S)
    scan = 0.0
    if cfg.ssm is not None:
        B_, S_, H, P, G, N, chunk = ssd_shape(cfg, TRAIN_S)
        scan = (cfg.num_layers - causal) * (
            ssd_flops(TRAIN_B, S_, H, P, N, chunk)
            + ssd_flops(TRAIN_B, S_, H, P, N, chunk, backward=True))
    count = lambda tree: sum(t.numel() for t in _leaves(tree))  # noqa
    if cfg.is_encdec:
        ep = params["encdec"]
        enc, dec = count(ep["enc_blocks"]), count(ep["dec_blocks"])
        head = params["embed"].numel()
        dense = 6.0 * (enc + dec + head) * tokens
        how = (f"6 x ({enc} encoder parameters x {tokens} frames + ({dec} "
               f"decoder + {head} tied-head parameters) x {tokens} target "
               f"tokens)")
    elif cfg.moe is not None:
        E, k = cfg.moe.num_experts, cfg.moe.top_k
        experts = sum(count({n: b["moe"][n] for n in b["moe"]
                             if n != "router"})
                      for b in params["blocks"] if "moe" in b)
        active = n_params - params["embed"].numel() - experts * (E - k) / E
        dense = 6.0 * active * tokens
        how = (f"6 x {active:.0f} active parameters (all but the embedding "
               f"and {E - k} of {E} experts' {experts}) x {tokens} tokens")
    else:
        dense = 6.0 * n_params * tokens
        how = f"6 x {n_params} parameters x {tokens} tokens"
    return dense + attn + scan, (f"{how} + {attn:.4g} of attention + "
                                 f"{scan:.4g} of the SSD scan")


def run_train(arch: str, seed: int):
    """``arch`` at full layer width (cut in depth by TRAIN_CUT): the
    kernel path twice and against the plain path on one step (at
    TRAIN_CHECK_LAYERS layers where set), then TRAIN_STEPS steps of the
    launcher's train step (the main path: counters reset just before, read
    just after), each timed on the host clock; then one more step traced.
    Returns the run's launch counts, counts by kind (with flash's and its
    backward's launches not causal) and what the dry-run's calibration
    holds its prediction against: the parameters' and the AdamW state's
    bytes, the peak memory, the median step's milliseconds and the model
    FLOPs of a step."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step)
    from torch.profiler import ProfilerActivity, profile
    published = get_config(arch)
    cfg = cut_config(published, **TRAIN_CUT.get(arch, {}))
    model = build_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(**TRAIN_OPT))
    ssd = ssd_shape(cfg, TRAIN_S) if cfg.ssm is not None else None
    if ssd:
        mixer = (f"{ssd[2]} SSD heads, P {ssd[3]}, N {ssd[5]}, G {ssd[4]}, "
                 f"chunk {ssd[6]}")
    else:
        mixer = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
                 f"{cfg.head_dim}, window {cfg.sliding_window}, attention "
                 f"softcap {cfg.attn_logit_softcap:g}")
    if cfg.moe is not None:
        mixer += (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
                  f"capacity factor {cfg.moe.capacity_factor:g}")
    layers = (f"{cfg.encoder_layers} + {cfg.num_layers} layers, fp32 frames"
              if cfg.is_encdec else f"{cfg.num_layers} layers")
    # the check first, before the optimizer's state is made
    check = (dataclasses.replace(cfg, num_layers=TRAIN_CHECK_LAYERS[arch])
             if arch in TRAIN_CHECK_LAYERS else cfg)
    if check is not cfg:
        print(f"  train check at full width, {check.num_layers} of "
              f"{cfg.num_layers} layers (TRAIN_CHECK_LAYERS)")
    check_train_step(check, build_model(check).init(seed, device="cuda"),
                     seed)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    params, opt = init_train_state(model, tcfg, seed, device="cuda")
    n_params = sum(t.numel() for t in TR.leaves(params))
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa
                              for t in TR.leaves(tree))
    stats = {"param_bytes": nbytes(params), "opt_state_bytes": nbytes(opt)}
    print(f"[train] {cfg.name} {cut_label(published, cfg)}, {n_params} "
          f"parameters, {layers}, d_model {cfg.d_model}, {mixer}, "
          f"remat={cfg.remat}, batch {TRAIN_B} x {TRAIN_S} tokens, AdamW "
          f"{TRAIN_OPT}, initialised in {time.monotonic() - t0:.1f} s")
    require(n_params == TRAIN_PARAMS[arch],
            f"{cfg.name}: {n_params} parameters, not {TRAIN_PARAMS[arch]}")
    step = make_train_step(model, tcfg)
    batches = [train_batch(cfg, i, seed) for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, host_ms = [], []
    reset_launch_counts()
    for i in range(TRAIN_STEPS):
        t0 = time.monotonic()
        params, opt, m = step(params, opt, batches[i])
        losses.append(float(m["loss"]))           # waits for the step
        host_ms.append(1e3 * (time.monotonic() - t0))
        print(f"  train step {i}: loss {losses[-1]!r} grad_norm "
              f"{float(m['grad_norm']):.4g} lr {float(m['lr']):.3g} "
              f"host {host_ms[-1]:.1f} ms")
    counts, kinds = launch_counts(), launch_kinds()
    train_launch_counts(cfg, counts, kinds, TRAIN_STEPS,
                        f"train main path, {TRAIN_STEPS} steps")
    kinds["ssd_scan_bwd variant"] = dict(
        SSD.ssd_scan_bwd_cuda.variant_launches)
    kinds["flash_attention noncausal"] = \
        FA.flash_attention_cuda.noncausal_launches
    kinds["flash_attention_bwd noncausal"] = \
        FA.flash_attention_bwd_cuda.noncausal_launches
    require(losses[-1] < losses[0] - TRAIN_MIN_DROP,
            f"train: loss {losses[0]!r} -> {losses[-1]!r}, not down by "
            f"{TRAIN_MIN_DROP}")
    peak = torch.cuda.max_memory_allocated()
    # the steps after the first (the first pays for cuBLAS and allocator
    # warm-up)
    median = float(np.median(host_ms[1:]))
    tokens = TRAIN_B * TRAIN_S
    model_flops, how = train_model_flops(cfg, params, n_params)
    print(f"  train: loss {losses[0]!r} -> {losses[-1]!r} in {TRAIN_STEPS} "
          f"steps; host clock {median!r} ms a step (median of steps 1-"
          f"{TRAIN_STEPS - 1}: "
          + ", ".join(f"{t:.1f}" for t in sorted(host_ms[1:])) + ")")
    print(f"  train: peak memory {peak} bytes; {tokens / median * 1e3!r} "
          f"tokens/s; model FLOPs {model_flops:.4g} a step ({how}; remat "
          f"not counted): {model_flops / (median * 1e-3) / 1e12!r} "
          f"TFLOP/s, MFU "
          f"{model_flops / (median * 1e-3) / PEAK_BF16_FLOPS!r} of "
          f"{PEAK_BF16_FLOPS / 1e12:g} TFLOP/s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        params, opt, m = step(params, opt, batches[TRAIN_STEPS])
        float(m["loss"])
        traced_ms = 1e3 * (time.monotonic() - t0)
    print(f"  train step, traced: host clock {traced_ms!r} ms (under the "
          f"profiler)")
    print_trace(prof, 1, median, "train step")
    del params, opt, batches, m
    gc.collect()
    torch.cuda.empty_cache()
    stats.update(peak=peak, step_ms=median, model_flops=model_flops)
    return counts, kinds, stats


def check_layout(mesh, mcfg, cfg, seed: int):
    """olmo-1b's full-width parameters (annotated) laid out on ``mesh`` by
    the train rules: each rank-local shard (one rank: the whole tensor)
    equal to the parameter bit for bit.  Returns the unboxed tree."""
    from repro_torch import tree as TR
    from repro_torch.distributed.sharding import (make_rules,
                                                  make_shardings, unbox)
    from repro_torch.models import build_model
    ann = build_model(cfg).init_annotated(seed, device="cuda")
    shardings = make_shardings(mesh, make_rules(cfg, mcfg, "train"), ann)
    for (path, p), s in zip(TR.flatten_with_paths(ann),
                            TR.leaves(shardings)):
        local = s.distribute(p.value).to_local()
        require(local.device == p.value.device
                and torch.equal(local, p.value),
                f"layout: {path}'s local shard differs from the parameter")
        print(f"  layout: {path} {tuple(p.value.shape)} axes {p.axes} spec "
              f"{s.spec} placements {s.placements(p.value.dim())}: the "
              f"local shard equals the parameter bit for bit")
        del local
    return unbox(ann)


def check_allreduce(group, grads) -> None:
    """The int8-compressed all-reduce over ``group`` (one rank) on every
    leaf of the full-width gradient tree: bit for bit the int8 fake-quant
    (the same function at one rank); its time over the tree beside the
    fake-quant's and NCCL's bf16 all-reduce's, and the bytes a rank would
    send at DIST_RANKS ranks."""
    import torch.distributed as dist
    from repro_torch import tree as TR
    from repro_torch.distributed.collectives import (compressed_allreduce,
                                                     wire_bytes)
    from repro_torch.training import quantize_dequantize_int8
    reduce = compressed_allreduce(group)
    leaves = TR.leaves(grads)
    numel = sum(g.numel() for g in leaves)
    require(numel == TRAIN_PARAMS[DIST_ARCH]
            and all(g.dtype == torch.bfloat16 for g in leaves),
            f"allreduce: {numel} gradient elements, not "
            f"{TRAIN_PARAMS[DIST_ARCH]} bf16")
    for path, g in TR.flatten_with_paths(grads):
        got, want = reduce(g), quantize_dequantize_int8(g)
        if got.dtype != g.dtype or not torch.equal(got, want):
            raise SmokeFailure(f"allreduce: {path} differs from the int8 "
                               f"fake-quant (max |diff| "
                               f"{max_err(got, want)!r})")
        del got, want
    print(f"  allreduce: the compressed all-reduce equals the int8 "
          f"fake-quant bit for bit on all {len(leaves)} leaves "
          f"({numel} bf16 elements)")
    ms = time_ms(lambda: [reduce(g) for g in leaves], DIST_ITERS, warmup=1)
    qdq_ms = time_ms(lambda: [quantize_dequantize_int8(g) for g in leaves],
                     DIST_ITERS, warmup=1)
    # NCCL reduces contiguous buffers alone (the tied head's gradient
    # arrives transposed)
    bufs = [g.clone(memory_format=torch.contiguous_format) for g in leaves]
    nccl_ms = time_ms(lambda: [dist.all_reduce(b, group=group)
                               for b in bufs], DIST_ITERS, warmup=1)
    del bufs
    print(f"  allreduce: one pass over the tree {ms!r} ms (CUDA events, "
          f"mean of {DIST_ITERS}); the fake-quant alone {qdq_ms!r} ms; "
          f"NCCL's bf16 all-reduce at one rank (no bytes cross a link) "
          f"{nccl_ms!r} ms")
    for n in DIST_RANKS:
        ours = sum(wire_bytes(g.numel(), n)[0] for g in leaves)
        bf16 = sum(wire_bytes(g.numel(), n)[1] for g in leaves)
        print(f"  allreduce: at {n} ranks a rank would send {ours:.6g} "
              f"bytes (int8 all-gather) against {bf16:.6g} (bf16 ring "
              f"all-reduce): {ours / bf16:.4g}x")


def run_restarts(cfg, seed: int):
    """RESTART_STEPS steps of the launcher's train step (its gradients
    through the compressed all-reduce over the default group) under
    run_with_restarts with injected failures, against an uninterrupted run
    from its own parameters drawn from the same seed: the final parameters
    and AdamW state bit for bit; the re-executed steps, each step's time,
    each save's and restore's seconds and GB/s.  The launch counters are
    reset just before the restart run and read just after; returns them
    (counts, by kind)."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch import tree as TR
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.fault_tolerance import (InjectedFailure,
                                                         run_with_restarts)
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step)
    model = build_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(**TRAIN_OPT), grad_compression="int8")
    batches = [train_batch(cfg, i, seed) for i in range(RESTART_STEPS)]

    def fresh():
        params, opt = init_train_state(model, tcfg, seed, device="cuda")
        return {"params": params, "opt": opt}

    step = make_train_step(model, tcfg, group=dist.group.WORLD)
    clean = fresh()
    n_params = sum(t.numel() for t in TR.leaves(clean["params"]))
    nbytes = sum(t.numel() * t.element_size() for t in TR.leaves(clean))
    require(n_params == RESTART_PARAMS,
            f"restarts: {n_params} parameters, not {RESTART_PARAMS}")
    print(f"[restarts] {cfg.name} at full layer width, {cfg.num_layers} of "
          f"its 16 layers, {n_params} parameters, {nbytes} bytes of "
          f"training state; batch {TRAIN_B} x {TRAIN_S}, {RESTART_STEPS} "
          f"steps, save every {RESTART_SAVE_EVERY}, keep {RESTART_KEEP}; "
          f"failures after step(s) {RESTART_FAIL_AFTER} and before "
          f"{RESTART_FAIL_BEFORE}")
    clean_losses = []
    for i in range(RESTART_STEPS):
        p, o, m = step(clean["params"], clean["opt"], batches[i])
        clean = {"params": p, "opt": o}
        clean_losses.append(float(m["loss"]))
    print(f"  restarts: the uninterrupted run's losses {clean_losses}")

    class Timed(Checkpointer):
        """Each save's and restore's seconds, the card synchronised."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.times = []

        def save(self, step_, tree, *, blocking=True):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            super().save(step_, tree, blocking=blocking)
            self.times.append(("save", step_, time.monotonic() - t0))

        def restore(self, step_, like_tree):
            t0 = time.monotonic()
            out = super().restore(step_, like_tree)
            torch.cuda.synchronize()
            self.times.append(("restore", step_, time.monotonic() - t0))
            return out

    fail_after, fail_before = set(RESTART_FAIL_AFTER), set(RESTART_FAIL_BEFORE)
    ran, losses = [], {}

    def step_fn(i, state):
        if i in fail_before:
            fail_before.discard(i)
            raise InjectedFailure(f"injected before step {i}")
        t0 = time.monotonic()
        p, o, m = step(state["params"], state["opt"], batches[i])
        losses[i] = float(m["loss"])               # waits for the step
        ran.append((i, 1e3 * (time.monotonic() - t0)))
        if i in fail_after:
            fail_after.discard(i)
            raise InjectedFailure(f"injected after step {i} updated the "
                                  f"state in place")
        return {"params": p, "opt": o}

    directory = tempfile.mkdtemp(prefix="chip_smoke_restarts_")
    try:
        ckpt = Timed(directory, keep=RESTART_KEEP)
        state = fresh()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.monotonic()
        out = run_with_restarts(RESTART_STEPS, step_fn, state, ckpt,
                                save_every=RESTART_SAVE_EVERY)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, kinds = launch_counts(), launch_kinds()
        kept = ckpt.all_steps()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    executed = [i for i, _ in ran]
    want = [0, 1, 0, 1, 2, 3, 4, 5]
    require(executed == want,
            f"restarts: steps ran in the order {executed}, expected {want}")
    train_launch_counts(cfg, counts, kinds, len(executed),
                        f"restart run, {len(executed)} step executions")
    require(kept == [RESTART_STEPS - RESTART_SAVE_EVERY, RESTART_STEPS],
            f"restarts: committed steps {kept} at the end")
    got, ref = TR.flatten_with_paths(out), TR.flatten_with_paths(clean)
    require([p for p, _ in got] == [p for p, _ in ref],
            "restarts: the final state's tree differs from the "
            "uninterrupted run's")
    for (path, a), (_, b) in zip(got, ref):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise SmokeFailure(f"restarts: {path} differs from the "
                               f"uninterrupted run (max |diff| "
                               f"{max_err(a.detach(), b.detach())!r})")
    require([losses[i] for i in range(RESTART_STEPS)] == clean_losses,
            f"restarts: losses {losses} against {clean_losses}")
    print(f"  restarts: the final parameters and AdamW state equal the "
          f"uninterrupted run's bit for bit in all {len(got)} leaves; "
          f"steps ran {executed} ({len(executed) - RESTART_STEPS} "
          f"re-executed), {wall!r} s in all")
    print("  restarts: step times (host clock, ms) " + ", ".join(
        f"{i}: {ms:.1f}" for i, ms in ran))
    for kind, s_, sec in ckpt.times:
        print(f"  restarts: {kind} of step {s_}: {sec!r} s, "
              f"{nbytes / sec / 1e9!r} GB/s ({nbytes} bytes)")
    del out, clean, state, batches
    return counts, kinds


def run_distributed(seed: int):
    """The distributed phase: a NCCL group of one rank and its mesh, the
    layout of olmo-1b's full-width parameters, the compressed all-reduce
    on its full-width gradient tree, then the restart run (the main path:
    its launch counts and counts by kind are returned)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models import build_model
    from repro_torch.training.train_step import loss_and_grads
    torch.cuda.set_device(0)        # the mesh's communicators' device
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        require(dist.get_backend() == "nccl",
                f"distributed: backend {dist.get_backend()}, not nccl")
        mcfg = MeshConfig(*DIST_MESH)
        mesh = make_mesh_from_config(mcfg)
        require(mesh.device_type == "cuda"
                and tuple(mesh.mesh_dim_names) == mcfg.axes
                and tuple(mesh.shape) == mcfg.shape,
                f"distributed: mesh {mesh}")
        group = mesh.get_group("data")
        print(f"[distributed] NCCL, world size {dist.get_world_size()}, "
              f"mesh {dict(zip(mcfg.axes, mcfg.shape))} on "
              f"{mesh.device_type}; the data axis's group backend "
              f"{dist.get_backend(group)}")
        cfg = get_config(DIST_ARCH)
        params = check_layout(mesh, mcfg, cfg, seed)
        _, _, grads = loss_and_grads(build_model(cfg), params,
                                     train_batch(cfg, 0, seed))
        del params
        check_allreduce(group, grads)
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        return run_restarts(cut_config(cfg, **RESTART_CUT), seed)
    finally:
        dist.destroy_process_group()


# the calibration's child: olmo-1b's train phase shape on a 1 x 1 mesh over
# a fake group of one rank, its info (with the roofline) as JSON
DRYRUN_CALIBRATE = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import MeshConfig, ShapeConfig, ShapeKind
from repro_torch.launch import dryrun as DR
arch, batch, seq, path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
cfg = get_config(arch)
info = DR.trace_cell(cfg, ShapeConfig("calibration", seq, batch,
                                      ShapeKind.TRAIN),
                     MeshConfig((1, 1), ("data", "model")))
info.update(arch=arch, shape="calibration", chips=1, kind="train",
            kv_cache_dtype=cfg.kv_cache_dtype,
            active_params_b=cfg.active_param_count())
info["roofline"] = DR.roofline_terms(info)
json.dump(info, open(path, "w"))
"""


def start_dryrun():
    """Start the dry-run's children: the calibration and one child a cell
    of DRYRUN_CELLS (``python -m repro_torch.launch.dryrun``), each on its
    own fake process group and on no device (CPU alone, beside the
    kernels' build).  Returns (their Popens by name, the start time)."""
    out = os.path.join(ROOT, "build", "dryrun")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    jobs = {"calibration": [sys.executable, "-c", DRYRUN_CALIBRATE,
                            DRYRUN_CALIBRATION, str(TRAIN_B), str(TRAIN_S),
                            os.path.join(out, "calibration.json")]}
    for arch, shape, mesh in DRYRUN_CELLS:
        jobs[f"{arch} x {shape} x {mesh}"] = [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", mesh, "--outdir", out]
    return {name: subprocess.Popen(cmd, env=env, cwd=ROOT,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
            for name, cmd in jobs.items()}, time.monotonic()


def stop(procs) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def wait_dryrun(started) -> float:
    """Wait for every child (before any timed phase, so none shares the
    host with one); each must exit 0.  Returns the children's seconds."""
    procs, t0 = started
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
    finally:
        stop(procs)
    for name, proc in procs.items():
        require(proc.returncode == 0, f"dryrun {name}: exit "
                f"{proc.returncode}\n{logs.get(name, '')[-3000:]}")
    return time.monotonic() - t0


def report_dryrun(seconds: float, real) -> None:
    """The dry-run phase's gates and lines: the calibration against the
    train phase's olmo-1b (``real``: ``run_train``'s stats), then each
    cell."""
    from repro_torch.launch import dryrun as DR
    out = os.path.join(ROOT, "build", "dryrun")
    info = json.load(open(os.path.join(out, "calibration.json")))
    require(info["param_bytes"] == real["param_bytes"],
            f"dryrun calibration: {info['param_bytes']} parameter bytes "
            f"predicted, the real tree holds {real['param_bytes']}")
    require(info["opt_state_bytes"] == real["opt_state_bytes"],
            f"dryrun calibration: {info['opt_state_bytes']} AdamW-state "
            f"bytes predicted, the real tree holds "
            f"{real['opt_state_bytes']}")
    require(info["mem_argument_bytes"] > 0 and info["hlo_flops"] > 0
            and info["hlo_bytes"] > 0,
            f"dryrun calibration: {info}")
    roof = info["roofline"]
    step_s = real["step_ms"] * 1e-3
    peak = DR.per_rank_bytes(info)
    print(f"dryrun calibration: {DRYRUN_CALIBRATION} {TRAIN_B} x {TRAIN_S} "
          f"train, 1 x 1 mesh: parameters {info['param_bytes']} and AdamW "
          f"state {info['opt_state_bytes']} bytes, both equal to the real "
          f"trees'; peak {peak} bytes predicted against "
          f"max_memory_allocated {real['peak']} ({peak / real['peak']!r}); "
          f"FLOPs {info['hlo_flops']!r} predicted against the model FLOPs "
          f"{real['model_flops']!r} (remat not counted; excess "
          f"{info['hlo_flops'] - real['model_flops']!r}); roofline at the "
          f"H100's peaks: compute {roof['t_compute_s']!r} s, memory "
          f"{roof['t_memory_s']!r} s (no fusion; {roof['t_memory_lb_s']!r} "
          f"s with ideal fusion) against the measured step "
          f"{step_s!r} s: compute {roof['t_compute_s'] / step_s!r} of it, "
          f"memory {roof['t_memory_s'] / step_s!r}; traced in "
          f"{info['compile_s']} s")
    for arch, shape, mesh in DRYRUN_CELLS:
        cell = json.load(open(os.path.join(out, f"{arch}__{shape}__{mesh}"
                                                ".json")))
        print(f"dryrun cell: {DR.cell_line(cell)}")
        want = DRYRUN_PEAKS[arch, shape, mesh]
        print(f"  peak of live bytes {cell['mem_temp_bytes']} on torch "
              f"{cell['torch_version']}, the CPU's torch 2.13 {want}")
        require(cell["mem_temp_bytes"] == want,
                f"dryrun {arch} x {shape} x {mesh}: peak "
                f"{cell['mem_temp_bytes']} bytes, the CPU's {want}: the op "
                f"sequences differ (tools/peak_live_probe.py)")
        jax = DRYRUN_JAX_FLOPS.get((arch, shape, mesh))
        if jax:
            print(f"  FLOPs a rank {cell['hlo_flops']!r}, JAX's {jax!r} "
                  f"({cell['hlo_flops'] / jax!r})")
            require(abs(cell["hlo_flops"] / jax - 1) < DRYRUN_FLOPS_TOL,
                    f"dryrun {arch} x {shape} x {mesh}: FLOPs "
                    f"{cell['hlo_flops']} against JAX's {jax}")
    print(f"[dryrun] {1 + len(DRYRUN_CELLS)} processes side by side, "
          f"beside the build, in {seconds:.1f} s")


def count_launches(kernels, launches, by_model, kinds_by_model,
                   trains) -> None:
    """Write into each entry of the kernels line its launches on the main
    paths (in total, by model, and each row's own), and require every row
    on a main path to have launched."""
    for k in kernels:
        name = k["name"]
        k["launches"] = launches[name]
        k["launches_by_model"] = {m: n[name] for m, n in by_model.items()}
        for row in k.get("models", []):
            if not row.get("main_path", True):
                continue
            # the wrapper's own count of the launches of the row's kind
            # (flash: its window; paged: its cache's capacity) in the
            # row's model's runs on the main path; the backward's calls in
            # the row's training
            if "launches" not in row:
                row["launches"] = (
                    by_model[row["model"]][name]
                    if name.endswith("_bwd") else
                    kinds_by_model[row["model"]][name].get(
                        row[kind_of(name)], 0))
            require(row["launches"] > 0,
                    f"{name}: the main path never launched it on "
                    f"{row['model']}'s {kind_of(name)} "
                    f"{row.get(kind_of(name))}")
        k["passed"] = True
        if name.endswith("_bwd"):            # each pass, in training
            passes = {p for t in trains for p in kinds_by_model[t][name]}
            k["pass_launches"] = {p: sum(kinds_by_model[t][name].get(p, 0)
                                         for t in trains)
                                  for p in sorted(passes)}
        if name.startswith("ssd_scan"):   # the variants the main path ran
            key = name if name == "ssd_scan" else f"{name} variant"
            k["variant_launches"] = {v: sum(
                kinds.get(key, {}).get(v, 0)
                for kinds in kinds_by_model.values())
                for v in ("wgmma", "cuda_core")}
            k["variant"] = "+".join(
                v for v, n in k["variant_launches"].items() if n)
        del k["shape"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.monotonic()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PosEmb
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"(count={torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda})")
    print(card)

    # 2. build, the dry-run's children beside it (CPU alone)
    dryrun = start_dryrun()
    t0 = time.monotonic()
    try:
        lib_path = build.build()
        build.load()
        print(f"[build] {lib_path.relative_to(ROOT)} in "
              f"{time.monotonic() - t0:.1f} s")
        dryrun_s = wait_dryrun(dryrun)
    finally:
        stop(dryrun[0])
    print(f"  (the dry-run's children done "
          f"{time.monotonic() - t_start:.1f} s into the run)")
    kernel, serialised = "", 0
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        if "Compiling entry" in line:
            kernel = kernel_label(line)
        elif "Used" in line or "spill" in line:
            print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")
        serialised += "C7519" in line    # wgmma fenced by ptxas
    print(f"  ptxas injected {serialised} warpgroup.arrive fences")

    # 3. kernels against their plain versions (flash's backward too)
    from repro_torch.models import build_model
    cfgs = [cut_config(get_config(a), **CUT.get(a, {})) for a in ARCHS]
    # the prompt lengths come first from the seed: the same for every vocab
    traffic = {cfg.name: engine_traffic(
        args.seed, cfg.vocab_size,
        cfg.sliding_window + PAST_WINDOW if cfg.sliding_window else 0)
        for cfg in cfgs}
    # the main shapes are the first model's (olmo-1b's heads)
    prompt_lens = [len(p) for p in traffic[ARCHS[0]][0]]
    max_len = traffic[ARCHS[0]][1]
    # every further attention model's own heads, windows and softcap
    models = [(cfg, [len(p) for p in traffic[cfg.name][0]],
               traffic[cfg.name][1]) for cfg in cfgs[1:]
              if not cfg.attention_free]
    # every hybrid model's SSD scan at its own heads, at its longest prompt
    hybrids = [(cfg, max(len(p) for p in traffic[cfg.name][0]))
               for cfg in cfgs if cfg.attn_every]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    print(f"[kernels] engine prompt lengths {prompt_lens}, max_len "
          f"{max_len}" + "".join(f"; {cfg.name}'s {lens}, max_len {n}"
                                 for cfg, lens, n in models
                                 if cfg.sliding_window))
    encdec = get_config(ENCDEC)
    kernels = [check_flash(prompt_lens,
                           [(cfg, lens) for cfg, lens, _ in models], encdec,
                           gen),
               check_paged(max_len, prompt_lens, models, encdec, gen),
               check_ssd(prompt_lens, hybrids, gen),
               check_flash_bwd(gen),
               check_ssd_bwd(gen)]
    for k in kernels:
        print(f"  {k['name']} at {k['shape']}: {times_text(k)}")
    time_logits(gen)
    print(f"  (kernels checked and timed {time.monotonic() - t_start:.1f} s "
          f"into the run)")

    launches = dict.fromkeys((k["name"] for k in kernels), 0)
    by_model, kinds_by_model = {}, {}
    for arch, cfg in zip(ARCHS, cfgs):
        # 4. model
        prompts, max_len = traffic[cfg.name]
        lens = [len(p) for p in prompts]
        t0 = time.monotonic()
        params = build_model(cfg).init(args.seed, device="cuda")
        n_params = sum(t.numel() for t in _leaves(params))
        width = cut_label(get_config(arch), cfg)
        print(f"[model] {cfg.name} {width}, {n_params} parameters, "
              f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
              f"KV cache {cfg.kv_cache_dtype}, initialised in "
              f"{time.monotonic() - t0:.1f} s")
        # a windowed model's check: one prompt past the window
        shape = (dict(B=1, P=cfg.sliding_window + CHECK_PAST_WINDOW)
                 if cfg.sliding_window else {})
        check_model(cfg, params, args.seed, **shape)
        if cfg.sliding_window:
            print_ring_wrap(cfg, max(lens), max_len)
        if cfg.attn_logit_softcap:
            check_softcap_binds(cfg, params, args.seed)
        if cfg.pos_emb == PosEmb.MROPE:
            check_mrope(cfg, params, args.seed)
        if cfg.kv_cache_dtype == "int8" or arch in INT8_AT_WIDTH:
            check_int8(cfg, params, args.seed, **shape)
        if cfg.moe is not None:
            check_moe_layer(cfg, params, max(lens), args.seed)
        profile_prefill(cfg, params, max(lens), args.seed)
        step_ms, busy_ms = profile_decode(cfg, params, lens, max_len)
        if arch in INT8_AT_WIDTH:
            int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
            step8_ms, busy8_ms = profile_decode(int8, params, lens, max_len)
            print(f"  model: {cfg.name}'s int8 KV caches cost "
                  f"{busy8_ms - busy_ms!r} ms of device time a decode step "
                  f"({busy8_ms!r} against bf16's {busy_ms!r}: quantizing "
                  f"each write, dequantizing every layer's whole cache) "
                  f"and {step8_ms - step_ms!r} ms on the host clock")

        # 5. engine (the main path: counters reset just before each mode)
        print(f"[engine] {cfg.name}: {N_REQUESTS} requests x {MAX_NEW} new "
              f"tokens, burst, max_num_seqs={MAX_NUM_SEQS}")
        by_model[cfg.name], kinds_by_model[cfg.name], tokens = run_engine(
            cfg, params, prompts, max_len)
        for name, n in by_model[cfg.name].items():
            launches[name] += n
        if arch == ARCHS[0]:
            print(f"[sanitize] {cfg.name}: the engine's traffic again under "
                  f"FLEX_SANITIZE=1 in {', '.join(SANITIZED_MODES)}")
            run_sanitized(cfg, params, prompts, max_len, tokens)
        # the engines' reference cycles (each replica holds its engine,
        # which holds the params) outlive run_engine until the cyclic
        # collector runs: collect them, or the next model finds the card
        # still holding this one
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {cfg.name} freed: {torch.cuda.memory_allocated()} bytes "
              f"still allocated on the card "
              f"({time.monotonic() - t_start:.1f} s into the run)")

    # 4-5. the encoder-decoder, at model level: the engine feeds token
    # prompts, and its prefill needs frame embeddings
    t0 = time.monotonic()
    params = build_model(encdec).init(args.seed, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] {encdec.name} full width, {n_params} parameters, "
          f"{encdec.encoder_layers} encoder + {encdec.num_layers} decoder "
          f"layers, d_model {encdec.d_model}, {encdec.num_heads}/"
          f"{encdec.num_kv_heads} heads of {encdec.head_dim}, initialised "
          f"in {time.monotonic() - t0:.1f} s")
    require(n_params == ENCDEC_PARAMS,
            f"{encdec.name}: {n_params} parameters, not {ENCDEC_PARAMS}")
    check_encdec(encdec, params, args.seed)
    profile_encdec(encdec, params, args.seed)
    print(f"[main path] {encdec.name}: {ENCDEC_B} x {ENCDEC_FRAMES} frames, "
          f"{ENCDEC_PROMPT}-token prompts, {ENCDEC_NEW} greedy new tokens")
    by_model[ENCDEC], kinds_by_model[ENCDEC], noncausal = run_encdec(
        encdec, params, args.seed)
    for name, n in by_model[ENCDEC].items():
        launches[name] += n
    # flash's rows at the encoder-decoder's uses: the wrapper counts the
    # encoder's and the cross-attention's launches together (not causal),
    # and the decoder's self-attention apart
    causal = kinds_by_model[ENCDEC]["flash_attention"].get(0, 0) - noncausal
    for row in kernels[0]["models"]:
        if row["model"] == ENCDEC:
            row["launches_of"] = ("its causal launches" if row["causal"] else
                                  "its launches not causal (the encoder's "
                                  "and the cross-attention's together)")
            row["launches"] = ((causal if row["causal"] else noncausal)
                               if row["main_path"] else 0)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the simulator: InstanceSpec's derates against olmo-1b's own step
    # times, then the cluster simulation on the H100's cost model
    run_sim_phase(traffic, args.seed)

    # 6. training: olmo-1b, then gemma2-2b (the backward at D = 256 under
    # its softcap), then mamba2-780m (the SSD scan and its backward), then
    # mixtral-8x7b cut to 2 layers (MoE through the sorted dispatch), then
    # seamless-m4t-medium (its encoder in fp32), the forward and backward
    # kernels
    trains = [f"{arch} training" for arch in TRAIN_PARAMS]
    measured = {}
    for arch, train in zip(TRAIN_PARAMS, trains):
        by_model[train], kinds_by_model[train], measured[arch] = run_train(
            arch, args.seed)
        for name, n in by_model[train].items():
            launches[name] += n
        print(f"  ({train} done {time.monotonic() - t_start:.1f} s into the "
              f"run)")
    # flash's and its backward's rows at the encoder-decoder's training
    # uses: each wrapper counts its launches not causal (the encoder's and
    # the cross-attention's) apart from the decoder's causal ones
    train = f"{ENCDEC} training"
    for k in (kernels[0], kernels[3]):
        noncausal = kinds_by_model[train][f"{k['name']} noncausal"]
        for row in k["models"]:
            if row["model"] == train:
                row["launches"] = (noncausal if not row["causal"] else
                                   by_model[train][k["name"]] - noncausal)

    # 7. the distributed layer: olmo-1b's layout and compressed all-reduce
    # at full width, then its training step cut to 2 layers under
    # run_with_restarts (the main path: counters reset just before)
    restarts = f"{DIST_ARCH} restarts"
    by_model[restarts], kinds_by_model[restarts] = run_distributed(
        args.seed)
    for name, n in by_model[restarts].items():
        launches[name] += n
    trains.append(restarts)
    print(f"  (distributed done {time.monotonic() - t_start:.1f} s into the "
          f"run)")

    # 8. the dry-run (its children ran beside the build): the calibration
    # against the train phase's olmo-1b, then the production cells
    report_dryrun(dryrun_s, measured[DRYRUN_CALIBRATION])

    # 9. report
    count_launches(kernels, launches, by_model, kinds_by_model, trains)
    print(f"[report] the run took {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
