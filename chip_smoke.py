#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

1. Builds the port's CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a)
   and prints the build time and what ptxas reports.
2. Holds each kernel against its plain PyTorch version on the card at the
   serving paths' shapes, and times kernel, plain version and, where one
   exists, the closest single PyTorch call (a yardstick only; the port
   never calls it): decode attention at llama3.2-1b's decode shape (and
   rows of length 0, and the GQA groups 3, 5 and 48 of llama3.2-3b,
   llama4-maverick and granite-34b, checked; float32 reruns bit-equal),
   the WKV6 recurrence at rwkv6-1.6b's decode and prefill shapes (decode
   on the decode route, a rerun and the state written over state0
   bit-equal; prefill on the chunked route, with decays near 0 and near
   1 too; the step kernel they replaced timed on the same inputs; both
   routes timed around the route's threshold),
   and at rwkv6-1.6b's training forward (B 2, T 256, from zeros).
   Then each at the shapes the fast kernels are not built for (ROADMAP
   C10): decode_attn at head_dims 80, 96 and 256 (float32 and bf16, G 1
   and 4, a row of length 0, S 600) and wkv6 at D 80 and 256 on both
   routes (T 16 and 256), on their any-D kernels.  Then the wkv6
   backward kernels against float64 autograd through the plain
   recurrence (each gradient within the larger of 1e-4 of its max|g|
   and the plain backward's own error): at the training shape (B 2, T
   256) in bf16 and float32 with decays as the model draws them, near 0
   and near 1 (the parallel route), and from a nonzero state at T 100, D
   64 (parallel) and T 48, D 80 (the first kernel's step route); two
   calls equal bit for bit; timed beside the first kernel's chunked
   route on the same inputs (prev_ms) and the plain backward, split by
   pass.
3. The Table-I kernels (phase_table1_kernels): gemm_os at llama3.2-1b's
   ffn_in GEMM site (prefill in bf16 and float32, decode in bf16, the
   fused bias+silu and bias+gelu epilogues in both types, a ragged
   shape, both tile grids bit for bit, two calls bit for bit), conv2d_os
   at the paper's Table-I CONV as a batch of 32 edge images (bf16,
   float32) and as Listing 2 writes it (one input channel), and
   qgemm_int8 at the ffn_in site, bit for bit; each held against its
   plain version and timed like the others.  The float32 cases run on
   the tf32x3 routes (three TF32 products a term): each also prints its
   max error against a float64 product beside the library call's own
   float32 error (TF32 off) on the same inputs, and fails past
   TF32X3_ERR_FACTOR times it.  Then qgemm_int8 at K 140000 (all -128: K
   * 16384 wrapped to int32, times the scales; and random), conv2d_os
   over 65536 images (float32 on simt, beside the tf32x3 entry on the
   same inputs) and with 12 x 12 taps (the streaming route), and
   conv2d_os float32 on both the tf32x3 and SIMT entries across output
   sizes and channel counts (CONV_FILL), beside the route the rule
   picks.  Then
   holds each row of the kernel path's entry point,
   repro_torch.bench.bench_kernel_micro, on the row's own inputs against
   the plain version, times its float32 rows' kernels (gemm_os_256_torch
   on tf32x3, beside the SIMT kernel it replaced; decode_attn_torch on
   simt, one kernel a call, bit-equal on rerun, and the SIMT entry at
   32 to 512 rows a split) beside the library calls, drives the entry
   point, and checks
   that each kernel launched exactly as often as its rows called it, on
   the routes the rule gives them (gemm_os: 22 tensor_core, 22 tf32x3).
   Every kernel has at least two routes, chosen by its kernel.route
   (tensor_core, tf32x3 and simt; wkv6 decode, step and chunked); every
   case of
   steps 2 and 3 prints the route it ran on, from the ops' per-route
   launch counts, and fails unless it is the one the rule gives (bf16,
   and int8, at the full-size shapes on the tensor cores, float32 on
   tf32x3, conv2d_os from 12 input channels; wkv6 prefill on chunked).
   Where a case runs on a redesigned route, the kernel that route
   replaced is held and timed on the same inputs (prev_ms).
   torch._int_mm is timed in every layout of b it accepts.  Then C16
   (phase_c16): gemm_os float32 at M = K = N = 60000 from seeded
   torch.randn on the card, on tf32x3 as panel products under the 2 GiB
   scratch cap: 256 sampled entries against float64 dot products, its
   time, panels, rate against the SIMT kernel's at ffn_in and peak
   memory against the operands + the cap + 1 GiB.
4. The CGRA flow (phase_cgra): compiles the ten-kernel verification set
   (six Table-I kernels at small dims, four DSL kernels) on the host with
   repro_torch.core.Toolchain, verifies each over 1024 seeds on the card
   (golden oracle; the card's banks for seeds 0-3 against the CPU's),
   the reloaded artifacts over 256 seeds (the torch DFG oracle on the
   card, itself held against the numpy oracle), dwconv and requant-int8
   stacked over fabrics of 4, 8 and 16 registers, and full-size
   CONV-U-C-1 over 64 seeds; profiles one 1024-image simulate_batch;
   runs the flow's bench rows (repro_torch.bench.bench_sim_throughput,
   bench_verify_batched) and holds them against those steps.
   Every result is compared word for word; none of the five kernels
   may launch on this path.
5. The flow's tools on the same set (phase_cgra_tools): (a) exports the
   instruction streams (GEMM's byte-equal to the committed golden file)
   and runs the standalone interpreter against the card's simulator on
   every kernel over seeds 0-3; (b) the static checker on cluster_4x4
   and its torus and on morpher_8x8 (the set's kernels that map there in
   seconds; no diagnostic; check_report.json's sha256 printed),
   the seeded mutation gate on the card equal to the CPU's, and the
   dead-mutant probe on the card equal to the CPU's for every
   config-layer mutant class; (c) verify_batch under MORPHER_CHECK=1 and
   MORPHER_XVAL=1, and a corrupt artifact refused by the check gate
   before anything simulates; (d) the tiny design-space sweep cold (its
   compiles fanned out through the supervised compile fleet, whose
   workers must not have initialised CUDA; bench_dse_sweep's rows taken
   from it), warm and resumed from its checkpoint, each
   dse_frontier.json byte-equal to the committed
   benchmarks/results/after/dse_frontier_tiny.json; (e) an NSGA-II search
   verifying on the card, its frontier byte-equal to the CPU's.  Prints
   the tools' bench rows (repro_torch.bench) and each step's seconds.
6. CGRA-backed serving (phase_serve_cgra): builds on the host the
   ServePlan of each of the ten configs at 64 tokens on cluster_4x4,
   round-trips each through to_json / from_json, embedded and ref-only
   (resolved through Toolchain.load_artifact), and prints its sha256;
   spot-checks llama3.2-1b's plan on the card (seeds 0-255) and on the
   CPU (seeds 0-3); serves llama3.2-1b at full width and depth on the
   card under CGRAExecutionModel(plan), 12 Poisson requests over 4 slots,
   with decode_attn on the tensor cores once per layer and decode step,
   and holds the report byte for byte to a CPU engine's over the same
   config cut to one layer; then runs repro_torch.bench.
   bench_serve_decode on the card, whose rows must equal the committed
   benchmarks/results/after/BENCH_serve_decode.json rows.
7. Serves llama3.2-1b, rwkv6-1.6b, llama3.2-3b, codeqwen1.5-7b,
   granite-34b, zamba2-1.2b, llama4-maverick and deepseek-v3 at full
   width (random weights from a seed) through the port's Engine, all at
   full depth but granite-34b, cut to 40 of its 88 layers (88 layers of
   bf16 weights take 88 GiB, more than the card), llama4-maverick, cut to
   1 of 48 (one layer of 128 experts, 34.2 GiB), and deepseek-v3, cut to
   its 3 dense layers and 1 MoE layer of 256 experts, with its MTP head
   (28.8 GiB): 12 requests over 8 slots each, so slots are reused, and
   checks that the model's kernel ran as its path says: decode_attn on
   the tensor cores once per layer in every decode step (head_dim 64 or
   128, GQA groups 4, 3, 1, 48 and 5), or once per application of
   zamba2's shared attention block (6 a step); wkv6 in every decode step
   and every prefill (decode on the decode route, each prefill on the
   route its length gives); and neither kernel on deepseek-v3's MLA path.  Then
   holds one decode step's logits, kernel-backed, against the same step
   with the plain version (for deepseek-v3: logits finite and shaped
   right, and the MLA latent caches written at rows [0, length) of each
   slot and zero past them), and profiles a few decode steps (the
   kernel's share of the device-busy time and of the step).  zamba2's
   batch-1 prefill of 1024 tokens is timed and profiled (launches per
   token: its SSD scan is a loop over time), and deepseek-v3's MTP head
   runs once.
8. Runs musicgen-large and llava-next-mistral-7b (embeddings in, served
   by no engine) at full size at model level (phase_embedded): a batch-8
   prefill of 512 seeded N(0, 1) embeddings merged into an 8 x 2048
   cache, 32 decode steps of seeded embeddings with decode_attn on the
   tensor cores once per layer and step, one more step held against the
   plain version.
9. Holds the new families' code that runs no kernel of its own (MoE
   routing, MLA, MTP, the Mamba2 scan, embedding inputs) card against
   CPU (phase_card_cpu): zamba2, llama4-maverick, deepseek-v3,
   musicgen-large and llava-next at serve_smoke_config size in float32,
   a prefill and 3 chained decode steps, logits within 1e-4 and every
   MoE routing's expert and kept choices equal.
10. The paper's Table I (phase_table1, benchmarks/table1_torch.py):
   mapped on the host, verified by simulation on the card (the
   simulator's launches counted; none of the five kernels), every row
   equal to the host's run(verify=False).
11. Trains llama3.2-1b (16 layers, B 4 x T 1024, 6 steps, then one
   2-microbatch step whose loss is within 1% of the unbatched one) and
   rwkv6-1.6b (24 layers, B 2 x T 256, 4 steps, wkv6 on the chunked
   route and its backward kernels on the parallel route once a layer and
   step each, the plain
   versions patched to raise) at full size through repro_torch.train
   (phase_train): losses finite and falling, ms a step, tokens/s, peak
   GiB, the rwkv6 step's split: forward, backward, backward kernel;
   every wkv6 call of one rwkv6 training forward held against the plain
   version (in float64) on the inputs the model made; one more step of
   each counted by repro_torch.roofline.hlo's cost_terms on the card's
   tensors gives the achieved share of 989 TFLOP/s.  Then both at full
   size in float32 (phase_train_grads): llama3.2-1b's 2-microbatch
   gradients against the whole batch's, rwkv6's gradients with the wkv6
   kernels against those with the plain recurrence in its place, 1e-4,
   and each of the 24 backward kernel calls on the model's own inputs
   against float64 autograd as in step 2.
12. One training step of each of the seven families at reduced() size,
   card against CPU in float32 (phase_train_card_cpu): loss, grad_norm
   and gradients within 1e-4, MoE choices equal; and the wkv6
   autograd Function's gradients (the backward kernel) against autograd
   through the plain recurrence.
13. Checkpointing (phase_checkpoint): examples/train_lm_torch.py at its
   defaults (~88 M float32 parameters, B 8 x T 128, 200 steps, a
   checkpoint every 50) as a subprocess under deterministic algorithms,
   uninterrupted and, alongside it, killed after logging step 120, then
   resumed: the
   resumed run's logged lines and its final checkpoint's arrays equal the
   uninterrupted run's bit for bit.  Then rwkv6-1.6b at full width cut to
   2 of 24 layers (B 2 x T 256, wkv6 on chunked): two steps, an async
   save timed under the third step, a restore into a fresh state equal to
   the snapshot word for word, whose next step's loss equals the live
   state's bit for bit and its gradients within 1e-4 of max|g|.
14. The launch dry run (phase_dryrun): python -m
   repro_torch.launch.dryrun on llama3.2-1b decode_32k, and on
   deepseek-v3's decode_32k, prefill_32k and train_4k and zamba2-1.2b's
   train_4k cut to 2 layers (ROADMAP C15: the card machine's torch
   refused them before launch/rules.py's repairs), and python -m
   repro_torch.roofline.run on llama3.2-1b and rwkv6-1.6b train_4k, on
   the fake 16x16 mesh of fake tensors of the card's type: exit 0, every
   record ok.
Steps 4 and 5 run in a second process on the same card (this script
with --cgra-process), started once step 3 has taken the kernels' times
and running alongside steps 6-14: they are bound by the host thread and
the compile pool, and leave the card idle most of the time.  Step 14's
subprocesses run alongside step 13.  Past 1140 s the run prints every
thread's stack, stops its child processes and exits 1.
15. Prints each phase's seconds, the kernels as one JSON line (launches:
   the sums over the serving paths of steps 6-8 and the kernel path, on
   the entry's kernel_route where it has one; the wkv6 entry at the
   training shape and the wkv6_backward entry, "path": "train", the
   training runs' and phase_checkpoint's rwkv6 steps'; the gemm_os and
   conv2d_os entries' f32_* fields, their float32 case on tf32x3, with
   its split of the call by kernel; path_f32_* fields on the gemm_os and
   decode_attn entries, the kernel path's float32 rows; c16_* fields on
   the gemm_os entry), the card's name
   and power limit, and as its last line
   {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
Any failure exits nonzero; without a card it exits 1 before doing work.
"""
from __future__ import annotations

import faulthandler
import filecmp
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import deque
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM, NVIDIA data sheet (dense): HBM rate and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12
# TF32 tensor rate, the card's fastest for float32 inputs: a float32
# product's bound is its 2MNK over this rate (tf32x3_bound)
PEAK_TF32 = 495e12
L2_BYTES = 50 * 2 ** 20

# Serving shapes: 8 slots of 2048 positions; llama3.2-1b has 32 query and
# 8 KV heads, rwkv6-1.6b 32 heads, both of 64
B, H, HKV, D, S_MAX = 8, 32, 8, 64, 2048
N_REQUESTS = 12
# bf16 outputs of kernel and plain version may land on neighbouring bf16
# values (one step is 2^-7 relative); float32 as tests/test_kernels.py.
KERNEL_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# wkv6 output (rtol, atol): float32 sums in another order, 1e-4; in bf16
# both round the same float32 value once, so they may land one bf16 step
# (2^-7 relative) apart.  Its float32 state: 1e-4 in both.
WKV6_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}
WKV6_STATE_TOL = 1e-4
WKV6_PREFILL_T = (1024, 777)
# wkv6 decay ranges: as the smoke draws them ("mid"), near 0 (a chunk's
# decay product underflows) and near 1 (the state carries the whole run)
WKV6_DECAYS = {"mid": (0.9, 0.999), "near0": (1e-4, 0.05),
               "near1": (0.999, 0.99999)}
# Batch-1 prompts (the engine's prefill) timed on both wkv6 routes, on
# either side of the route's threshold
WKV6_CROSSOVER_T = (48, 64)
# One full-depth decode step, kernel against plain version, both bf16:
# where the two round a kernel output to neighbouring bf16 values, the
# layers of random weights carry the difference into the logits.  Measured
# on an H100 for llama3.2-1b: 1.3% of the largest logit magnitude (5.7e-2
# of 4.3), argmax all equal.  Held to 5% for both models.
LOGITS_REL_TOL = 5e-2
PROFILE_STEPS = 4
# Table-I kernels (rtol, atol): float32 as tests/test_kernels.py holds the
# Pallas kernels; a bf16 output may land one bf16 step (2^-7 relative)
# from the plain version's, both rounding a float32 sum once.  Weights are
# drawn at 1/sqrt(fan-in), as a model's are, so sums are of order one.
TABLE1_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}
GEMM_DECODE_M = 8
GEMM_RAGGED = (1000, 2000, 777)
# A tf32x3 route's max error against a float64 product may be this many
# times the library call's own float32 error (TF32 off) on the same inputs
TF32X3_ERR_FACTOR = 8
# The CGRA flow's verification set and its seed batches (phase_cgra)
CGRA_SET = ("GEMM", "GEMM-U", "GEMM-U-C", "CONV", "CONV-U-C-1",
            "CONV-U-C-2", "dwconv", "avgpool2x2", "gemm-bias-relu",
            "requant-int8")
CGRA_SEEDS = {"fleet": 1024, "reloaded": 256, "stacked": 256, "full": 64}
# phase_cgra_tools: seeds of the interpreter cross-validation (a) and of
# the verify gates (c), and the search of step (e)
TOOLS_XVAL_SEEDS = range(4)
TOOLS_GATE_SEEDS = {"MORPHER_CHECK": range(256), "MORPHER_XVAL": range(4)}
TOOLS_SEARCH = dict(algo="nsga2", seed=0, generations=3, population=4)
# the kernels step (b) checks on morpher_8x8: the set's kernels that map
# there in seconds (GEMM-U-C, CONV-U-C-1, CONV-U-C-2 and dwconv map there
# only after minutes of II escalation)
TOOLS_CHECK_8X8 = ("GEMM", "GEMM-U", "CONV", "avgpool2x2",
                   "gemm-bias-relu", "requant-int8")
# phase_serve_cgra: the plans' token count, the spot check's seeds on each
# device, and the --cgra episode (the reference's bench_serve_decode
# traffic, at the example's batch and max_len)
CGRA_PLAN_TOKENS = 64
CGRA_SPOT_SEEDS = {"cuda": range(256), "cpu": range(4)}
CGRA_TRAFFIC = dict(seed=0, n_requests=12, arrival_rate=100.0)
CGRA_BATCH, CGRA_MAX_LEN = 4, 64
SERVE_DECODE_BENCH = os.path.join(ROOT, "benchmarks", "results", "after",
                                  "BENCH_serve_decode.json")
# The served configs and the depth each is cut to (None: full depth):
# granite-34b's 88 layers take 88 GiB of bf16 weights, more than the
# card's 80 GB, so it is served at 40 (about 41 GiB); llama4-maverick at 1
# of 48 (one layer of 128 experts: 18.4 B parameters with the embeddings,
# 34.2 GiB; two would be 64.6 GiB); deepseek-v3 at 4 of 61 (its 3 dense
# layers and 1 MoE layer of 256 experts, and the MTP block: 28.8 GiB)
SERVED = (("llama3.2-1b", None), ("rwkv6-1.6b", None), ("llama3.2-3b", None),
          ("codeqwen1.5-7b", None), ("granite-34b", 40),
          ("zamba2-1.2b", None), ("llama4-maverick-400b-a17b", 1),
          ("deepseek-v3-671b", 4))
# zamba2's prefill profiled at the longest prompt the episodes admit
PREFILL_PROFILE_T = 1024
# The embeddings-input configs, at full size, at model level (the engine
# feeds tokens): one batch-B prefill of EMBED_PREFILL_T embeddings, then
# EMBED_DECODE_STEPS decode steps
EMBEDDED = ("musicgen-large", "llava-next-mistral-7b")
EMBED_PREFILL_T, EMBED_DECODE_STEPS = 512, 32
# The configs of PR 20's families, card against CPU at serve_smoke_config
# size in float32 (TF32 off): prefill and CARD_CPU_STEPS chained decode
# steps, logits within CARD_CPU_TOL (rtol and atol)
CARD_CPU = ("zamba2-1.2b", "llama4-maverick-400b-a17b", "deepseek-v3-671b",
            "musicgen-large", "llava-next-mistral-7b")
CARD_CPU_STEPS, CARD_CPU_S, CARD_CPU_TOL = 3, 16, 1e-4
GOLDEN_CSV = os.path.join(ROOT, "tests", "golden_gemm_small_instructions.csv")
# phase_train: (config, batch, sequence length, steps, check a 2-microbatch
# step) at full size in bf16, random weights from seed 0, one repeated
# batch from the seeded synthetic token stream, remat on
TRAIN_RUNS = (("llama3.2-1b", 4, 1024, 6, True),
              ("rwkv6-1.6b", 2, 256, 4, False))
# rwkv6-1.6b's training batch and length: its wkv6 shape (B, T, 32, 64)
WKV6_TRAIN = TRAIN_RUNS[1][1:3]
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
TRAIN_DATA_SEED = 1234
# the 2-microbatch step's loss against the 1-microbatch loss at the same
# state (relative): bf16 sums over half the batch at a time
TRAIN_MICROBATCH_REL = 1e-2
# phase_train_grads: llama3.2-1b and rwkv6-1.6b at full size in float32
# (TF32 off), loss (relative) and each gradient (of its tensor's largest
# |g|): llama's 2-microbatch step against its 1-microbatch gradients,
# rwkv6's step with wkv6 on the kernel against the same with wkv6_ref in
# its place.  Only sum orders differ (1e-4 is the card-against-CPU bar,
# where every sum's order differs)
TRAIN_GRAD_REL = 1e-4
# phase_train_card_cpu: every family at reduced() size in float32 (TF32
# off), one step on card and CPU from the same params and batch: loss and
# grad_norm within TRAIN_CARD_CPU_REL relative, each gradient within it of
# its tensor's largest |g|
TRAIN_CARD_CPU = ("llama3.2-1b", "rwkv6-1.6b", "zamba2-1.2b",
                  "llama4-maverick-400b-a17b", "deepseek-v3-671b",
                  "musicgen-large", "llava-next-mistral-7b")
TRAIN_CARD_CPU_REL = 1e-4
# the wkv6 autograd Function (its backward the backward kernel) against
# autograd through wkv6_ref: (D, T)
WKV6_GRAD_CASES = ((64, 16), (64, 128), (80, 16), (80, 128))
# The wkv6 backward kernel against float64 autograd through wkv6_ref
# (phase_wkv6_check, phase_train_grads): each gradient within the larger
# of WKV6_GRAD_REL of its largest |g| and the plain backward's own error
# against float64 on that call (autograd through wkv6_ref in the call's
# dtypes: float32 steps, each gradient rounded once to its dtype, as the
# kernel's).  At the training shape (WKV6_TRAIN, from zeros, no state
# gradient, as training calls it) at each of WKV6_DECAYS, and at
# WKV6_BWD_SHORT (B, T, H, D): T < 64 (the forward's step route), D 80
# (outside the fast kernels' set), from a nonzero state with a state
# gradient
WKV6_GRAD_REL = 1e-4
WKV6_BWD_SHORT = (2, 48, 4, 80)
# and on the parallel route from a nonzero state with a state gradient, T
# a whole number of chunks of neither route
WKV6_BWD_STATE = (2, 100, 8, 64)
# the backward's route at rwkv6's training shape (kernel.backward_route)
WKV6_BWD_TRAIN_ROUTE = "parallel"
TINY_FRONTIER = os.path.join(ROOT, "benchmarks", "results", "after",
                             "dse_frontier_tiny.json")
# phase_checkpoint (a): examples/train_lm_torch.py at its defaults (~88 M
# float32 parameters, B 8 x T 128, 200 steps, a checkpoint every 50),
# uninterrupted, killed once it has logged step CKPT_CUT (and the
# checkpoint before it is on disk), then resumed; under deterministic
# algorithms, so the resumed run equals the uninterrupted one bit for bit
CKPT_STEPS = 200
CKPT_CUT = 120
CKPT_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# (b): rwkv6-1.6b at full width cut to CKPT_RWKV_LAYERS of 24 layers,
# B 2 x T 256 (wkv6 on the chunked route), two steps, an async save timed
# under the third step, a restore into a fresh state
CKPT_RWKV_LAYERS = 2
# phase_dryrun: the launch dry run and the roofline, as subprocesses
DRYRUN_CELL = ("llama3.2-1b", "decode_32k")
ROOFLINE_CELLS = ("llama3.2-1b:train_4k", "rwkv6-1.6b:train_4k")
# and the cells only the card machine's torch refused before their repairs
# in repro_torch.launch.rules (ROADMAP C15), cut to DRYRUN_C15_LAYERS
# layers: the refusals are per-layer idioms
DRYRUN_C15_CELLS = ("deepseek-v3-671b:decode_32k",
                    "deepseek-v3-671b:prefill_32k",
                    "deepseek-v3-671b:train_4k", "zamba2-1.2b:train_4k")
DRYRUN_C15_LAYERS = 2
# The argument that makes this script the CGRA process (phase_cgra and
# phase_cgra_tools), which the run starts alongside its other phases
CGRA_PROCESS_FLAG = "--cgra-process"
# Past this many seconds the run dumps every thread's stack, stops its
# children and exits 1: under the 1200 s that a caller allows it
WATCHDOG_S = 1140
# child processes this run started (the CGRA process, the dry runs, the
# train_lm_torch runs), stopped if the run fails or hangs
_CHILDREN: list = []


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def roofline(nbytes: float, ops: float, rate: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over ``rate``."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = ops / rate
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def tf32x3_bound(nbytes: float, flops: float):
    """(bound_ms, bound_by, design_ms) of a float32 product on a tf32x3
    route: the bound is the function's own flops at the TF32 rate against
    its bytes; the route's three TF32 products a term put the design's
    own ceiling at 3 * flops over that rate, printed beside the bound and
    never as it."""
    bound_ms, bound_by = roofline(nbytes, flops, PEAK_TF32)
    return bound_ms, bound_by, roofline(nbytes, 3 * flops, PEAK_TF32)[0]


def _tf32x3_bounds_text(ms: float, bound_ms: float, bound_by: str,
                        design_ms: float) -> str:
    return (f"bound {bound_ms:.5f} ms ({bound_by}, 2MNK at the TF32 rate), "
            f"{100 * bound_ms / ms:.1f}% of bound; the design's ceiling "
            f"(3 TF32 products) {design_ms:.5f} ms "
            f"({100 * design_ms / ms:.1f}%)")


def decode_attn_bound(lengths, dtype):
    """(bound_ms, bound_by): K/V rows up to each length read once, q read,
    output written; 4 flops per (query head, cached element)."""
    n, nb = int(sum(lengths)), len(lengths)
    nbytes = (2 * HKV * n * D + 2 * nb * H * D) * dtype.itemsize + 4 * nb
    return roofline(nbytes, 4 * H * n * D, PEAK_FLOPS[dtype])


def wkv6_bound(B, T, H, D, dtype, with_state0: bool):
    """(bound_ms, bound_by): r, k, v, w and u read once, the state read
    (when given) and written once, the output written; 5 D^2 float32
    flops per (batch, head, step): r . S is 2 D^2, diag(w) S + k^T v is
    3 D^2, and the u term, (sum_d r_d u_d k_d) v_e, is O(D)."""
    n = B * T * H * D
    nbytes = 5 * n * dtype.itemsize + 4 * H * D + \
        (2 if with_state0 else 1) * 4 * B * H * D * D
    return roofline(nbytes, 5 * B * H * T * D * D, PEAK_FLOPS[torch.float32])


def wkv6_backward_bound(B, T, H, D, dtype, with_state0: bool,
                        with_g_state: bool):
    """(bound_ms, bound_by) of the work the gradient needs
    (kernels/wkv6/ops.py: wkv6_backward_cost, float32 flops: 14 D^2 per
    (batch, head, step) for S_{t-1}, G, dr, dk, dv and dw, and 3 D^2 for
    the chunk entry states where T spans more than one chunk) over its
    bytes: r, k, v, w and g_out read and their four gradients written
    once, u read and du written, the states given read and dstate0
    written."""
    from repro_torch.kernels.wkv6.ops import wkv6_backward_cost
    flops, nbytes = wkv6_backward_cost(B, T, H, D, dtype.itemsize,
                                       with_state0, with_g_state)
    return roofline(nbytes, flops, PEAK_FLOPS[torch.float32])


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {sorted(_build.sources())} built in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"[build] nvcc -Xptxas -v for {name}:")
        print("\n".join("    " + ln for ln in log.strip().splitlines()
                        if "entry function" in ln or "Used" in ln
                        or "spill" in ln or "error" in ln))


def ran_on(op, want: str, label: str) -> str:
    """Raises unless every launch of ``op`` since its route counts were last
    zeroed ran on the ``want`` route; zeroes them again."""
    counts = dict(op.launches_by_route)
    op.launches_by_route.update(dict.fromkeys(counts, 0))
    if {r for r, c in counts.items() if c} != {want}:
        raise AssertionError(f"{label} ran on {counts}, not only on the "
                             f"{want} route")
    return want


def _simt_decode_attn(q, k, v, lens, chunk=None):
    """decode_attn on the SIMT route's C entry, whatever the rule would
    choose: in bfloat16 the kernel the tensor-core route replaced, run here
    as the redesign's "before"; with ``chunk`` (rows a split) in place of
    the split plan's.  q (B, H, D), k/v (B, Hkv, S, D)."""
    from repro_torch.kernels.common import cdiv
    from repro_torch.kernels.decode_attn import kernel as dk
    Bq, Hq, Dq = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    splits, planned = dk.plan("simt", Bq, Hkv, G, S, Dq, q.dtype,
                              dk._sm_count(q.device.index))
    if chunk is None:
        chunk = planned
    else:
        splits = cdiv(S, chunk)
    out = torch.empty_like(q)
    n = Bq * Hkv * splits * G
    part = torch.empty(n * (Dq + 2), dtype=torch.float32, device=q.device)
    base = part.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    tickets = dk._tickets(q.device, stream, Bq * Hkv * cdiv(
        G, dk.group_tile(G, "simt")))
    err = dk._entries()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           lens.data_ptr(), out.data_ptr(), base, base + 4 * n,
                           base + 8 * n, tickets.data_ptr(), Bq, Hkv, G, S,
                           Dq, splits, chunk, 1.0 / (Dq ** 0.5),
                           dk._DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"SIMT decode_attn launch failed: CUDA error {err}")
    return out


# decode_attn beyond llama3.2-1b's shape: (label, query heads, KV heads,
# head_dim) of the registry's groups that are no tile of their own
GQA_GROUPS = (("llama3.2-3b G=3", 24, 8, 128),
              ("llama4-maverick G=5", 40, 8, 128),
              ("granite-34b G=48", 48, 1, 128))


def _decode_attn_edge_checks(card: str):
    """decode_attn against its plain version where the serving shape does
    not go, each case on the route the rule gives it: rows of length 0
    (the mean of V over all S rows) beside rows of other lengths, at
    llama3.2-1b's shape, and the GQA groups of GQA_GROUPS, both dtypes."""
    from repro_torch.kernels.decode_attn.kernel import group_tile, route
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [("length 0", H, HKV, D, S_MAX,
              [0, S_MAX, 0, 1, 65, S_MAX // 2, 0, S_MAX - 1])]
    cases += [(label, hq, hkv, d, S_MAX,
               [0, 1, 63, 65, S_MAX, 1000, 129, S_MAX - 1])
              for label, hq, hkv, d in GQA_GROUPS]
    for dtype in (torch.bfloat16, torch.float32):
        for label, hq, hkv, d, S, lens_list in cases:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for shape in
                       ((B, hq, d), (B, hkv, S, d), (B, hkv, S, d)))
            lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
            got = decode_attn(q, k, v, lens)
            torch.cuda.synchronize()
            want = decode_attn_ref(q, k, v, lens)
            tol = KERNEL_TOL[dtype]
            err = _held(f"decode_attn {label} {dtype}", got, want,
                        (tol, tol))
            G = hq // hkv
            if dtype == torch.float32:     # one launch, merged in order
                _held(f"decode_attn {label} {dtype} rerun",
                      decode_attn(q, k, v, lens), got, None)
            kind = ran_on(decode_attn, route(d, G, dtype),
                          f"decode_attn {label} {dtype}")
            zero = [i for i, n in enumerate(lens_list) if n == 0]
            mean = v.float().mean(2).repeat_interleave(G, 1)
            z_err = _held(f"decode_attn {label} {dtype} length-0 rows",
                          got[zero].float(), mean[zero], (tol, tol))
            tile = group_tile(G, kind)
            print(f"[decode_attn] {str(dtype)[6:]} {label}: B={B} H={hq} "
                  f"Hkv={hkv} D={d} S={S} lengths {lens_list} on the "
                  f"{kind} route ({-(-G // tile)} tile(s) of {tile} query "
                  f"heads): max_abs_err {err:.3e}, length-0 rows against "
                  f"the mean of V {z_err:.3e} (tol {tol}) [{card}]")
            del q, k, v


# float32 decode_attn at batch 1 over a long cache (phase_decode_attn_check):
# its length, a whole row of KV head 8 x D 64 at llama3.2-1b's widths
DECODE_ATTN_LONG_S = 32768


def phase_decode_attn_check(card: str):
    """decode_attn against its plain version at the serving shapes, each
    case on the route the rule gives it (bf16 on the tensor cores, float32
    on SIMT); in bf16 the SIMT kernel is timed on the same inputs, in
    float32 (one launch merging its own splits; also every row full, and
    one row of DECODE_ATTN_LONG_S at batch 1) the same kernel at half and
    twice the split plan's rows a split.  Then the edge cases of
    _decode_attn_edge_checks."""
    import torch.nn.functional as F
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    cyc = sleep_cycles_per_ms()
    entry = None
    decode_attn.launches_by_route.update(
        dict.fromkeys(decode_attn.launches_by_route, 0))
    for dtype in (torch.bfloat16, torch.float32):
        shapes = [(B, S_MAX), (B, 1000)]
        if dtype == torch.float32:
            shapes.append((1, DECODE_ATTN_LONG_S))
        for nb, S in shapes:
            gen = torch.Generator(device="cuda").manual_seed(S)
            cases = []
            if nb == B:
                cases.append(("ragged", [1, 63, 64, 65, S, S // 2, 129,
                                         S - 1]))
            if S != 1000:
                cases.append(("full", [S] * nb))
            kv_bytes = 2 * nb * HKV * S * D * dtype.itemsize
            copies = max(2, math.ceil(2 * L2_BYTES / kv_bytes))
            bufs = [tuple(torch.randn(shape, generator=gen, device="cuda")
                          .to(dtype) for shape in
                          ((nb, H, D), (nb, HKV, S, D), (nb, HKV, S, D)))
                    for _ in range(copies)]
            for label, lens_list in cases:
                lens = torch.tensor(lens_list, dtype=torch.int32,
                                    device="cuda")
                q, k, v = bufs[0]
                got = decode_attn(q, k, v, lens)
                torch.cuda.synchronize()
                want = decode_attn_ref(q, k, v, lens)
                err = (got.float() - want.float()).abs().max().item()
                tol = KERNEL_TOL[dtype]
                ok = bool(torch.allclose(got.float(), want.float(),
                                         rtol=tol, atol=tol))
                kind = ran_on(decode_attn, dk.route(D, H // HKV, dtype),
                              f"decode_attn {dtype} B={nb} S={S} {label}")
                if dtype == torch.float32:   # one launch, merged in order
                    _held(f"decode_attn {dtype} B={nb} S={S} {label} rerun",
                          decode_attn(q, k, v, lens), got, None)
                    ran_on(decode_attn, kind, f"decode_attn {dtype} B={nb} "
                                              f"S={S} {label} rerun")
                mask = (torch.arange(S, device="cuda")[None, :]
                        < lens[:, None])[:, None, None, :]

                def library(q, k, v):
                    return F.scaled_dot_product_attention(
                        q.view(nb, H, 1, D), k, v, attn_mask=mask,
                        enable_gqa=True)

                if not ok:
                    raise AssertionError(
                        f"decode_attn disagrees with its plain version: "
                        f"{dtype} B={nb} S={S} max_abs_err {err}")
                ms, host_ms = time_ms([lambda b=b: decode_attn(*b, lens)
                                       for b in bufs], 200, cyc)
                ran_on(decode_attn, kind, f"decode_attn {dtype} B={nb} "
                                          f"S={S} {label} timed")
                plain_ms, _ = time_ms([lambda b=b: decode_attn_ref(*b, lens)
                                       for b in bufs], 20, cyc)
                library_ms, _ = time_ms([lambda b=b: library(*b)
                                         for b in bufs], 50, cyc)
                prev = ""
                if kind == "tensor_core":   # the SIMT kernel it replaced
                    _held(f"decode_attn {dtype} S={S} {label} on the SIMT "
                          f"entry", _simt_decode_attn(q, k, v, lens), want,
                          (tol, tol))
                    prev_ms, _ = time_ms([lambda b=b: _simt_decode_attn(
                        *b, lens) for b in bufs], 200, cyc)
                    prev = f", SIMT route {prev_ms:.5f} ms"
                else:   # the split plan's rows a split, halved and doubled
                    chunk = dk.plan(kind, nb, HKV, H // HKV, S, D, dtype,
                                    dk._sm_count(0))[1]
                    times = []
                    for rows in (chunk // 2, 2 * chunk):
                        _held(f"decode_attn {dtype} B={nb} S={S} {label} "
                              f"at {rows} rows a split",
                              _simt_decode_attn(q, k, v, lens, chunk=rows),
                              want, (tol, tol))
                        rows_ms, _ = time_ms(
                            [lambda b=b, r=rows: _simt_decode_attn(
                                *b, lens, chunk=r) for b in bufs], 200, cyc)
                        times.append(f"{rows} rows {rows_ms:.5f} ms")
                    prev = (f" at the plan's {chunk} rows a split ("
                            f"{', '.join(times)})")
                bound_ms, bound_by = decode_attn_bound(lens_list, dtype)
                print(f"[decode_attn] {str(dtype)[6:]} B={nb} S={S} lengths "
                      f"{label} {lens_list} on the {kind} route: "
                      f"max_abs_err {err:.3e} (tol {tol}) kernel {ms:.5f} ms "
                      f"(host {host_ms:.5f} ms per call){prev}, plain "
                      f"{plain_ms:.5f} ms, sdpa {library_ms:.5f} ms "
                      f"({ms / library_ms:.2f}x), bound {bound_ms:.5f} ms "
                      f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound "
                      f"[{card}]")
                if label == "full" and dtype == torch.bfloat16:
                    entry = dict(
                        name="decode_attn", route="cuda", kernel_route=kind,
                        source="src/repro_torch/csrc/decode_attn.cu",
                        replaces="src/repro/kernels/decode_attn/kernel.py:60",
                        shape=f"B={B} H={H} Hkv={HKV} D={D} S={S} bf16, "
                              f"every row full",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms, prev_ms=prev_ms)
            del bufs
    _decode_attn_edge_checks(card)
    _c10_decode_attn(card)
    return entry


def _wkv6_entry(kind, r, k, v, w, u, s0=None, state=None):
    """wkv6 on the ``kind`` route's C entry, whatever the rule would
    choose: at prefill and at decode the step kernel is the one the
    chunked and the decode routes replaced, run here as the redesigns'
    "before".  The new state goes to ``state`` (which may be ``s0``
    itself), else to a new tensor.  Not counted as a launch of the path.
    Returns (out, state)."""
    from repro_torch.kernels.wkv6 import kernel as wk
    nb, T, nh, d = r.shape
    out = torch.empty_like(r)
    if state is None:
        state = torch.empty((nb, nh, d, d), dtype=torch.float32,
                            device="cuda")
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            out.data_ptr(), state.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if kind in ("decode", "step"):
        err = wk._entries()[kind](*args, nb, T, nh, d, wk._DTYPES[r.dtype],
                                  stream)
    else:
        scratch, ptrs = wk._chunked_scratch(nb, T, nh, d, r.device)
        err = wk._entries()["chunked"](*args, *ptrs, nb, T, nh, d,
                                       wk.CHUNK_T, wk._DTYPES[r.dtype],
                                       stream)
    if err:
        raise RuntimeError(f"wkv6 {kind} entry failed: CUDA error {err}")
    return out, state


def phase_wkv6_check(card: str):
    """wkv6 against its plain version at rwkv6-1.6b's serving shapes, each
    case on the route the rule gives it: the decode step (B=8, T=1) from a
    nonzero state on the decode route (a second call bit-equal, and its C
    entry with the new state written over state0 equal to it), and
    batch-1 prefills from zeros on the chunked route, whole and in two
    halves with the carried state, with decays as the model draws them
    and near 0 and near 1; and the training forward's shape (WKV6_TRAIN,
    from zeros) on the chunked route.  At decode, prefill and training
    the step kernel is held and timed on the same inputs.  Then both
    routes at batch-1 prompts on either side of the threshold.  Returns
    the decode, the prefill and the training entries of the kernels line
    (the training entry with path "train")."""
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.wkv6.kernel import CHUNK_T, route
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref, wkv6_ref

    cyc = sleep_cycles_per_ms()
    entries = []
    wkv6.launches_by_route.update(dict.fromkeys(wkv6.launches_by_route, 0))
    cases = [(B, 1, True, "mid")] + [(1, T, False, "mid")
                                     for T in WKV6_PREFILL_T]
    cases += [(1, WKV6_PREFILL_T[0], False, d) for d in ("near0", "near1")]
    cases += [(*WKV6_TRAIN, False, "mid")]
    for dtype in (torch.bfloat16, torch.float32):
        for nb, T, with_state0, decays in cases:
            gen = torch.Generator(device="cuda").manual_seed(T + nb)
            shape = (nb, T, H, D)
            lo, hi = WKV6_DECAYS[decays]

            def make():
                r, k = (0.5 * torch.randn(shape, generator=gen,
                                          device="cuda") for _ in range(2))
                v = torch.randn(shape, generator=gen, device="cuda")
                w = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                device="cuda")
                u = 0.3 * torch.randn((H, D), generator=gen, device="cuda")
                s0 = torch.randn((nb, H, D, D), generator=gen,
                                 device="cuda") if with_state0 else None
                return tuple(a.to(dtype) for a in (r, k, v, w)) + (u, s0)

            nbytes = 5 * nb * T * H * D * dtype.itemsize + \
                8 * nb * H * D * D
            bufs = [make() for _ in range(_copies(nbytes))]
            want_kind = route(nb, T, H, D)
            got = wkv6(*bufs[0])
            torch.cuda.synchronize()
            train = (nb, T) == WKV6_TRAIN
            what = "decode" if T == 1 else \
                "training forward" if train else "prefill"
            label = f"{what}, decays {lo}-{hi}"
            kind = ran_on(wkv6, want_kind, f"wkv6 {dtype} B={nb} T={T} "
                                           f"{decays}")
            # Near 1 the plain version's own float32 rounding reaches the
            # tolerance at T 1024: hold against it in float64 there.
            wide = torch.float64 if decays == "near1" else torch.float32
            want = wkv6_ref(*(a if a is None else a.to(wide)
                              for a in bufs[0]))
            want = (want[0].to(dtype), want[1].float())
            rtol, atol = WKV6_TOL[dtype]
            err = _held(f"wkv6 {dtype} B={nb} T={T} {decays} output",
                        got[0], want[0], (rtol, atol))
            s_err = _held(f"wkv6 {dtype} B={nb} T={T} {decays} state",
                          got[1], want[1], (WKV6_STATE_TOL,) * 2)
            label += f", plain in {str(wide)[6:]}"
            if kind == "decode":   # a rerun, and the state written in place
                again = wkv6(*bufs[0])
                in_place = bufs[0][5].clone()
                alias = _wkv6_entry("decode", *bufs[0][:5], in_place,
                                    in_place)
                torch.cuda.synchronize()
                ran_on(wkv6, kind, f"wkv6 {dtype} decode rerun")
                _held(f"wkv6 {dtype} decode rerun", again[0], got[0], None)
                _held(f"wkv6 {dtype} decode rerun state", again[1], got[1],
                      None)
                _held(f"wkv6 {dtype} decode, state_out = state0",
                      alias[0], got[0], None)
                _held(f"wkv6 {dtype} decode, state_out = state0 (state)",
                      in_place, got[1], None)
                label += ", a rerun and the state written over state0 " \
                    "bit-equal"
            if T > 1 and decays == "mid":  # two halves, the carried state
                r, k, v, w, u, _ = bufs[0]
                half = T // 2
                h1, s1 = wkv6(*(a[:, :half].contiguous()
                                for a in (r, k, v, w)), u)
                h2, s2 = wkv6(*(a[:, half:].contiguous()
                                for a in (r, k, v, w)), u, s1)
                torch.cuda.synchronize()
                ran_on(wkv6, route(nb, half, H, D), f"wkv6 {dtype} halves")
                c_err = max(_held(f"wkv6 {dtype} T={T} halves",
                                  torch.cat([h1, h2], 1), got[0],
                                  (rtol, atol)),
                            _held(f"wkv6 {dtype} T={T} halves state", s2,
                                  got[1], (WKV6_STATE_TOL,) * 2))
                label += f", halves with the carried state differ by " \
                    f"{c_err:.3e}"
                if dtype == torch.float32:   # the chunked form on the CPU
                    ch = wkv6_chunked_ref(*bufs[0][:5], ct=CHUNK_T)
                    label += ", plain chunked form differs by " \
                        f"{(ch[0] - got[0]).abs().max().item():.3e}"
            ms, host_ms = time_ms([lambda b=b: wkv6(*b) for b in bufs],
                                  200 if T == 1 else 20, cyc)
            ran_on(wkv6, kind, f"wkv6 {dtype} B={nb} T={T} timed")
            timing = f"kernel {ms:.5f} ms (host {host_ms:.5f} ms per call)"
            prev_ms = None
            # The step kernel on the same inputs, where the model's decays
            # are drawn.  Near 1 its float32 sum of a thousand steps is as
            # far from the exact value as the plain version's (1.5e-4 of
            # outputs near 200); the near cases check the chunked route.
            if kind in ("chunked", "decode") and decays == "mid":
                _held(f"wkv6 {dtype} T={T} {decays} on the step entry",
                      _wkv6_entry("step", *bufs[0])[0], want[0],
                      (rtol, atol))
                prev_ms, _ = time_ms([lambda b=b: _wkv6_entry("step", *b)
                                      for b in bufs], 200 if T == 1 else 20,
                                     cyc)
                timing += f", step route {prev_ms:.5f} ms " \
                    f"({prev_ms / ms:.2f}x the kernel)"
            plain_ms = None
            if decays == "mid":
                plain_ms, _ = time_ms([lambda b=b: wkv6_ref(*b)
                                       for b in bufs], 20 if T == 1 else 2,
                                      cyc)
                timing += f", plain {plain_ms:.5f} ms"
            if kind in ("chunked", "decode") and decays == "mid":
                timing += f"; by kernel {_device_ms_by_kernel(wkv6, bufs)}"
                ran_on(wkv6, kind, f"wkv6 {dtype} B={nb} T={T} profiled")
            bound_ms, bound_by = wkv6_bound(nb, T, H, D, dtype, with_state0)
            print(f"[wkv6] {str(dtype)[6:]} B={nb} T={T} H={H} D={D} "
                  f"({label}) on the {kind} route: max_abs_err {err:.3e} "
                  f"(tol rtol {rtol:.2e} atol {atol:.0e}), state "
                  f"{s_err:.3e} (tol {WKV6_STATE_TOL}); {timing}, bound "
                  f"{bound_ms:.5f} ms ({bound_by}), "
                  f"{100 * bound_ms / ms:.1f}% of bound [{card}]")
            if dtype == torch.bfloat16 and decays == "mid" and \
                    (T in (1, WKV6_PREFILL_T[0]) or train):
                entry = dict(
                    name="wkv6", route="cuda", kernel_route=kind,
                    source="src/repro_torch/csrc/wkv6.cu",
                    replaces="src/repro/kernels/wkv6/kernel.py:53",
                    shape=f"B={nb} T={T} H={H} D={D} bf16, " +
                    ("decode step" if T == 1 else "training forward, "
                     "zero state" if train else "batch-1 prefill"),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
                if train:
                    entry["path"] = "train"
                if prev_ms is not None:
                    entry["prev_ms"] = prev_ms
                entries.append(entry)
            del bufs

    # Both routes on the same inputs on either side of the threshold
    gen = torch.Generator(device="cuda").manual_seed(5)
    for T in WKV6_CROSSOVER_T:
        shape = (1, T, H, D)
        bufs = []
        for _ in range(4):
            r, k = (0.5 * torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
            v = torch.randn(shape, generator=gen, device="cuda")
            w = 0.9 + 0.099 * torch.rand(shape, generator=gen, device="cuda")
            u = 0.3 * torch.randn((H, D), generator=gen, device="cuda")
            bufs.append(tuple(a.to(torch.bfloat16) for a in (r, k, v, w))
                        + (u,))
        want = wkv6_ref(*bufs[0])
        times = {}
        for name in ("step", "chunked"):
            _held(f"wkv6 B=1 T={T} on the {name} entry",
                  _wkv6_entry(name, *bufs[0])[0], want[0],
                  WKV6_TOL[torch.bfloat16])
            times[name] = time_ms([lambda b=b, name=name: _wkv6_entry(
                name, *b) for b in bufs], 20, cyc)[0]
        print(f"[wkv6] bf16 B=1 T={T}: the rule gives the "
              f"{route(1, T, H, D)} route; step {times['step']:.5f} ms, "
              f"chunked {times['chunked']:.5f} ms [{card}]")
    _c10_wkv6(card)
    entries.append(_wkv6_backward_check(card))
    return entries


def _wkv6_autograd(args, wide):
    """Gradients of (r, k, v, w, u, state0) by autograd through wkv6_ref
    on ``args`` = (r, k, v, w, u, state0, g_out, g_state): in the inputs'
    own dtypes when ``wide`` is None (the plain backward: float32 steps,
    each gradient rounded once to its dtype), else widened to ``wide``.
    state0's gradient is None where state0 is."""
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    def cast(a):
        return a if wide is None else a.to(wide)

    ins = [None if a is None else cast(a).detach().requires_grad_()
           for a in args[:6]]
    wanted = [a for a in ins if a is not None]
    with torch.enable_grad():
        out, st = wkv6_ref(*ins)
        pairs = [(out, args[6])] + ([(st, args[7])]
                                    if args[7] is not None else [])
        grads = torch.autograd.grad([o for o, _ in pairs], wanted,
                                    [cast(g) for _, g in pairs],
                                    allow_unused=True)
    return [torch.zeros_like(a) if g is None else g
            for g, a in zip(grads, wanted)] + \
        ([None] if args[5] is None else [])


def _wkv6_grads_held(label: str, got, args) -> dict:
    """The kernel's gradients ``got`` of ``args`` (as _wkv6_autograd
    takes them) against float64 autograd through wkv6_ref on the same
    inputs: each within the larger of WKV6_GRAD_REL of its largest |g|
    and the plain backward's own error against float64, in the dtype
    autograd gives.  Returns the worst errors over the tensors: the
    kernel's and the plain backward's, each over its tensor's max|g|
    ("err", "plain"), and the kernel's largest absolute one ("abs")."""
    exact = _wkv6_autograd(args, torch.float64)
    plain = _wkv6_autograd(args, None)
    worst = {"err": 0.0, "plain": 0.0, "abs": 0.0}
    for name, g, e, p in zip(("r", "k", "v", "w", "u", "state0"), got,
                             exact, plain):
        if e is None:
            continue
        if g.dtype != p.dtype:
            raise AssertionError(f"{label}: d{name} in {g.dtype}, autograd "
                                 f"through wkv6_ref gives {p.dtype}")
        scale = e.abs().max().item()
        err = (g.double() - e).abs().max().item()
        p_err = (p.double() - e).abs().max().item()
        if err > max(WKV6_GRAD_REL * scale, p_err):
            raise AssertionError(
                f"{label}: d{name} differs from float64 autograd by {err}, "
                f"over the larger of {WKV6_GRAD_REL} x max|g| {scale} and "
                f"the plain backward's {p_err}")
        if scale:
            worst["err"] = max(worst["err"], err / scale)
            worst["plain"] = max(worst["plain"], p_err / scale)
        worst["abs"] = max(worst["abs"], err)
    return worst


def _wkv6_backward_check(card: str) -> dict:
    """The backward kernels (wkv6_backward on CUDA tensors) held to
    float64 autograd through wkv6_ref (_wkv6_grads_held) on the route the
    shape gives them (kernel.backward_route): at the training shape
    WKV6_TRAIN from zeros with no state gradient, as training calls it,
    in bf16 and float32 at each of WKV6_DECAYS (parallel); at
    WKV6_BWD_STATE (parallel) and WKV6_BWD_SHORT (the first kernel's step
    route: D 80) from a nonzero state with a state gradient.  Each case's
    second call must equal its first bit for bit.  At the training shape
    with the model's decays ("mid") the kernels are timed beside the
    kernel the parallel route replaced (the first kernel's chunked route,
    its C entry called directly: not a launch of the path), held the same
    way on the same inputs, and beside the plain backward (autograd
    through wkv6_ref), and the call's device time is split by pass.
    Returns the kernels line's entry (bf16 training, path "train")."""
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.wkv6.kernel import (CHUNK_T, backward_route,
                                                 wkv6_backward_cuda)
    from repro_torch.kernels.wkv6.ops import wkv6_backward

    cyc = sleep_cycles_per_ms()
    entry = None
    _zero_counts(wkv6_backward)
    cases = [(*WKV6_TRAIN, H, D, False, decays) for decays in WKV6_DECAYS]
    cases += [(*WKV6_BWD_STATE, True, "mid"), (*WKV6_BWD_SHORT, True, "mid")]
    if backward_route(*WKV6_TRAIN, H, D) != WKV6_BWD_TRAIN_ROUTE:
        raise AssertionError(f"the training shape's backward route is "
                             f"{backward_route(*WKV6_TRAIN, H, D)}, not "
                             f"{WKV6_BWD_TRAIN_ROUTE}")
    for dtype in (torch.bfloat16, torch.float32):
        for nb, T, nh, d, with_state, decays in cases:
            gen = torch.Generator(device="cuda").manual_seed(7 * T + d)
            lo, hi = WKV6_DECAYS[decays]
            shape = (nb, T, nh, d)

            def make():
                r, k = (0.5 * torch.randn(shape, generator=gen,
                                          device="cuda") for _ in range(2))
                v, go = (torch.randn(shape, generator=gen, device="cuda")
                         for _ in range(2))
                w = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                device="cuda")
                u = 0.3 * torch.randn((nh, d), generator=gen, device="cuda")
                s0, gs = (torch.randn((nb, nh, d, d), generator=gen,
                                      device="cuda") if with_state else None
                          for _ in range(2))
                return (*(a.to(dtype) for a in (r, k, v, w)), u, s0,
                        go.to(dtype), gs)

            train = (nb, T) == WKV6_TRAIN
            timed = train and decays == "mid"
            nbytes = 9 * nb * T * nh * d * dtype.itemsize
            bufs = [make() for _ in range(_copies(nbytes) if timed else 1)]
            want_kind = backward_route(nb, T, nh, d)
            label = f"wkv6 backward {str(dtype)[6:]} B={nb} T={T} H={nh} " \
                f"D={d} {decays}"
            got = wkv6_backward(*bufs[0])
            again = wkv6_backward(*bufs[0])
            torch.cuda.synchronize()
            kind = ran_on(wkv6_backward, want_kind, label)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{label}: two calls differ")
            held = _wkv6_grads_held(label, got, bufs[0])
            timing = ""
            if timed:
                ms, host_ms = time_ms([lambda b=b: wkv6_backward(*b)
                                       for b in bufs], 20, cyc)
                split = _wkv6_backward_split(wkv6_backward, bufs)
                ran_on(wkv6_backward, kind, f"{label} timed")
                before = "chunked" if T > CHUNK_T else "step"

                def first(*b):
                    return wkv6_backward_cuda(*b, kind=before)[:6]

                b_held = _wkv6_grads_held(f"{label} on the first kernel's "
                                          f"{before} route",
                                          first(*bufs[0]), bufs[0])
                prev_ms, _ = time_ms([lambda b=b: first(*b) for b in bufs],
                                     20, cyc)
                b_split = _wkv6_backward_split(first, bufs)
                plain_ms, _ = time_ms([lambda b=b: _wkv6_autograd(b, None)
                                       for b in bufs], 2, cyc)
                bound_ms, bound_by = wkv6_backward_bound(
                    nb, T, nh, d, dtype, with_state, with_state)
                timing = f"; kernels {ms:.5f} ms (host {host_ms:.5f} ms " \
                    f"per call; by pass {split}), the first kernel's " \
                    f"{before} route on the same inputs (before) " \
                    f"{prev_ms:.5f} ms ({prev_ms / ms:.2f}x; by pass " \
                    f"{b_split}; worst |err| / max|g| " \
                    f"{b_held['err']:.3e}), plain {plain_ms:.5f} ms, " \
                    f"bound {bound_ms:.5f} ms ({bound_by}), " \
                    f"{100 * bound_ms / ms:.1f}% of bound"
                if dtype == torch.bfloat16:
                    entry = dict(
                        name="wkv6_backward", route="cuda",
                        kernel_route=kind, path="train",
                        source="src/repro_torch/csrc/wkv6_backward.cu",
                        replaces="src/repro/kernels/wkv6/kernel.py:53",
                        shape=f"B={nb} T={T} H={nh} D={d} bf16, training "
                        "backward, zero state, no state gradient",
                        max_abs_err=held["abs"], ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, prev_ms=prev_ms)
            print(f"[wkv6] {label} (decays {lo}-{hi}"
                  f"{', state0 and g_state given' if with_state else ''}) "
                  f"on the {kind} route, against float64 autograd through "
                  f"wkv6_ref: worst |err| / max|g| {held['err']:.3e} (the "
                  f"plain backward's {held['plain']:.3e}; tol the larger "
                  f"of {WKV6_GRAD_REL} and the plain's), max_abs_err "
                  f"{held['abs']:.3e}; two calls equal bit for bit"
                  f"{timing} [{card}]")
            del bufs
    return entry


def _wkv6_backward_split(fn, bufs, calls: int = 10) -> str:
    """Device ms per call of ``fn`` over ``bufs`` (a wkv6 backward) by
    pass: the state's chunk pass (the forward's local and scan kernels),
    the gradient's chunk pass (its local and scan kernels), the chunk
    kernel (the first kernel's row and column kernel on its routes), and
    du's sum; any other kernel under its own name; from torch.profiler."""
    parts = {"S chunk pass": ("wkv6_local_kernel", "wkv6_scan_kernel"),
             "G chunk pass": ("wkv6_backward_glocal_kernel",
                              "wkv6_backward_gscan_kernel"),
             "chunk kernel": ("wkv6_backward_chunk_kernel",
                              "wkv6_backward_kernel",
                              "wkv6_backward_any_kernel"),
             "du": ("wkv6_backward_du_kernel",)}
    ms = _device_ms_by_name(fn, bufs, calls)
    named = {n for names in parts.values() for n in names}
    parts.update({n: (n,) for n in ms if n not in named})
    return ", ".join(f"{part} {sum(ms.get(n, 0.0) for n in names):.5f} ms"
                     for part, names in parts.items()
                     if any(n in ms for n in names))


def _device_ms_by_name(fn, bufs, calls: int = 10) -> dict:
    """Device ms per call of each kernel, by name, that ``calls`` calls of
    ``fn`` over ``bufs`` launch, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*bufs[i % len(bufs)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        name = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
        if us > 0:
            key = name.group(1) if name else e.key[:40]
            out[key] = out.get(key, 0.0) + us / 1e3 / calls
    return out


def _device_ms_by_kernel(fn, bufs, calls: int = 10) -> str:
    """Device ms per call of each kernel that ``calls`` calls of ``fn``
    over ``bufs`` launch, from torch.profiler."""
    return ", ".join(f"{name} {ms:.5f} ms" for name, ms in
                     _device_ms_by_name(fn, bufs, calls).items())


def _copies(nbytes: int) -> int:
    """Buffers to cycle through so that L2 holds none of them."""
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


def _held(label: str, got, want, tol) -> float:
    """Max |got - want|; raises unless within (rtol, atol) ``tol``, or
    equal bit for bit when ``tol`` is None."""
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.equal(got, want) if tol is None else bool(torch.allclose(
        got.float(), want.float(), rtol=tol[0], atol=tol[1]))
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"max_abs_err {err}" + (" (must be bit-equal)"
                                                     if tol is None else ""))
    return err


def _tf32x3_error(label: str, got, library, want64):
    """(max |got - want64|, max |library - want64|): a tf32x3 route's error
    against a float64 result beside the library call's own float32 error
    (TF32 off) on the same inputs; raises past TF32X3_ERR_FACTOR times
    it."""
    e64 = (got.double() - want64).abs().max().item()
    lib64 = (library.double() - want64).abs().max().item()
    if e64 > TF32X3_ERR_FACTOR * lib64:
        raise AssertionError(f"{label} float32: max error against float64 "
                             f"{e64} is over {TF32X3_ERR_FACTOR}x the "
                             f"library's {lib64}")
    return e64, lib64


def _simt_gemm(a, b):
    """a @ b on the SIMT route's C entry, whatever the rule would choose:
    the kernel the tensor-core routes (bf16 and tf32x3) replaced, run here
    as the redesigns' "before".  Output in a's dtype, no bias, 2-D
    grid."""
    from repro_torch.kernels.gemm_os.kernel import _DTYPES, _entries
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    code = _DTYPES[a.dtype]
    err = _entries()[0](a.data_ptr(), b.data_ptr(), None, out.data_ptr(), M,
                        N, K, code, code, 0, 0,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"SIMT gemm_os launch failed: CUDA error {err}")
    return out


def _simt_conv(x, w):
    """As _simt_gemm, for conv2d_os's SIMT route."""
    from repro_torch.kernels.conv2d_os.kernel import conv2d_os_cuda
    return conv2d_os_cuda(x, w, kind="simt")[0]


def _tf32x3_conv(x, w):
    """As _simt_conv, for the tf32x3 route (float32)."""
    from repro_torch.kernels.conv2d_os.kernel import conv2d_os_cuda
    return conv2d_os_cuda(x, w, kind="tf32x3")[0]


def _simt_qgemm(a, b, sa, sb):
    """As _simt_gemm, for qgemm_int8's SIMT route (the dp4a kernel), float32
    output."""
    from repro_torch.kernels.qgemm_int8.kernel import _entries
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = _entries()[0](a.data_ptr(), b.data_ptr(), sa.data_ptr(),
                        sb.data_ptr(), out.data_ptr(), M, N, K, 0,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"SIMT qgemm_int8 launch failed: CUDA error {err}")
    return out


# The layouts of torch._int_mm's b, (K, N) int8, that the yardstick tries.
INT_MM_LAYOUTS = {"row-major (K, N)": lambda b: b,
                  "column-major (K, N)": lambda b: b.t().contiguous().t()}


# ---- shapes the fast kernels are not built for (ROADMAP C10): each on
# its route, held against its plain version with the tolerances above,
# its route and ms printed.  These launches are checks, not a main path.
C10_ATTN_D = (80, 96, 256)
C10_WKV6_D = (80, 256)
C10_WKV6_T = {"step": 16, "chunked": 256}
C10_QGEMM = (8, 140000, 16)
C10_CONV = (("N 65536 (grid.z slices)", (65536, 4, 4, 8), (3, 3, 8, 16)),
            ("taps past shared memory", (2, 40, 40, 13), (12, 12, 13, 32)))
# conv2d_os float32 by shape: the tf32x3 and SIMT entries on the same
# inputs, 3 x 3 taps, about 2^18 output pixels a case.  (Cin, Cout, square
# output side): C10's channels (8 -> 16) and Table-I's (64 -> 64) from 2 x
# 2 outputs (C10's) to whole 16 x 16 tiles and past them, then Cin and
# Cout across a tile's chunk at 64 x 64 outputs: where the conv route's
# MIN_TF32_CIN comes from
CONV_FILL = tuple(dict.fromkeys(
    [(ci, co, o) for ci, co in ((8, 16), (64, 64)) for o in (2, 8, 17, 64)]
    + [(ci, co, 64) for co in (16, 64)
       for ci in (4, 8, 12, 16, 20, 24, 28, 32, 48)]))


def _c10_decode_attn(card: str) -> None:
    """decode_attn at head_dims outside the vector kernels' set, float32
    and bf16, G 1 and 4, a row of length 0, S 600: the SIMT route's any-D
    kernel."""
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.decode_attn.kernel import route
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    cyc = sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(80)
    nb, hkv, S = 4, 2, 600
    lens = torch.tensor([0, 1, 333, S], dtype=torch.int32, device="cuda")
    _zero_counts(decode_attn)
    for d in C10_ATTN_D:
        for dtype in (torch.float32, torch.bfloat16):
            for g in (1, 4):
                q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                           .to(dtype) for shape in
                           ((nb, hkv * g, d), (nb, hkv, S, d),
                            (nb, hkv, S, d)))
                tol = KERNEL_TOL[dtype]
                err = _held(f"decode_attn D={d} G={g} {dtype}",
                            decode_attn(q, k, v, lens),
                            decode_attn_ref(q, k, v, lens), (tol, tol))
                ms, _ = time_ms([lambda: decode_attn(q, k, v, lens)], 20,
                                cyc)
                kind = ran_on(decode_attn, route(d, g, dtype),
                              f"decode_attn D={d} G={g}")
                print(f"[c10] decode_attn D={d} G={g} {str(dtype)[6:]} "
                      f"B={nb} Hkv={hkv} S={S} lengths {lens.tolist()} on "
                      f"the {kind} route (any-D kernel): max_abs_err "
                      f"{err:.3e} (tol {tol}), {ms:.5f} ms [{card}]")


def _c10_wkv6(card: str) -> None:
    """wkv6 at head sizes outside the fast kernels' set on both routes,
    from a nonzero state0, float32 and bf16."""
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.wkv6.kernel import route
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    cyc = sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(81)
    nb, nh = 2, 4
    _zero_counts(wkv6)
    for d in C10_WKV6_D:
        for want_route, T in C10_WKV6_T.items():
            for dtype in (torch.float32, torch.bfloat16):
                shape = (nb, T, nh, d)
                r, k = (0.5 * torch.randn(shape, generator=gen,
                                          device="cuda") for _ in range(2))
                v = torch.randn(shape, generator=gen, device="cuda")
                w = 0.9 + 0.099 * torch.rand(shape, generator=gen,
                                             device="cuda")
                r, k, v, w = (a.to(dtype) for a in (r, k, v, w))
                u = 0.3 * torch.randn((nh, d), generator=gen, device="cuda")
                s0 = torch.randn((nb, nh, d, d), generator=gen,
                                 device="cuda")
                got = wkv6(r, k, v, w, u, s0)
                want = wkv6_ref(r, k, v, w, u, s0)
                err = _held(f"wkv6 D={d} T={T} {dtype}", got[0], want[0],
                            WKV6_TOL[dtype])
                _held(f"wkv6 D={d} T={T} {dtype} state", got[1], want[1],
                      (WKV6_STATE_TOL, WKV6_STATE_TOL))
                ms, _ = time_ms([lambda: wkv6(r, k, v, w, u, s0)], 10, cyc)
                kind = ran_on(wkv6, route(nb, T, nh, d),
                              f"wkv6 D={d} T={T}")
                if kind != want_route:
                    raise AssertionError(f"wkv6 T={T} ran on {kind}")
                print(f"[c10] wkv6 D={d} B={nb} T={T} H={nh} "
                      f"{str(dtype)[6:]} on the {kind} route (any-D "
                      f"kernel): max_abs_err {err:.3e}, {ms:.5f} ms "
                      f"[{card}]")


def _c10_table1(card: str) -> None:
    """qgemm_int8 past K_MAX (the SIMT route's wrapping instantiation): all
    -128 must give K * 16384 wrapped to int32 times the scales, and random
    int8 inputs the plain version's words; conv2d_os over 65536 images
    (launched in grid.z slices) and with taps whose SIMT block would not
    fit in shared memory (the streaming route), float32 and bf16."""
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.conv2d_os.kernel import route as conv_route
    from repro_torch.kernels.conv2d_os.ops import conv2d_os
    from repro_torch.kernels.conv2d_os.ref import conv2d_ref
    from repro_torch.kernels.qgemm_int8.kernel import route as qgemm_route
    from repro_torch.kernels.qgemm_int8.ops import qgemm_int8
    from repro_torch.kernels.qgemm_int8.ref import qgemm_ref

    cyc = sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(82)
    m, kk, n = C10_QGEMM
    sa = torch.linspace(0.5, 2.0, m, device="cuda")
    sb = torch.linspace(0.25, 1.0, n, device="cuda")
    _zero_counts(qgemm_int8, conv2d_os)
    for label in ("all -128", "random"):
        if label == "random":
            a = torch.randint(-128, 128, (m, kk), generator=gen,
                              device="cuda", dtype=torch.int8)
            b = torch.randint(-128, 128, (kk, n), generator=gen,
                              device="cuda", dtype=torch.int8)
        else:
            a = torch.full((m, kk), -128, dtype=torch.int8, device="cuda")
            b = torch.full((kk, n), -128, dtype=torch.int8, device="cuda")
        got = qgemm_int8(a, b, sa, sb)
        _held(f"qgemm_int8 K={kk} {label}", got, qgemm_ref(a, b, sa, sb),
              None)
        if label == "all -128":
            _held(f"qgemm_int8 K={kk} {label} against -2001207296 * scales",
                  got, (torch.full((m, n), -2001207296.0, device="cuda")
                        * sa[:, None]) * sb[None, :], None)
        ms, _ = time_ms([lambda: qgemm_int8(a, b, sa, sb)], 20, cyc)
        kind = ran_on(qgemm_int8, qgemm_route(m, kk, n),
                      f"qgemm_int8 K={kk}")
        print(f"[c10] qgemm_int8 M={m} K={kk} N={n} {label} on the {kind} "
              f"route (K in wrapping int32 chunks): bit-equal to the plain "
              f"version, {ms:.5f} ms [{card}]")
    for label, xs, ws in C10_CONV:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(ws, generator=gen, device="cuda")
                 / math.sqrt(ws[0] * ws[1] * ws[2])).to(dtype)
            err = _held(f"conv2d_os {label} {dtype}", conv2d_os(x, w),
                        conv2d_ref(x, w), TABLE1_TOL[dtype])
            ms, _ = time_ms([lambda: conv2d_os(x, w)], 5, cyc)
            kind = ran_on(conv2d_os, conv_route(xs[3], ws[3], ws[0], ws[1],
                                                dtype).kind,
                          f"conv2d_os {label}")
            other = ""
            if dtype == torch.float32 and kind in ("simt", "tf32x3"):
                # the float32 route the rule passed over, same inputs
                alt = _tf32x3_conv if kind == "simt" else _simt_conv
                _held(f"conv2d_os {label} on the other route", alt(x, w),
                      conv2d_ref(x, w), TABLE1_TOL[dtype])
                alt_ms, _ = time_ms([lambda: alt(x, w)], 5, cyc)
                other = (f", the {'tf32x3' if kind == 'simt' else 'simt'} "
                         f"entry {alt_ms:.5f} ms")
            print(f"[c10] conv2d_os {label}: x {xs} w {ws} "
                  f"{str(dtype)[6:]} on the {kind} route: max_abs_err "
                  f"{err:.3e}, {ms:.5f} ms{other} [{card}]")
    _conv_fill_sweep(card)


def _conv_fill_sweep(card: str) -> None:
    """conv2d_os float32 at CONV_FILL: the tf32x3 and SIMT entries, each
    held to the plain version, timed on the same inputs beside the route
    that route() picks."""
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.conv2d_os.kernel import route as conv_route
    from repro_torch.kernels.conv2d_os.ref import conv2d_ref

    cyc = sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(83)
    for cin, cout, o in CONV_FILL:
        nb = max(1, 2 ** 18 // (o * o))
        x = torch.randn((nb, o + 2, o + 2, cin), generator=gen,
                        device="cuda")
        w = torch.randn((3, 3, cin, cout), generator=gen,
                        device="cuda") / math.sqrt(9 * cin)
        want = conv2d_ref(x, w)
        ms = {}
        for kind, fn in (("tf32x3", _tf32x3_conv), ("simt", _simt_conv)):
            _held(f"conv2d_os {kind} {o}x{o} out", fn(x, w), want,
                  TABLE1_TOL[torch.float32])
            ms[kind], _ = time_ms([lambda fn=fn: fn(x, w)], 10, cyc)
        picked = conv_route(cin, cout, 3, 3, torch.float32).kind
        print(f"[conv fill] float32 N={nb} out {o}x{o} Cin={cin} "
              f"Cout={cout} 3x3: tf32x3 {ms['tf32x3']:.5f} ms, simt "
              f"{ms['simt']:.5f} ms ({ms['simt'] / ms['tf32x3']:.2f}x), "
              f"route() picks {picked} [{card}]")
        del x, w, want


# Rows a split of the float32 vector kernel, timed on the kernel path's
# float32 decode_attn row (the plan's: one trip of 64)
DECODE_ATTN_F32_CHUNKS = (32, 64, 128, 192, 256, 512)


def _decode_attn_one_launch(name: str, kernel, args, cyc: float,
                            card: str) -> None:
    """A float32 decode_attn call at a head_dim in HEAD_DIMS is one kernel
    (the SIMT vector kernel merging its own splits): the device's kernels
    of ten calls by name, one name; a rerun bit-equal.  Then the SIMT
    entry on the same inputs at DECODE_ATTN_F32_CHUNKS rows a split, each
    held to the plain version and timed (the split plan's choice)."""
    from repro_torch.bench import time_ms
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    by_name = _device_ms_by_name(kernel, [args])
    if len(by_name) != 1 or "decode_split_kernel" not in by_name:
        raise AssertionError(f"{name}: a float32 call launched {by_name}, "
                             f"not one decode_split_kernel")
    _held(f"{name} rerun", kernel(*args), kernel(*args), None)
    want = decode_attn_ref(*args)
    tol = KERNEL_TOL[torch.float32]
    times = []
    for chunk in DECODE_ATTN_F32_CHUNKS:
        _held(f"{name} at {chunk} rows a split",
              _simt_decode_attn(*args, chunk=chunk), want, (tol, tol))
        ms, _ = time_ms([lambda c=chunk: _simt_decode_attn(*args, chunk=c)],
                        200, cyc)
        times.append(f"{chunk} rows {ms:.5f} ms")
    print(f"[bench] {name}: one kernel a call "
          f"({_device_ms_by_kernel(kernel, [args])}), a rerun bit-equal; "
          f"the SIMT entry by rows a split: {', '.join(times)} [{card}]")


def _path_f32_row(name: str, op: str, args, route: str, cyc: float,
                  card: str) -> dict:
    """A float32 row of the kernel path, timed on its own inputs: its
    kernel (gemm_os_256_torch on tf32x3, beside the SIMT kernel it
    replaced; decode_attn_torch on SIMT), the plain version and the
    library call (torch.matmul, TF32 off; scaled_dot_product_attention),
    with the kernel's bound.  Returns the entry's path_f32_* fields."""
    import torch.nn.functional as F
    from repro_torch.bench import OPS, time_ms
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    from repro_torch.kernels.gemm_os.ref import gemm_ref

    kernel = OPS[op]
    ms, _ = time_ms([lambda: kernel(*args)], 200, cyc)
    prev_ms = None
    if op == "gemm_os":
        a, b = args
        (m, k), n = a.shape, b.shape[1]
        nbytes, flops = 4 * (m * k + k * n + m * n), 2 * m * n * k
        plain_ms, _ = time_ms([lambda: gemm_ref(a, b)], 200, cyc)
        library_ms, _ = time_ms([lambda: torch.matmul(a, b)], 200, cyc)
        prev_ms, _ = time_ms([lambda: _simt_gemm(a, b)], 200, cyc)
        bound_ms, bound_by, design_ms = tf32x3_bound(nbytes, flops)
        library = "torch.matmul"
    else:
        q, k, v, lens = args
        nb, hq, d = q.shape
        hkv, S = k.shape[1], k.shape[2]
        mask = (torch.arange(S, device=q.device)[None, :]
                < lens[:, None])[:, None, None, :]
        tokens = int(lens.sum().item())
        nbytes = 4 * (2 * hkv * tokens * d + 2 * nb * hq * d) + 4 * nb
        flops = 4 * hq * tokens * d
        plain_ms, _ = time_ms([lambda: decode_attn_ref(*args)], 200, cyc)
        library_ms, _ = time_ms([lambda: F.scaled_dot_product_attention(
            q.view(nb, hq, 1, d), k, v, attn_mask=mask, enable_gqa=True)],
            200, cyc)
        bound_ms, bound_by = roofline(nbytes, flops,
                                      PEAK_FLOPS[torch.float32])
        design_ms = None
        library = "scaled_dot_product_attention"
        _decode_attn_one_launch(name, kernel, args, cyc, card)
    before = "" if prev_ms is None else \
        f", SIMT route {prev_ms:.5f} ms ({prev_ms / ms:.2f}x the kernel)"
    bounds = (f"bound {bound_ms:.6f} ms ({bound_by})" if design_ms is None
              else _tf32x3_bounds_text(ms, bound_ms, bound_by, design_ms))
    print(f"[bench] {name} timed on its inputs: {op} on the {route} route "
          f"{ms:.5f} ms{before}, plain {plain_ms:.5f} ms, {library} "
          f"{library_ms:.5f} ms ({ms / library_ms:.2f}x), {bounds} "
          f"[{card}]")
    return dict(path_f32_row=name, path_f32_kernel_route=route,
                path_f32_ms=ms, path_f32_plain_ms=plain_ms,
                path_f32_library_ms=library_ms, path_f32_prev_ms=prev_ms,
                path_f32_bound_ms=bound_ms, path_f32_bound_by=bound_by,
                path_f32_design_ms=design_ms)


def phase_table1_kernels(card: str, prior: list):
    """gemm_os, conv2d_os and qgemm_int8 against their plain versions at
    full size, timed beside their bounds and the closest PyTorch call;
    then the kernel path's entry point, bench_kernel_micro: every row's
    own inputs held against the plain versions, the float32 rows' kernels
    timed on them (path_f32_* fields of the gemm_os entry and of
    ``prior``'s decode_attn entry), and each kernel's launches held to the
    calls its rows made.  Returns (entries of the kernels line, launches
    on the kernel path)."""
    import torch.nn.functional as F
    from repro_torch.bench import (OPS, SHAPES, bench_kernel_micro,
                                   micro_cases, sleep_cycles_per_ms,
                                   time_ms)
    from repro_torch.kernels.conv2d_os.kernel import route as conv_route
    from repro_torch.kernels.conv2d_os.ops import conv2d_os
    from repro_torch.kernels.conv2d_os.ref import conv2d_ref
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    from repro_torch.kernels.gemm_os.kernel import route as gemm_route
    from repro_torch.kernels.gemm_os.ops import gemm_os
    from repro_torch.kernels.gemm_os.ref import gemm_ref
    from repro_torch.kernels.decode_attn.kernel import route as attn_route
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.qgemm_int8.kernel import route as qgemm_route
    from repro_torch.kernels.qgemm_int8.ops import qgemm_int8
    from repro_torch.kernels.qgemm_int8.ref import (int_matmul_ref,
                                                    qgemm_ref,
                                                    quantize_rowwise)

    cyc = sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(13)

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)

    entries = []
    M, K, N = SHAPES["gemm"]

    # gemm_os at the ffn_in site; the bf16 prefill is the kernels line's,
    # the float32 one its f32_* fields.  The bf16 cases take the
    # tensor-core route, float32 tf32x3; each case's checks run on the
    # route it asserts, then it is timed beside the SIMT kernel the route
    # replaced.
    gemm_os.launches_by_route.update(dict.fromkeys(gemm_os.launches_by_route,
                                                   0))
    for label, m, dtype, want in (
            ("prefill", M, torch.bfloat16, "tensor_core"),
            ("prefill", M, torch.float32, "tf32x3"),
            ("decode", GEMM_DECODE_M, torch.bfloat16, "tensor_core")):
        isz = dtype.itemsize
        nbytes = (m * K + K * N + m * N) * isz
        bufs = [(randn((m, K), dtype), randn((K, N), dtype, K ** -0.5))
                for _ in range(_copies(nbytes))]
        a, b = bufs[0]
        got = gemm_os(a, b)
        again = gemm_os(a, b)
        flat = gemm_os(a, b, coalesce_grid=True)
        torch.cuda.synchronize()
        err = _held(f"gemm_os {label} {dtype}", got, gemm_ref(a, b),
                    TABLE1_TOL[dtype])
        _held(f"gemm_os {label} {dtype} 1-D tile grid", flat, got, None)
        _held(f"gemm_os {label} {dtype} second call", again, got, None)
        checks = ""
        if label == "prefill":     # the epilogue on the route's fragments
            bias = randn((N,), torch.float32)
            for act in ("silu", "gelu"):
                e = _held(f"gemm_os {dtype} bias+{act}",
                          gemm_os(a, b, bias, activation=act),
                          gemm_ref(a, b, bias, act), TABLE1_TOL[dtype])
                checks += f"; bias+{act} max_abs_err {e:.3e}"
        if dtype == torch.float32:
            e64, lib64 = _tf32x3_error(
                f"gemm_os {label}", got, torch.matmul(a, b),
                a.double() @ b.double())
            checks += (f"; against float64 {e64:.3e}, torch.matmul's own "
                       f"{lib64:.3e} ({e64 / lib64:.2f}x)")
        route = ran_on(gemm_os, want, f"gemm_os {label} {dtype}")
        ms, host_ms = time_ms([lambda a=a, b=b: gemm_os(a, b)
                               for a, b in bufs], 10, cyc)
        plain_ms, _ = time_ms([lambda a=a, b=b: gemm_ref(a, b)
                               for a, b in bufs], 10, cyc)
        library_ms, _ = time_ms([lambda a=a, b=b: torch.matmul(a, b)
                                 for a, b in bufs], 50, cyc)
        ran_on(gemm_os, want, f"gemm_os {label} {dtype} timed")
        # the SIMT kernel the route replaced
        _held(f"gemm_os {label} {dtype} on the SIMT entry",
              _simt_gemm(a, b), gemm_ref(a, b), TABLE1_TOL[dtype])
        prev_ms, _ = time_ms([lambda a=a, b=b: _simt_gemm(a, b)
                              for a, b in bufs], 10, cyc)
        flops = 2 * m * N * K
        if route == "tf32x3":
            bound_ms, bound_by, design_ms = tf32x3_bound(nbytes, flops)
            by_kernel = _device_ms_by_name(gemm_os, bufs)
            ran_on(gemm_os, want, f"gemm_os {label} {dtype} profiled")
            bounds = (_tf32x3_bounds_text(ms, bound_ms, bound_by, design_ms)
                      + f"; by kernel {json.dumps(by_kernel)}")
        else:
            bound_ms, bound_by = roofline(nbytes, flops, PEAK_FLOPS[dtype])
            bounds = (f"bound {bound_ms:.5f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.1f}% of bound")
        print(f"[gemm_os] {str(dtype)[6:]} {label} M={m} K={K} N={N} on "
              f"the {route} route: max_abs_err {err:.3e} (tol rtol "
              f"{TABLE1_TOL[dtype][0]:.2e} atol {TABLE1_TOL[dtype][1]:.0e}),"
              f" 1-D grid and a second call bit-equal{checks}; kernel "
              f"{ms:.5f} ms (host {host_ms:.5f} ms per call), SIMT route "
              f"{prev_ms:.5f} ms ({prev_ms / ms:.2f}x the kernel), plain "
              f"{plain_ms:.5f} ms, torch.matmul {library_ms:.5f} ms "
              f"({ms / library_ms:.2f}x), {bounds} [{card}]")
        if label == "decode":     # beside the prefill's entry
            next(e for e in entries if e["name"] == "gemm_os").update(
                decode_ms=ms, decode_library_ms=library_ms,
                decode_bound_ms=bound_ms, decode_prev_ms=prev_ms)
        elif dtype == torch.float32:
            next(e for e in entries if e["name"] == "gemm_os").update(
                f32_kernel_route=route,
                f32_shape=f"M={m} K={K} N={N} float32, llama3.2-1b ffn_in "
                          f"prefill",
                f32_max_abs_err=err, f32_err64=e64, f32_library_err64=lib64,
                f32_ms=ms, f32_plain_ms=plain_ms, f32_library_ms=library_ms,
                f32_prev_ms=prev_ms, f32_bound_ms=bound_ms,
                f32_bound_by=bound_by, f32_design_ms=design_ms,
                f32_by_kernel_ms=by_kernel)
        else:
            entries.append(dict(
                name="gemm_os", route="cuda", kernel_route=route,
                source="src/repro_torch/csrc/gemm_os.cu",
                replaces="src/repro/kernels/gemm_os/kernel.py:71",
                shape=f"M={m} K={K} N={N} bf16, llama3.2-1b ffn_in prefill",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                prev_ms=prev_ms))
        del bufs
    for dtype in (torch.float32, torch.bfloat16):
        rm, rk, rn = GEMM_RAGGED
        a, b = randn((rm, rk), dtype), randn((rk, rn), dtype, rk ** -0.5)
        got = gemm_os(a, b)
        flat = gemm_os(a, b, coalesce_grid=True)
        torch.cuda.synchronize()
        err = _held(f"gemm_os ragged {dtype}", got, gemm_ref(a, b),
                    TABLE1_TOL[dtype])
        _held(f"gemm_os ragged {dtype} 1-D tile grid", flat, got, None)
        route = ran_on(gemm_os, gemm_route(rm, rk, rn, dtype).kind,
                       f"gemm_os ragged {dtype}")
        print(f"[gemm_os] {str(dtype)[6:]} ragged M={rm} K={rk} N={rn} on "
              f"the {route} route: max_abs_err {err:.3e}, 1-D grid "
              f"bit-equal")

    # conv2d_os: Table-I CONV as a batched edge layer; the bf16 one is the
    # kernels line's, the float32 one its f32_* fields.  Then Listing 2 as
    # written (one image, Cin = 1).
    n, H, W, Cin, Cout, KS = SHAPES["conv"]
    OH, OW = H - KS + 1, W - KS + 1
    conv2d_os.launches_by_route.update(
        dict.fromkeys(conv2d_os.launches_by_route, 0))

    def library_args(x, w):
        """cuDNN's arguments on the same NHWC memory, viewed as
        channels-last NCHW."""
        return x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    def library_conv(x, w):
        return F.conv2d(*library_args(x, w)).permute(0, 2, 3, 1)

    for dtype, want in ((torch.bfloat16, "tensor_core"),
                        (torch.float32, "tf32x3")):
        isz = dtype.itemsize
        nbytes = (n * H * W * Cin + KS * KS * Cin * Cout
                  + n * OH * OW * Cout) * isz
        bufs = [(randn((n, H, W, Cin), dtype),
                 randn((KS, KS, Cin, Cout), dtype, (KS * KS * Cin) ** -0.5))
                for _ in range(_copies(nbytes))]
        x, w = bufs[0]
        got = conv2d_os(x, w)
        again = conv2d_os(x, w)
        torch.cuda.synchronize()
        err = _held(f"conv2d_os {dtype}", got, conv2d_ref(x, w),
                    TABLE1_TOL[dtype])
        _held(f"conv2d_os {dtype} second call", again, got, None)
        checks = ""
        if dtype == torch.float32:
            e64, lib64 = _tf32x3_error(
                "conv2d_os", got, library_conv(x, w),
                library_conv(x.double(), w.double()))
            checks = (f"; against float64 {e64:.3e}, F.conv2d's own "
                      f"{lib64:.3e} ({e64 / lib64:.2f}x)")
        route = ran_on(conv2d_os, want, f"conv2d_os {dtype}")
        ms, host_ms = time_ms([lambda x=x, w=w: conv2d_os(x, w)
                               for x, w in bufs], 20, cyc)
        plain_ms, _ = time_ms([lambda x=x, w=w: conv2d_ref(x, w)
                               for x, w in bufs], 5, cyc)
        lib = [library_args(x, w) for x, w in bufs]
        library_ms, _ = time_ms([lambda x=x, w=w: F.conv2d(x, w)
                                 for x, w in lib], 50, cyc)
        ran_on(conv2d_os, want, f"conv2d_os {dtype} timed")
        # the SIMT kernel the route replaced
        _held(f"conv2d_os {dtype} on the SIMT entry", _simt_conv(x, w),
              conv2d_ref(x, w), TABLE1_TOL[dtype])
        prev_ms, _ = time_ms([lambda x=x, w=w: _simt_conv(x, w)
                              for x, w in bufs], 20, cyc)
        flops = 2 * n * OH * OW * Cout * KS * KS * Cin
        if route == "tf32x3":
            bound_ms, bound_by, design_ms = tf32x3_bound(nbytes, flops)
            by_kernel = _device_ms_by_name(conv2d_os, bufs)
            ran_on(conv2d_os, want, f"conv2d_os {dtype} profiled")
            bounds = (_tf32x3_bounds_text(ms, bound_ms, bound_by, design_ms)
                      + f"; by kernel {json.dumps(by_kernel)}")
        else:
            bound_ms, bound_by = roofline(nbytes, flops, PEAK_FLOPS[dtype])
            bounds = (f"bound {bound_ms:.5f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.1f}% of bound")
        print(f"[conv2d_os] {str(dtype)[6:]} N={n} H=W={H} Cin={Cin} "
              f"Cout={Cout} {KS}x{KS} on the {route} route: max_abs_err "
              f"{err:.3e} (tol rtol {TABLE1_TOL[dtype][0]:.2e} atol "
              f"{TABLE1_TOL[dtype][1]:.0e}), a second call bit-equal"
              f"{checks}; kernel {ms:.5f} ms (host {host_ms:.5f} ms per "
              f"call), SIMT route {prev_ms:.5f} ms ({prev_ms / ms:.2f}x the "
              f"kernel), plain {plain_ms:.5f} ms, F.conv2d "
              f"{library_ms:.5f} ms ({ms / library_ms:.2f}x), {bounds} "
              f"[{card}]")
        if dtype == torch.bfloat16:
            entries.append(dict(
                name="conv2d_os", route="cuda", kernel_route=route,
                source="src/repro_torch/csrc/conv2d_os.cu",
                replaces="src/repro/kernels/conv2d_os/kernel.py:37",
                shape=f"N={n} H=W={H} Cin={Cin} Cout={Cout} {KS}x{KS} bf16, "
                      f"Table-I CONV batched",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                prev_ms=prev_ms))
        else:
            next(e for e in entries if e["name"] == "conv2d_os").update(
                f32_kernel_route=route,
                f32_shape=f"N={n} H=W={H} Cin={Cin} Cout={Cout} {KS}x{KS} "
                          f"float32, Table-I CONV batched",
                f32_max_abs_err=err, f32_err64=e64, f32_library_err64=lib64,
                f32_ms=ms, f32_plain_ms=plain_ms, f32_library_ms=library_ms,
                f32_prev_ms=prev_ms, f32_bound_ms=bound_ms,
                f32_bound_by=bound_by, f32_design_ms=design_ms,
                f32_by_kernel_ms=by_kernel)
        del bufs, lib
    x, w = randn((1, H, W, 1), torch.float32), randn((KS, KS, 1, Cout),
                                                     torch.float32)
    got = conv2d_os(x, w)
    torch.cuda.synchronize()
    err = _held("conv2d_os Cin=1", got, conv2d_ref(x, w),
                TABLE1_TOL[torch.float32])
    route = ran_on(conv2d_os, "simt", "conv2d_os Cin=1")
    print(f"[conv2d_os] float32 Listing 2: N=1 H=W={H} Cin=1 Cout={Cout} on "
          f"the {route} route: max_abs_err {err:.3e}")

    # qgemm_int8 at the ffn_in site, bit for bit, on the tensor cores; the
    # SIMT (dp4a) kernel it replaced timed on the same inputs
    nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
    bufs = []
    for _ in range(_copies(nbytes)):
        qa, sa = quantize_rowwise(randn((M, K), torch.float32))
        qb, sb = quantize_rowwise(randn((N, K), torch.float32))
        bufs.append((qa, qb.t().contiguous(), sa, sb))
    qa, qb, sa, sb = bufs[0]
    qgemm_int8.launches_by_route.update(
        dict.fromkeys(qgemm_int8.launches_by_route, 0))
    got = qgemm_int8(qa, qb, sa, sb)
    ones = qgemm_int8(qa, qb, torch.ones_like(sa), torch.ones_like(sb))
    half = qgemm_int8(qa, qb, sa, sb, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = qgemm_ref(qa, qb, sa, sb)
    err = _held("qgemm_int8", got, want, None)
    _held("qgemm_int8 bf16 output", half,
          qgemm_ref(qa, qb, sa, sb, torch.bfloat16), None)
    acc = int_matmul_ref(qa, qb)
    if acc.abs().max().item() >= 2 ** 24:
        raise AssertionError("accumulator past 2^24: unit scales cannot "
                             "show it exactly in float32")
    _held("qgemm_int8 int32 accumulator", ones, acc.float(), None)
    kind = ran_on(qgemm_int8, qgemm_route(M, K, N), "qgemm_int8")
    ms, host_ms = time_ms([lambda b=b: qgemm_int8(*b) for b in bufs], 20,
                          cyc)
    ran_on(qgemm_int8, kind, "qgemm_int8 timed")
    _held("qgemm_int8 on the SIMT entry", _simt_qgemm(qa, qb, sa, sb), want,
          None)
    prev_ms, _ = time_ms([lambda b=b: _simt_qgemm(*b) for b in bufs], 10,
                         cyc)
    plain_ms, _ = time_ms([lambda b=b: qgemm_ref(*b) for b in bufs], 5, cyc)
    layouts = {}      # torch._int_mm's time in each layout of b it accepts
    for name, lay in INT_MM_LAYOUTS.items():
        pairs = [(b[0], lay(b[1])) for b in bufs]
        try:
            torch._int_mm(*pairs[0])
            torch.cuda.synchronize()
        except RuntimeError:      # not a layout it takes on this card
            continue
        layouts[name] = time_ms([lambda p=p: torch._int_mm(*p)
                                 for p in pairs], 50, cyc)[0]
    library_layout = min(layouts, key=layouts.get) if layouts else None
    library_ms = layouts.get(library_layout)
    fastest = (f"{library_layout} ({ms / library_ms:.2f}x)" if layouts
               else "none")
    bound_ms, bound_by = roofline(nbytes, 2 * M * N * K, PEAK_INT8_OPS)
    print(f"[qgemm_int8] M={M} K={K} N={N} on the {kind} route: output "
          f"(float32 and bf16) and int32 accumulator bit-equal to the plain "
          f"version's; kernel {ms:.5f} ms (host {host_ms:.5f} ms per call), "
          f"SIMT route {prev_ms:.5f} ms ({prev_ms / ms:.2f}x the kernel), "
          f"plain {plain_ms:.5f} ms, torch._int_mm (int32 product only) by "
          f"layout of b {json.dumps(layouts)}, fastest {fastest}, "
          f"bound {bound_ms:.5f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.1f}% of bound [{card}]")
    entries.append(dict(
        name="qgemm_int8", route="cuda", kernel_route=kind,
        source="src/repro_torch/csrc/qgemm_int8.cu",
        replaces="src/repro/kernels/qgemm_int8/kernel.py:40",
        shape=f"M={M} K={K} N={N} int8, llama3.2-1b ffn_in prefill",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library_layout=library_layout, prev_ms=prev_ms))
    del bufs

    # The kernel path's entry point.  Its rows' inputs come from one seed:
    # each row's kernel is first held against its plain version on the
    # very inputs the row then times.
    plain = {"gemm_os": gemm_ref, "decode_attn": decode_attn_ref,
             "conv2d_os": conv2d_ref, "qgemm_int8": qgemm_ref}
    row_route = {}    # row name -> the route the rule gives its inputs
    for name, op, args, _ in micro_cases(torch.device("cuda")):
        got = OPS[op](*args)
        torch.cuda.synchronize()
        dtype = args[0].dtype
        if op == "gemm_os":
            (m, k), n = args[0].shape, args[1].shape[1]
            row_route[name] = gemm_route(m, k, n, dtype).kind
        elif op == "conv2d_os":
            kh, kw, ci, co = args[1].shape
            row_route[name] = conv_route(ci, co, kh, kw, dtype).kind
        elif op == "qgemm_int8":
            (m, k), n = args[0].shape, args[1].shape[1]
            row_route[name] = qgemm_route(m, k, n)
        else:
            hq, d = args[0].shape[1:]
            row_route[name] = attn_route(d, hq // args[1].shape[1], dtype)
        if op == "qgemm_int8":
            tol = None
        elif op == "decode_attn":
            tol = (KERNEL_TOL[dtype],) * 2
        else:
            tol = TABLE1_TOL[dtype]
        err = _held(f"{name} row", got, plain[op](*args), tol)
        print(f"[bench] {name}: {op} on the row's inputs "
              f"{[tuple(a.shape) for a in args]} {str(dtype)[6:]}, "
              f"max_abs_err {err:.3e} (tol "
              f"{'bit-equal' if tol is None else tol})")
        if dtype == torch.float32 and op in ("gemm_os", "decode_attn"):
            fields = _path_f32_row(name, op, args, row_route[name], cyc,
                                   card)
            target = entries if op == "gemm_os" else prior
            next(e for e in target if e["name"] == op).update(fields)
    torch.cuda.synchronize()
    routed = {"gemm_os": gemm_os, "conv2d_os": conv2d_os,
              "qgemm_int8": qgemm_int8, "decode_attn": decode_attn}
    _c10_table1(card)
    _zero_counts(*OPS.values())
    rows = bench_kernel_micro()
    torch.cuda.synchronize()
    launches = {name: op.launches for name, op in OPS.items()}
    by_route = {name: dict(op.launches_by_route)
                for name, op in routed.items()}
    calls = dict.fromkeys(OPS, 0)
    want_by_route = {name: dict.fromkeys(op.launches_by_route, 0)
                     for name, op in routed.items()}
    for r in rows:
        d = r["derived"]
        calls[d["kernel"]] += d["calls"]
        if r["name"] in row_route:
            want_by_route[d["kernel"]][row_route[r["name"]]] += d["calls"]
        print(f"[bench] {r['name']}: {r['us']} us {json.dumps(d)}"
              f" [{card}]")
    if launches != calls:
        raise AssertionError(f"kernel path launches {launches}, its rows "
                             f"called {calls}")
    if by_route != want_by_route or by_route["gemm_os"]["tf32x3"] == 0 or \
            any(by_route[op]["tensor_core"] == 0
                for op in ("gemm_os", "conv2d_os", "qgemm_int8")):
        raise AssertionError(f"kernel path launches by route {by_route}, "
                             f"its rows' routes {want_by_route}")
    print(f"[bench] launches on the kernel path: {launches}; by route "
          f"{by_route}")
    next(e for e in entries if e["name"] == "gemm_os")["path_f32_launches"] = \
        by_route["gemm_os"]["tf32x3"]
    # the entries' launches by route, so that each entry reads its own
    return entries, {**{e["name"]: launches[e["name"]] for e in entries},
                     **{f"{e['name']}:{r}": c for e in entries
                        for r, c in by_route[e["name"]].items()}}


# ROADMAP C16: a float32 product whose tf32x3 scratch, uncapped, would
# not fit beside its inputs and output on the 80 GB card (43.2 GB of
# operands, 57.6 GB of split operands); checked at C16_SAMPLES entries
C16_SHAPE = (60000, 60000, 60000)
C16_SAMPLES = 256
FFN_IN = (1024, 2048, 8192)


def phase_c16(card: str, entries: list) -> None:
    """C16: gemm_os in float32 at C16_SHAPE from seeded torch.randn on the
    card runs on tf32x3 as panel products under the scratch cap
    (kernel.tf32x3_panels), one call, timed with CUDA events:
    C16_SAMPLES entries held to float64 dot products at the route's bar,
    TF32X3_ERR_FACTOR times the library's float32 error on the same
    entries (torch.matmul of the sampled rows and columns, TF32 off: at K
    60000 either sum's error is absolute, about 1e-3, whatever the
    entry's size); the peak memory of the call under inputs + output +
    TF32X3_SCRATCH_BYTES + 1 GiB; its rate (2MNK over the time) above
    the SIMT kernel's at the ffn_in site, timed here; ffn_in itself one
    panel on its 128 x 128 tile.  Adds c16_* fields to the gemm_os entry."""
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.gemm_os.kernel import (TF32X3_SCRATCH_BYTES,
                                                    route, tf32x3_panels)
    from repro_torch.kernels.gemm_os.ops import gemm_os

    M, K, N = C16_SHAPE
    r = route(M, K, N, torch.float32)
    f = route(*FFN_IN, torch.float32)
    if r.kind != "tf32x3" or tuple(f) != ("tf32x3", 128, 128) or \
            len(tf32x3_panels(*FFN_IN, f.block_m, f.block_n)) != 1:
        raise AssertionError(f"C16 {C16_SHAPE} on {r}, ffn_in on {f}: not "
                             f"tf32x3 panels, ffn_in one panel of 128 x 128")
    panels = tf32x3_panels(M, K, N, r.block_m, r.block_n)
    gen = torch.Generator(device="cuda").manual_seed(16)
    a = torch.randn((M, K), generator=gen, device="cuda")
    b = torch.randn((K, N), generator=gen, device="cuda")
    operands_gib = 4 * (M * K + K * N + M * N) / 2 ** 30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(gemm_os)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    c = gemm_os(a, b)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ran_on(gemm_os, "tf32x3", f"gemm_os float32 {C16_SHAPE}")
    rows = torch.randint(0, M, (C16_SAMPLES,), generator=gen, device="cuda")
    cols = torch.randint(0, N, (C16_SAMPLES,), generator=gen, device="cuda")
    a_rows, b_cols = a[rows], b[:, cols].contiguous()
    want = (a_rows.double() * b_cols.t().double()).sum(1)
    library = torch.matmul(a_rows, b_cols).diagonal()
    got = c[rows, cols]
    finite = bool(torch.isfinite(c[rows]).all())
    del a, b, c, a_rows, b_cols
    torch.cuda.empty_cache()
    tflops = 2 * M * N * K / (ms * 1e-3) / 1e12
    limit_gib = operands_gib + TF32X3_SCRATCH_BYTES / 2 ** 30 + 1
    err = (got.double() - want).abs().max().item()
    lib_err = (library.double() - want).abs().max().item()
    cyc = sleep_cycles_per_ms()
    fa = torch.randn(FFN_IN[:2], generator=gen, device="cuda")
    fb = torch.randn(FFN_IN[1:], generator=gen, device="cuda")
    simt_ms, _ = time_ms([lambda: _simt_gemm(fa, fb)], 20, cyc)
    simt_tflops = 2 * math.prod(FFN_IN) / (simt_ms * 1e-3) / 1e12
    del fa, fb
    print(f"[c16] gemm_os float32 M=K=N={M} on the {r.kind} route "
          f"({r.block_m} x {r.block_n}): {len(panels)} panel products of "
          f"up to {panels[0].m} x {panels[0].n} "
          f"({sum(p.split_a for p in panels)} A and "
          f"{sum(p.split_b for p in panels)} B panel splits), "
          f"{ms:.1f} ms, {tflops:.1f} TFLOP/s (SIMT at ffn_in "
          f"{simt_tflops:.1f}: {simt_ms:.5f} ms); peak {peak_gib:.2f} GiB "
          f"(operands {operands_gib:.2f} + cap "
          f"{TF32X3_SCRATCH_BYTES / 2 ** 30:.2f} + 1 = {limit_gib:.2f}); "
          f"{C16_SAMPLES} sampled entries max_abs_err {err:.3e} against "
          f"float64 (torch.matmul float32 on them {lib_err:.3e}: "
          f"{err / lib_err:.2f}x, bar {TF32X3_ERR_FACTOR}x), their rows "
          f"finite {finite}; ffn_in one panel [{card}]")
    _tf32x3_error(f"gemm_os {C16_SHAPE} sampled entries", got, library,
                  want)
    if peak_gib > limit_gib or tflops <= simt_tflops or not finite:
        raise AssertionError(f"C16: peak {peak_gib:.2f} GiB (limit "
                             f"{limit_gib:.2f}), {tflops:.1f} TFLOP/s (SIMT "
                             f"{simt_tflops:.1f}), rows finite {finite}")
    next(e for e in entries if e["name"] == "gemm_os").update(
        c16_shape=f"M=K=N={M} float32", c16_ms=ms, c16_panels=len(panels),
        c16_peak_gib=peak_gib, c16_tflops=tflops, c16_max_abs_err=err,
        c16_library_err=lib_err, c16_simt_ffn_in_tflops=simt_tflops)


def _serve_spec(cfg):
    """(kernel op or None, module whose attribute names it, plain version,
    launches per decode step, launches per admitted prompt, a part of the
    names of the op's device kernels) of the path of ``cfg``'s family:
    GQA transformers (dense, MoE) decode through decode_attn once per
    layer, the zamba2 hybrid once per application of its shared block,
    rwkv6 (ssm) runs wkv6 once per layer in every step and prefill, and
    MLA (deepseek-v3) runs no kernel: the reference has none for it."""
    if cfg.family == "ssm":
        import repro_torch.models.rwkv6 as module
        from repro_torch.kernels.wkv6.ops import wkv6 as op
        from repro_torch.kernels.wkv6.ref import wkv6_ref as ref
        return op, module, ref, cfg.n_layers, cfg.n_layers, "wkv6_"
    if cfg.mla:
        return None, None, None, 0, 0, None
    import repro_torch.models.attention as module
    from repro_torch.kernels.decode_attn.ops import decode_attn as op
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref as ref
    per_step = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" \
        else cfg.n_layers
    return op, module, ref, per_step, 0, "decode_"


def _zero_counts(*ops) -> None:
    """Sets the launch counts of ``ops``, in all and by route, to 0."""
    for op in ops:
        op.launches = 0
        op.launches_by_route.update(dict.fromkeys(op.launches_by_route, 0))


def _counts(op) -> dict:
    """``op``'s launch counts, in all and by route, keyed as main sums them."""
    name = op.__name__
    return {name: op.launches,
            **{f"{name}:{r}": n for r, n in op.launches_by_route.items()}}


def _add_counts(total: dict, more: dict) -> None:
    for key, n in more.items():
        total[key] = total.get(key, 0) + n


# The device kernels that one launch of a decode route runs, by op and route
DECODE_KERNELS = {("wkv6", "decode"): ("wkv6_decode_kernel",),
                  ("decode_attn", "tensor_core"): ("decode_split_tc_kernel",
                                                   "decode_merge_kernel")}


def _decode_kernels(prof) -> dict:
    """The times each device kernel of wkv6's decode route and of
    decode_attn ran in a torch.profiler trace, by name; no prefill runs
    one."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            m = re.search(r"\b(wkv6_decode_kernel|decode_\w*kernel)\b",
                          e.name())
            if m:
                out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def phase_serve(card: str, arch: str, n_layers=None):
    """``arch`` at full width, served through the Engine at full depth or
    cut to ``n_layers``; its kernel runs as ``_serve_spec`` says, and
    neither kernel runs on the MLA path.  The wrappers count the launches
    of the eager steps, of the recording of the step's CUDA graph and of
    the prefills; a torch.profiler trace from the recording on counts the
    kernels the graph's replays ran, by name."""
    import contextlib
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.models.zoo import build_model, cache_tensors
    from repro_torch.serve.engine import EAGER_STEPS, Engine, Request

    cfg = get_config(arch)
    depth = f"{cfg.n_layers} layers"
    if n_layers is not None and n_layers != cfg.n_layers:
        depth = f"{n_layers} of {cfg.n_layers} layers (depth cut, widths " \
                f"as published)"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    op, module, ref, per_step, per_prompt, device_kernel = _serve_spec(cfg)
    name = op.__name__ if op is not None else "no kernel (MLA)"
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[serve] {cfg.name} ({cfg.family}): {depth}, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.hd}{_family_line(cfg)}, "
          f"{'tied' if cfg.tie_embeddings else 'untied'} head, vocab "
          f"{cfg.vocab}, {n_params / 1e9:.3f} B parameters "
          f"({_param_gib(params):.2f} GiB, {cfg.dtype}), init "
          f"{time.perf_counter() - t0:.1f} s")
    eng = Engine(model, params, batch=B, max_len=S_MAX)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(64, 1025))),
                    max_new=int(rng.integers(32, 65)))
            for i in range(N_REQUESTS)]

    pending = deque(reqs)
    prefill_s, decode_s, steps, decoded, prompt_tokens = 0.0, 0.0, 0, 0, 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _zero_counts(decode_attn, wkv6)
    with contextlib.ExitStack() as traced:
        prof = None
        while pending or eng.n_active:
            while pending and eng.has_free_slot():
                req = pending.popleft()
                t0 = time.perf_counter()
                if not eng.admit(req):
                    raise AssertionError(f"no slot for request {req.rid}")
                torch.cuda.synchronize()
                prefill_s += time.perf_counter() - t0
                prompt_tokens += len(req.prompt)
            if prof is None and eng.eager_steps == EAGER_STEPS:
                prof = traced.enter_context(
                    profile(activities=[ProfilerActivity.CUDA]))
            t0 = time.perf_counter()
            decoded += len(eng.step())
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            steps += 1
    if prof is None:
        raise AssertionError(f"{steps} decode steps: no recording")
    ran = _decode_kernels(prof)
    counts = {**_counts(decode_attn), **_counts(wkv6)}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    recorded = EAGER_STEPS + 1     # the steps whose launches Python made
    want = per_step * recorded + per_prompt * N_REQUESTS
    for other in (decode_attn, wkv6):
        expect = want if other is op else 0
        if other.launches != expect:
            raise AssertionError(f"{other.__name__} launched "
                                 f"{other.launches} times, not {expect}, in "
                                 f"{recorded} eager or recorded decode steps "
                                 f"and {N_REQUESTS} prefills of {cfg.name}")
    kernels = () if op is None else DECODE_KERNELS[
        op.__name__, "decode" if op is wkv6 else "tensor_core"]
    want_ran = {k: per_step * eng.graph_replays for k in kernels}
    if ran != want_ran:
        raise AssertionError(f"{eng.graph_replays} replays of the step's "
                             f"CUDA graph ran {ran}, not {want_ran}")
    if op is not None:     # the table's counts: what the card ran
        route = "decode" if op is wkv6 else "tensor_core"
        for key in (name, f"{name}:{route}"):
            counts[key] += per_step * eng.graph_replays
    for r in reqs:
        if not (r.done and len(r.out) == r.max_new
                and all(0 <= t < cfg.vocab for t in r.out)):
            raise AssertionError(f"request {r.rid} ended wrongly: "
                                 f"{len(r.out)}/{r.max_new} tokens")
    if (eng.eager_steps, eng.graph_replays) != (EAGER_STEPS,
                                                steps - EAGER_STEPS):
        raise AssertionError(f"{eng.eager_steps} eager steps and "
                             f"{eng.graph_replays} graph replays in {steps} "
                             f"decode steps")
    how = f"{per_step} x {recorded}" if not per_prompt else \
        f"{per_step} x ({recorded} + {N_REQUESTS})"
    if op is None:
        how = "decode_attn and wkv6 both 0"
    elif op is decode_attn:     # bf16, every D and G: the tensor cores
        how += f", {ran_on(decode_attn, 'tensor_core', name)} route"
    else:     # decode steps on the decode route, prefills by their length
        from repro_torch.kernels.wkv6.kernel import route as wkv6_route
        by_route = dict(wkv6.launches_by_route)
        hd = cfg.d_model // cfg.n_heads
        want_by_route = dict.fromkeys(by_route, 0)
        want_by_route[wkv6_route(1, 1, cfg.n_heads, hd)] += \
            per_step * recorded
        for r in reqs:
            want_by_route[wkv6_route(1, len(r.prompt), cfg.n_heads,
                                     hd)] += per_prompt
        if by_route != want_by_route:
            raise AssertionError(f"wkv6 launches by route {by_route}, not "
                                 f"{want_by_route}")
        how += f"; by route {by_route}"
    print(f"[serve] {N_REQUESTS} requests, {prompt_tokens} prompt tokens, "
          f"{decoded} decoded tokens in {steps} decode steps "
          f"({eng.graph_replays} replays of the step's CUDA graph); "
          f"launches {name} {op.launches if op is not None else 0} = {how}; "
          f"the replays ran {ran or 'no wkv6 or decode_attn kernel'} "
          f"by the trace")
    print(f"[serve] under the profiler from the recording on: "
          f"prefill {prefill_s * 1e3:.1f} ms total "
          f"({prompt_tokens / prefill_s:.0f} prompt tokens/s, batch-1 "
          f"prefills); decode {decode_s * 1e3:.1f} ms total, "
          f"{decode_s / steps * 1e3:.2f} ms/step, {decoded / decode_s:.1f} "
          f"tokens/s; peak memory {peak_gib:.2f} GiB [{card}]")
    if cfg.family == "hybrid":
        profile_prefill(model, params, card)
    if cfg.mtp:
        _check_mtp(model, params, card)

    # One decode step with all slots busy, on caches zeroed first: every
    # row a step may read was written by admission or by the step.
    for c in cache_tensors(eng.caches):
        c.zero_()
    for r in [Request(rid=100 + i, prompt=rng.integers(
            0, cfg.vocab, size=int(rng.integers(64, 1025))),
                          max_new=PROFILE_STEPS + 2)
              for i in range(B)]:
        if not eng.admit(r):
            raise AssertionError(f"no slot for request {r.rid}")
    dev = model.device
    toks = torch.from_numpy(eng.last_tok[:, None].astype(np.int64)).to(dev)
    pos = torch.from_numpy(eng.lengths[:, None].astype(np.int64)).to(dev)
    lens = torch.from_numpy(eng.lengths + 1).to(dev)
    saved = [c.clone() for c in cache_tensors(eng.caches)]
    logits, _ = model.decode(params, eng.caches, toks, pos, lens)
    logits = logits.float()
    if not (torch.isfinite(logits).all() and logits.shape == (B, 1, cfg.vocab)):
        raise AssertionError(f"decode logits not finite or shaped "
                             f"{tuple(logits.shape)}")
    if op is None:
        _check_latent_rows(eng.caches, lens, card)
    else:
        for c, s in zip(cache_tensors(eng.caches), saved):
            c.copy_(s)
        setattr(module, name, ref)
        try:
            plain, _ = model.decode(params, eng.caches, toks, pos, lens)
        finally:
            setattr(module, name, op)
        _held_logits(f"decode step, kernel vs plain {name}", logits,
                     plain.float())
    for c, s in zip(cache_tensors(eng.caches), saved):
        c.copy_(s)
    del saved
    profile_steps(eng, card, device_kernel)
    return counts


def _family_line(cfg) -> str:
    """What the config adds to a dense transformer, for the phase lines."""
    if cfg.moe:
        line = (f", {cfg.n_experts} experts of d_ff {cfg.moe_d_ff} top-"
                f"{cfg.top_k} + {cfg.n_shared_experts} shared, capacity "
                f"factor {cfg.moe_capacity_factor}")
        if cfg.first_k_dense:
            line += (f", {min(cfg.first_k_dense, cfg.n_layers)} dense "
                     f"layers of d_ff {cfg.dense_d_ff}")
        if cfg.mla:
            line += (f", MLA latents {cfg.kv_lora_rank} + rope "
                     f"{cfg.qk_rope_dim}")
        return line + (", MTP head" if cfg.mtp else "")
    if cfg.family == "hybrid":
        return (f", Mamba2 state {cfg.ssm_state}, one shared attention "
                f"block after every {cfg.attn_every}th layer "
                f"({cfg.n_layers // cfg.attn_every} applications)")
    return ""


def _param_gib(params) -> float:
    return sum(p.numel() * p.element_size()
               for p in params.parameters()) / 2 ** 30


def _held_logits(label: str, logits, plain) -> None:
    """Kernel-backed logits against plain-backed ones, within
    LOGITS_REL_TOL of the largest plain logit."""
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"[serve] {label}: max_abs_err {err:.3e}, max |logit| "
          f"{scale:.3f}, tol {LOGITS_REL_TOL * scale:.3e}, argmax agreement "
          f"{agree:.3f}")
    if err > LOGITS_REL_TOL * scale:
        raise AssertionError(f"{label}: kernel-backed logits disagree with "
                             f"the plain-backed ones")


def _check_latent_rows(caches, lens, card: str) -> None:
    """MLA's latent caches after admission and one decode step on zeroed
    caches: every row below a slot's length written (not all zero), every
    row past it still zero."""
    lens = lens.cpu()
    for key, lat in sorted(caches.items()):           # (n, B, S, r)
        written = lat.ne(0).any(-1).cpu()             # (n, B, S)
        rows = torch.arange(lat.shape[2])
        want = (rows[None, :] < lens[:, None]).expand_as(written)
        if not torch.equal(written, want):
            raise AssertionError(f"MLA {key} cache rows written "
                                 f"{int(written.sum())}, not the "
                                 f"{int(want.sum())} rows below the "
                                 f"lengths")
    print(f"[serve] MLA latent caches ({', '.join(sorted(caches))}): rows "
          f"[0, length) of each slot written, every row past it zero "
          f"(lengths {lens.tolist()}) [{card}]")


def _check_mtp(model, params, card: str) -> None:
    """The MTP head once at full width, on one prompt's hidden states."""
    from repro_torch.models.transformer import transformer_apply

    T = 64
    toks = torch.randint(0, model.cfg.vocab, (1, T), device=model.device,
                         generator=torch.Generator(device=model.device)
                         .manual_seed(2))
    pos = torch.arange(T, device=model.device)[None]
    with torch.no_grad():
        hidden, _ = transformer_apply(params, model.cfg, toks, pos)
        logits = model.mtp_logits(params, hidden, toks)
    if not (torch.isfinite(logits.float()).all()
            and logits.shape == (1, T - 1, model.cfg.vocab)):
        raise AssertionError(f"MTP logits not finite or shaped "
                             f"{tuple(logits.shape)}")
    print(f"[serve] MTP head on a {T}-token prompt: logits "
          f"{tuple(logits.shape)}, finite [{card}]")


def profile_prefill(model, params, card: str) -> None:
    """One batch-1 prefill of PREFILL_PROFILE_T tokens: host seconds and
    tokens/s, then under torch.profiler the device kernel launches per
    prompt token (the zamba2 SSD scan runs one a step per layer)."""
    from torch.profiler import ProfilerActivity, profile

    T = PREFILL_PROFILE_T
    toks = torch.randint(0, model.cfg.vocab, (1, T), device=model.device,
                         generator=torch.Generator(device=model.device)
                         .manual_seed(1))
    lens = torch.tensor([T], device=model.device)
    model.prefill(params, toks, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, toks, lens)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # device activity only: the host-side events of ~40 launches a token
    # make the trace several times larger
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.prefill(params, toks, lens)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and getattr(e, "self_device_time_total", 0) > 0]
    n_launch = sum(e.count for e in kernels)
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"[serve] one batch-1 prefill of {T} tokens: host {host_s:.3f} s "
          f"({T / host_s:.0f} tokens/s); under the profiler {n_launch} "
          f"device kernel launches ({n_launch / T:.1f} per token), device "
          f"busy {busy_s:.3f} s, idle share {1 - busy_s / host_s:.3f} of "
          f"the unprofiled prefill (profiled and read in "
          f"{time.perf_counter() - t0:.1f} s) [{card}]")


def phase_embedded(card: str, arch: str) -> dict:
    """An embeddings-input config (audio / vlm backbone) at full size, at
    model level: a batch-B prefill of EMBED_PREFILL_T seeded N(0, 1)
    embeddings merged into a B x S_MAX cache, EMBED_DECODE_STEPS decode
    steps of seeded embeddings with decode_attn on the tensor cores once
    per layer and step, then one more step held against the same step
    with the plain version."""
    import repro_torch.models.attention as attention
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.models.zoo import build_model, cache_tensors

    cfg = get_config(arch)
    model = build_model(cfg)
    dev = model.device
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[embed] {cfg.name} ({cfg.family}, {cfg.input_mode} in): "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, vocab {cfg.vocab}, "
          f"{n_params / 1e9:.3f} B parameters ({_param_gib(params):.2f} "
          f"GiB, {cfg.dtype}), init {time.perf_counter() - t0:.1f} s")
    T, steps = EMBED_PREFILL_T, EMBED_DECODE_STEPS
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
    step_in = torch.randn((steps + 1, B, 1, cfg.d_model), generator=gen,
                          device=dev)
    torch.cuda.reset_peak_memory_stats()
    caches = model.init_cache(B, S_MAX)
    _zero_counts(decode_attn, wkv6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, pre = model.prefill(params, prompt, torch.full((B,), T, device=dev))
    for full, new in zip(cache_tensors(caches), cache_tensors(pre)):
        full[:, :, :, :T] = new
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del pre
    decode_s = 0.0
    for t in range(steps):
        pos = torch.full((B, 1), T + t, device=dev)
        lens = torch.full((B,), T + t + 1, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        logits, caches = model.decode(params, caches, step_in[t], pos, lens)
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
    counts = {**_counts(decode_attn), **_counts(wkv6)}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = cfg.n_layers * steps
    if decode_attn.launches != want or wkv6.launches:
        raise AssertionError(f"{cfg.name}: decode_attn launched "
                             f"{decode_attn.launches} times (not {want}), "
                             f"wkv6 {wkv6.launches}")
    if not (torch.isfinite(logits.float()).all()
            and logits.shape == (B, 1, cfg.vocab)):
        raise AssertionError(f"decode logits not finite or shaped "
                             f"{tuple(logits.shape)}")
    route = ran_on(decode_attn, "tensor_core", cfg.name)
    print(f"[embed] prefill of {B} x {T} embeddings {prefill_s * 1e3:.1f} ms "
          f"({B * T / prefill_s:.0f} tokens/s); {steps} decode steps "
          f"{decode_s / steps * 1e3:.2f} ms/step "
          f"({B * steps / decode_s:.1f} tokens/s); decode_attn launches "
          f"{want} = {cfg.n_layers} x {steps} on the {route} route; peak "
          f"memory {peak_gib:.2f} GiB [{card}]")

    # One more step, kernel against plain version.  Every layer writes
    # its K/V at the step's position before it attends, so the plain
    # step overwrites all that the kernel step wrote.
    pos = torch.full((B, 1), T + steps, device=dev)
    lens = torch.full((B,), T + steps + 1, dtype=torch.int32, device=dev)
    logits, _ = model.decode(params, caches, step_in[steps], pos, lens)
    with mock.patch.object(attention, "decode_attn", decode_attn_ref):
        plain, _ = model.decode(params, caches, step_in[steps], pos, lens)
    _held_logits(f"{cfg.name} decode step, kernel vs plain decode_attn",
                 logits.float(), plain.float())
    return counts


def _chained_logits(model, params, inputs, positions):
    """Prefill inputs[0], merge its caches into a cache of S positions by
    the engine's rule, then decode inputs[1:] at ``positions``: the list
    of logits."""
    from repro_torch.models.zoo import cache_tensors

    first = inputs[0]
    Bc, T = first.shape[0], first.shape[1]
    logits, pre = model.prefill(params, first,
                                torch.full((Bc,), T, device=first.device))
    out = [logits]
    caches = model.init_cache(Bc, CARD_CPU_S)
    for full, new in zip(cache_tensors(caches), cache_tensors(pre)):
        idx = [slice(None)] * new.ndim
        seq = [ax for ax in range(2, new.ndim)
               if new.shape[ax] != full.shape[ax]]
        if seq:
            idx[seq[0]] = slice(0, new.shape[seq[0]])
        full[tuple(idx)] = new
    for x, pos in zip(inputs[1:], positions):
        logits, caches = model.decode(params, caches, x, pos, pos[:, 0] + 1)
        out.append(logits)
    return out


def phase_card_cpu(card: str) -> None:
    """The new families' code that runs no kernel of its own (MoE routing
    and experts, MLA, MTP, the Mamba2 scan, embedding inputs), card
    against CPU: each of CARD_CPU at serve_smoke_config size in float32,
    with the CPU's parameters copied to the card, a prefill and
    CARD_CPU_STEPS chained decode steps on both; logits within
    CARD_CPU_TOL and every MoE routing's expert choices (idx) and kept
    choices (keep) equal."""
    import copy

    import repro_torch.models.moe as moe
    from repro_torch.configs.registry import serve_smoke_config
    from repro_torch.models.zoo import build_model

    route = moe.moe_route
    for arch in CARD_CPU:
        cfg = serve_smoke_config(arch)
        assert cfg.dtype == torch.float32
        rng = np.random.default_rng(0)
        Bc, T = 2, 8
        shapes = [(Bc, T)] + [(Bc, 1)] * CARD_CPU_STEPS
        if cfg.input_mode == "tokens":
            inputs = [torch.from_numpy(rng.integers(0, cfg.vocab, sh))
                      for sh in shapes]
        else:
            inputs = [torch.from_numpy(rng.normal(size=(*sh, cfg.d_model))
                                       .astype(np.float32)) for sh in shapes]
        positions = [torch.tensor([[T + t], [T + 1 + t]])
                     for t in range(CARD_CPU_STEPS)]
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
        runs = {}
        for dev in ("cuda", "cpu"):
            model = cpu_model if dev == "cpu" else build_model(cfg)
            params = cpu_params if dev == "cpu" else \
                copy.deepcopy(cpu_params).to(model.device)
            seen = []

            def recording(router, xf, k, C):
                out = route(router, xf, k, C)
                seen.append((out[2].cpu(), out[3].cpu()))
                return out

            with mock.patch.object(moe, "moe_route", recording):
                logits = _chained_logits(
                    model, params, [x.to(model.device) for x in inputs],
                    [p.to(model.device) for p in positions])
            runs[dev] = ([lg.cpu() for lg in logits], seen)
        (card_logits, card_routes), (cpu_logits, cpu_routes) = \
            runs["cuda"], runs["cpu"]
        err = 0.0
        for got, want in zip(card_logits, cpu_logits):
            torch.testing.assert_close(got, want, rtol=CARD_CPU_TOL,
                                       atol=CARD_CPU_TOL)
            err = max(err, (got - want).abs().max().item())
        if len(card_routes) != len(cpu_routes) or any(
                not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
                for a, b in zip(card_routes, cpu_routes)):
            raise AssertionError(f"{arch}: MoE routing differs card to CPU")
        dropped = sum(int((~keep).sum()) for _, keep in cpu_routes)
        print(f"[card_cpu] {cfg.name}: prefill + {CARD_CPU_STEPS} decode "
              f"steps, logits max |card - cpu| {err:.2e} (tol "
              f"{CARD_CPU_TOL}); {len(cpu_routes)} MoE routings, idx and "
              f"keep equal, {dropped} choices dropped [{card}]")


def phase_serve_cgra(card: str) -> dict:
    """CGRA-backed serving (the reference's serve_decode --cgra):
    1. on the host, the ServePlan of each of the ten configs at
       CGRA_PLAN_TOKENS tokens on cluster_4x4, each round-tripped through
       to_json / from_json, embedded and ref-only (resolved through
       Toolchain.load_artifact from the memo and from the disk cache);
    2. llama3.2-1b's plan spot-checked on the card (CGRA_SPOT_SEEDS) and
       on the CPU, with the same verdict;
    3. llama3.2-1b at full width and depth served on the card under
       CGRAExecutionModel(plan) through run_traffic: decode_attn once per
       layer and decode step on the tensor cores, and the report
       byte-equal to a CPU engine's over the config cut to one layer (the
       modeled clock depends on the plan, the lengths and the slots only;
       the vocab, which moves the prompt RNG, stays);
    4. repro_torch.bench.bench_serve_decode() on the card, its rows equal
       to the committed BENCH_serve_decode.json rows.
    Returns the kernels' launches in steps 3 and 4."""
    import dataclasses

    from repro_torch.bench import SERVE_ARCHS, bench_serve_decode
    from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                              serve_smoke_config)
    from repro_torch.core.adl import cluster_4x4
    from repro_torch.core.toolchain import Toolchain
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.plan import (CGRAExecutionModel, ServePlan,
                                        build_serve_plan)
    from repro_torch.serve.traffic import (TrafficConfig, report_json,
                                           run_traffic)

    cache = os.path.join(ROOT, "build", "chip_smoke", "plan_cache")
    shutil.rmtree(cache, ignore_errors=True)
    tc = Toolchain(arch=cluster_4x4(), cache_dir=cache)
    t0 = time.perf_counter()
    plans = {}
    for arch_id in ARCH_IDS:
        plan = build_serve_plan(get_config(arch_id), toolchain=tc,
                                tokens=CGRA_PLAN_TOKENS, spot_check=False)
        blob = plan.to_json()
        refs = plan.to_json(embed_kernels=False)
        for how, text, via in (("embedded", blob, None),
                               ("ref-only, memo", refs, tc),
                               ("ref-only, disk",
                                refs, Toolchain(cache_dir=cache))):
            if ServePlan.from_json(text, toolchain=via).to_json() != blob:
                raise AssertionError(f"{arch_id}: the {how} plan does not "
                                     f"round-trip")
        tiles = sorted({"x".join(map(str, st.tile)) for st in plan.sites})
        print(f"[serve_cgra] step 1 {arch_id}: {len(plan.sites)} sites, "
              f"tiles {tiles}, decode step at B 8 "
              f"{plan.decode_step_s(8) * 1e3:.3f} ms modeled; round trips "
              f"embedded / ref-only (memo, disk) equal; plan sha256 "
              f"{hashlib.sha256(blob.encode()).hexdigest()}")
        plans[arch_id] = plan
    print(f"[serve_cgra] step 1: {len(plans)} plans built and round-tripped "
          f"on the host in {time.perf_counter() - t0:.2f} s")

    plan = plans["llama3.2-1b"]
    n_sites = len(plan.sites)
    verdicts = {}
    for dev, seeds in CGRA_SPOT_SEEDS.items():
        t0 = time.perf_counter()
        verdicts[dev] = plan.spot_check(seeds=seeds, n_sites=n_sites,
                                        device=dev)
        print(f"[serve_cgra] step 2 spot check on {dev}, seeds "
              f"{seeds.start}-{seeds.stop - 1}: {verdicts[dev]} verified "
              f"bit-exactly in {time.perf_counter() - t0:.2f} s")
    if verdicts["cuda"] != verdicts["cpu"]:
        raise AssertionError(f"spot checks differ: {verdicts}")

    cfg = get_config("llama3.2-1b")
    traffic = TrafficConfig(**CGRA_TRAFFIC)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    eng = Engine(model, params, batch=CGRA_BATCH, max_len=CGRA_MAX_LEN,
                 exec_model=CGRAExecutionModel(plan))
    torch.cuda.synchronize()
    _zero_counts(decode_attn, wkv6)
    t0 = time.perf_counter()
    report = run_traffic(eng, traffic, cfg.vocab)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {**_counts(decode_attn), **_counts(wkv6)}
    want = cfg.n_layers * report["decode_steps"]
    if decode_attn.launches != want or wkv6.launches:
        raise AssertionError(f"the --cgra episode launched decode_attn "
                             f"{decode_attn.launches} times (not {want}) "
                             f"and wkv6 {wkv6.launches} times")
    route = ran_on(decode_attn, "tensor_core", "the --cgra episode")
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    cpu_cfg = dataclasses.replace(cfg, n_layers=1)
    cpu_model = build_model(cpu_cfg, device="cpu")
    cpu_eng = Engine(cpu_model,
                     cpu_model.init(torch.Generator().manual_seed(0)),
                     batch=CGRA_BATCH, max_len=CGRA_MAX_LEN,
                     exec_model=CGRAExecutionModel(plan), device="cpu")
    text = report_json(report)
    if report_json(run_traffic(cpu_eng, traffic, cfg.vocab)) != text:
        raise AssertionError("the card's --cgra report differs from the "
                             "CPU engine's")
    del cpu_eng, cpu_model
    print(f"[serve_cgra] step 3 {cfg.name} ({cfg.n_layers} layers) under "
          f"the plan, batch {CGRA_BATCH}, max_len {CGRA_MAX_LEN}, "
          f"{traffic}: served {report['served']}, "
          f"{report['decoded_tokens']} tokens in {report['decode_steps']} "
          f"decode steps; decode_attn launches {want} = {cfg.n_layers} x "
          f"{report['decode_steps']} on the {route} route; modeled "
          f"{report['tokens_per_s']} tokens/s over "
          f"{report['episode_s']} modeled s; host {host_s:.2f} s for the "
          f"episode [{card}]; report byte-equal to the CPU engine's (1 "
          f"layer), sha256 {hashlib.sha256(text.encode()).hexdigest()}")

    with open(SERVE_DECODE_BENCH, encoding="utf-8") as f:
        committed = json.load(f)["rows"]
    _zero_counts(decode_attn, wkv6)
    t0 = time.perf_counter()
    rows = bench_serve_decode()
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    _add_counts(launches, {**_counts(decode_attn), **_counts(wkv6)})
    if rows != committed:
        raise AssertionError(f"bench_serve_decode rows {rows} differ from "
                             f"the committed {committed}")
    smoke = {a: serve_smoke_config(a).n_layers for a in SERVE_ARCHS}
    llama, rwkv = (r["derived"] for r in rows)
    want = {"decode_attn": smoke["llama3.2-1b"] * llama["decode_steps"],
            "wkv6": smoke["rwkv6-1.6b"] * (rwkv["decode_steps"]
                                           + rwkv["served"])}
    got = {"decode_attn": decode_attn.launches, "wkv6": wkv6.launches}
    if got != want:
        raise AssertionError(f"bench_serve_decode launched {got}, not "
                             f"{want}")
    for r in rows:
        print(f"[serve_cgra] step 4 {r['name']}: {r['us']} us modeled, "
              f"{json.dumps(r['derived'])}")
    print(f"[serve_cgra] step 4 bench_serve_decode on the card: rows equal "
          f"the committed ones; launches {got} (by route: decode_attn "
          f"{decode_attn.launches_by_route}, wkv6 "
          f"{wkv6.launches_by_route}); host {bench_s:.2f} s [{card}]")
    return launches


def profile_steps(eng, card: str, kernel) -> None:
    """Device busy time and the costliest kernels of a few decode steps
    with all slots busy, from torch.profiler, and the rows whose names
    hold ``kernel`` (None: no kernel on the path) wherever they rank."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0)

    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / PROFILE_STEPS
    n_launch = sum(e.count for e in kernels) / PROFILE_STEPS
    print(f"[profile] {PROFILE_STEPS} decode steps, {eng.n_active} slots "
          f"busy: {wall_ms:.2f} ms/step under the profiler, device busy "
          f"{busy_ms:.3f} ms/step in {n_launch:.0f} kernel launches, idle "
          f"share {1 - busy_ms / wall_ms:.3f} [{card}]")
    ranked = sorted(kernels, key=dev_us, reverse=True)
    for e in ranked[:8] + [e for e in ranked[8:]
                           if kernel is not None and kernel in e.key]:
        print(f"[profile]   {dev_us(e) / 1e3 / PROFILE_STEPS:.4f} ms/step, "
              f"{e.count / PROFILE_STEPS:.0f} launches/step: {e.key[:100]}")
    if kernel is None:
        return
    own_ms = sum(dev_us(e) for e in kernels
                 if kernel in e.key) / 1e3 / PROFILE_STEPS
    print(f"[profile]   the {kernel}* kernels: {own_ms:.4f} ms/step, "
          f"{own_ms / busy_ms:.3f} of the device-busy time, "
          f"{own_ms / wall_ms:.3f} of the step [{card}]")


class _StageClock:
    """Seconds ``verify_batch`` spends in its three stages — host test
    data, the DFG check (the torch oracle) and the simulation — by timing
    the functions it calls while the block runs (outermost call only)."""

    STAGES = {"data": (("verify", "generate_test_data_batch"),
                       ("toolchain.CompiledKernel", "random_banks")),
              "dfg": (("verify", "check_dfg_semantics_batch"),
                      ("verify", "reference_banks_batch")),
              "sim": (("toolchain.CompiledKernel", "run_batch"),
                      ("simulator", "simulate_multi"))}

    def __init__(self):
        self.s = dict.fromkeys(self.STAGES, 0.0)

    def __enter__(self):
        import importlib
        self._saved = []
        depth = dict.fromkeys(self.STAGES, 0)
        for stage, places in self.STAGES.items():
            for where, attr in places:
                mod, _, cls = where.partition(".")
                owner = importlib.import_module(f"repro_torch.core.{mod}")
                owner = getattr(owner, cls) if cls else owner
                fn = getattr(owner, attr)

                def timed(*a, _fn=fn, _stage=stage, **kw):
                    depth[_stage] += 1
                    t0 = time.perf_counter()
                    try:
                        return _fn(*a, **kw)
                    finally:
                        depth[_stage] -= 1
                        if not depth[_stage]:
                            self.s[_stage] += time.perf_counter() - t0
                self._saved.append((owner, attr, fn))
                setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)


def _sim_work(ck, images: int):
    """Simulated cycles x images of one run, (exact, bucketed): the cycle
    count of an invocation (the loop's own, and the runner signature's
    bucket), times invocations, times images."""
    from repro_torch.core import simcache
    n = ck.cfg.n_cycles(ck.mapped_iters)
    k = len(ck.invocations) * images
    return n * k, simcache.bucket_cycles(n) * k


def _cgra_step(step: str, what: str, clock: _StageClock, wall: float,
               runs, verifies: int, card: str) -> None:
    """One step line; ``runs``: (compiled kernel, images) pairs."""
    sim = clock.s["sim"]
    work = [_sim_work(ck, n) for ck, n in runs]
    exact, bucketed = (sum(w[i] for w in work) for i in (0, 1))
    print(f"[cgra] step {step} {what}: {wall:.2f} s (host test data "
          f"{clock.s['data']:.2f} s, DFG check {clock.s['dfg']:.2f} s, "
          f"simulation {sim:.2f} s = {exact / sim:.4g} cycles*images/s "
          f"on the exact cycles, {bucketed / sim:.4g} on the bucketed), "
          f"{verifies / wall:.1f} verifies/s [{card}]")


def phase_cgra(card: str) -> dict:
    """The CGRA flow of repro_torch.core on the card: compile on the host,
    verify over seed fleets, reloaded artifacts, a stacked RF cohort and
    one full-size kernel, each word for word; then a profile of one
    batched simulation.  Raises on any mismatch; returns the compiled
    verification set by name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench import (OPS, RF_COHORT, VERIFY_SEEDS,
                                   bench_sim_throughput,
                                   bench_verify_batched, rf_cohort_arch,
                                   share_verification_toolchain)
    from repro_torch.core import simcache, table1_kernels
    from repro_torch.core.pool import reset_pool
    from repro_torch.core.refexec import reference_execute_torch
    from repro_torch.core.simulator import simulate_batch
    from repro_torch.core.toolchain import (CompiledKernel, Toolchain,
                                            verify_stacked)
    from repro_torch.core.verify import generate_test_data_batch
    from repro_torch.frontend.library import dsl_kernels
    from repro_torch.kernels.wkv6.ops import wkv6

    dev = torch.device("cuda", torch.cuda.current_device())
    five = {**OPS, "wkv6": wkv6}
    for op in five.values():
        op.launches = 0
    try:
        # 1. compile the verification set on the host
        specs = {**table1_kernels(small=True), **dsl_kernels()}
        tc = Toolchain(cache_dir="")
        share_verification_toolchain(tc)     # the bench rows' set too
        cks = {}
        for name in CGRA_SET:
            t0 = time.perf_counter()
            cks[name] = tc.compile(specs[name])
            print(f"[cgra] step 1 compiled {name}: II {cks[name].II}, "
                  f"{_sim_work(cks[name], 1)[0]} cycles an image, "
                  f"{time.perf_counter() - t0:.2f} s")

        # 2. the verification fleet: golden oracle, 1024 seeds a kernel
        n = CGRA_SEEDS["fleet"]
        for name, ck in cks.items():
            init = [generate_test_data_batch(ck.spec, [s]).init_row(0)
                    for s in range(4)]
            want, got = ck.run_batch(init, device="cpu"), \
                ck.run_batch(init, device=dev)
            for i, (w, g) in enumerate(zip(want, got)):
                for bank in w:
                    if not np.array_equal(w[bank], g[bank]):
                        raise AssertionError(f"{name} seed {i}: card and "
                                             f"CPU banks differ in {bank}")
        with _StageClock() as clock:
            t0 = time.perf_counter()
            for ck in cks.values():
                ck.verify_batch(range(n), device=dev)
            wall = time.perf_counter() - t0
        _cgra_step("2", f"verify_batch of {len(cks)} kernels x {n} seeds "
                   "(golden oracle; seeds 0-3 equal to the CPU's)", clock,
                   wall, [(ck, n) for ck in cks.values()], len(cks) * n,
                   card)
        step2_rate = len(cks) * n / wall

        # 3. reloaded artifacts: the torch DFG oracle on the card
        n = CGRA_SEEDS["reloaded"]
        loaded = [CompiledKernel.from_json(ck.to_json())
                  for ck in cks.values()]
        for ck in loaded:
            assert ck.spec is None
            init = [ck.random_banks(s) for s in range(8)]
            stacked = {k: np.stack([b[k] for b in init]) for k in init[0]}
            bits = ck.arch.datapath_bits
            got = reference_execute_torch(ck.dfg, ck.mapped_iters, stacked,
                                          ck.invocations, bits, device=dev)
            want = ck.dfg.reference_execute_batch(
                ck.mapped_iters, stacked, ck.invocations, bits=bits)
            for bank in want:
                if not np.array_equal(got[bank], want[bank]):
                    raise AssertionError(f"{ck.name}: the card's DFG oracle "
                                         f"differs from numpy in {bank}")
        with _StageClock() as clock:
            t0 = time.perf_counter()
            for ck in loaded:
                ck.verify_batch(range(n), device=dev)
            wall = time.perf_counter() - t0
        _cgra_step("3", f"verify_batch of {len(loaded)} reloaded artifacts "
                   f"x {n} seeds (torch DFG oracle on the card, 8 seeds "
                   "equal to numpy's)", clock, wall,
                   [(ck, n) for ck in loaded], len(loaded) * n, card)

        # 4. stacked: dwconv and requant-int8 over an RF 4/8/16 cohort
        n = CGRA_SEEDS["stacked"]
        cohort = [tc.compile(dsl_kernels(rf_cohort_arch(rf))[name])
                  for name in ("dwconv", "requant-int8") for rf in RF_COHORT]
        with _StageClock() as clock:
            t0 = time.perf_counter()
            verify_stacked(cohort, range(n), device=dev)
            wall = time.perf_counter() - t0
        multi = sorted({(s.II, s.RF, s.batch) for s in simcache._entries
                        if s.multi})
        if not multi:
            raise AssertionError("verify_stacked built no multi-"
                                 "architecture signature")
        _cgra_step("4", f"verify_stacked of {len(cohort)} kernels (RF "
                   f"{'/'.join(map(str, RF_COHORT))}) x {n} seeds, multi "
                   f"signatures (II, RF, rows) {multi}, simcache "
                   f"{simcache.stats()}", clock, wall,
                   [(ck, n) for ck in cohort], len(cohort) * n, card)

        # 5. full size: CONV-U-C-1 at the paper's Table-I dims
        n = CGRA_SEEDS["full"]
        t0 = time.perf_counter()
        full = tc.compile(table1_kernels(small=False)["CONV-U-C-1"])
        print(f"[cgra] step 5 compiled full-size CONV-U-C-1: II {full.II}, "
              f"{len(full.invocations)} invocations, "
              f"{_sim_work(full, 1)[0]} cycles an image "
              f"({_sim_work(full, 1)[1]} bucketed), "
              f"{time.perf_counter() - t0:.2f} s")
        with _StageClock() as clock:
            t0 = time.perf_counter()
            full.verify_batch(range(n), device=dev)
            wall = time.perf_counter() - t0
        _cgra_step("5", f"verify_batch of full-size CONV-U-C-1 x {n} seeds",
                   clock, wall, [(full, n)], n, card)

        # 6. profile one simulate_batch of GEMM over 1024 images
        ck = cks["GEMM"]
        n = CGRA_SEEDS["fleet"]
        data = generate_test_data_batch(ck.spec, range(n))
        init = [data.init_row(i) for i in range(n)]
        args = (ck.cfg, init, ck.invocations, ck.mapped_iters)
        simulate_batch(*args, device=dev)
        t0 = time.perf_counter()
        simulate_batch(*args, device=dev)
        plain_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate_batch(*args, device=dev)
            wall_s = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and getattr(e, "self_device_time_total", 0) > 0]
        busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
        n_launch = sum(e.count for e in kernels)
        cycles = _sim_work(ck, 1)[0]
        print(f"[cgra] step 6 simulate_batch of GEMM x {n} images, "
              f"{cycles} cycles: {plain_s:.3f} s "
              f"({cycles * n / plain_s:.4g} cycles*images/s); under the "
              f"profiler {wall_s:.3f} s, {n_launch} kernel launches = "
              f"{n_launch / cycles:.2f} a simulated cycle, device busy "
              f"{busy_s:.4f} s, idle share {1 - busy_s / wall_s:.3f} "
              f"[{card}]")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                        reverse=True)[:6]:
            print(f"[cgra]   {e.self_device_time_total / 1e3:.2f} ms in "
                  f"{e.count} launches: {e.key[:90]}")

        # 7. the flow's bench rows on the card, held against steps 1, 2, 6
        sim_row, = bench_sim_throughput()
        ver_row, = bench_verify_batched()
        print(f"[cgra] step 7 {json.dumps(sim_row)}")
        print(f"[cgra] step 7 {json.dumps(ver_row)}")
        d = sim_row["derived"]
        if d["cycles"] != cycles:
            raise AssertionError(f"simulator_gemm_torch ran {d['cycles']} "
                                 f"cycles, step 1's GEMM has {cycles}")
        d = ver_row["derived"]
        if (d["kernels"], d["batch"]) != (len(CGRA_SET), len(VERIFY_SEEDS)):
            raise AssertionError(f"verify_batched_torch covered {d}")
        print(f"[cgra] step 7 simulator_gemm_torch: {sim_row['derived']['cycles_per_s']} "
              f"cycles/s at 1 image against step 6's "
              f"{cycles / plain_s:.4g} at {n} images; verify_batched_torch: "
              f"{d['batch_verifies_per_s']} verifies/s batched, "
              f"{d['seq_verifies_per_s']} one seed at a time, at "
              f"{d['batch']} seeds, against step 2's {step2_rate:.1f} at "
              f"{CGRA_SEEDS['fleet']} [{card}]")
    finally:
        reset_pool(kill=True)
    launched = {name: op.launches for name, op in five.items()
                if op.launches}
    if launched:
        raise AssertionError(f"the CGRA path launched {launched}")
    print("[cgra] the CGRA path launched none of the five kernels")
    return cks


def _worker_cuda_state(_unit) -> bool:
    """Runs in a fleet worker process: has the worker initialised CUDA?"""
    return torch.cuda.is_initialized()


def _profiled(fn):
    """(fn's result, wall s, device busy s) of one call under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e6
    return out, wall, busy


def _tools_step(step: str, what: str, seconds: float, card: str,
                wall_busy=None) -> None:
    idle = ""
    if wall_busy is not None:
        wall, busy = wall_busy
        idle = (f"; under the profiler {wall:.2f} s, device busy "
                f"{busy:.4f} s, idle share {1 - busy / wall:.3f}")
    print(f"[tools] step {step} {what}: {seconds:.2f} s{idle} [{card}]")


def _same_file(got: str, want: str, label: str) -> None:
    if not filecmp.cmp(got, want, shallow=False):
        raise AssertionError(f"{label}: {got} differs from {want}")


def phase_cgra_tools(card: str, cks: dict) -> None:
    """The flow's tools (repro_torch.isa, check, dist, dse) on the card,
    over phase_cgra's compiled verification set: instruction streams and
    the interpreter, the static checker and its mutation gate, the verify
    gates, the tiny design-space sweep (cold through the compile fleet,
    warm, resumed) and a search.  Raises on any mismatch."""
    import dataclasses

    from repro_torch.bench import (OPS, SEARCH_KERNELS, bench_check_static,
                                   bench_dse_search, bench_isa_export,
                                   dse_sweep_rows)
    from repro_torch.check import check_kernel, report_json
    from repro_torch.check.mutate import (CLASSES, MIN_SCORE, _probe_dead,
                                          mutate_one, mutation_gate)
    from repro_torch.core import MapperOptions, Toolchain, morpher_8x8
    from repro_torch.core import simulator
    from repro_torch.core.pool import reset_pool
    from repro_torch.core.toolchain import verify_stacked
    from repro_torch.dist.fleet import FleetConfig, run_fleet
    from repro_torch.dse import (SearchConfig, get_space, kernel_suite,
                                 run_search, run_sweep, write_artifacts)
    from repro_torch.isa import CSV_NAME, cross_validate, cross_validate_dir
    from repro_torch.kernels.wkv6.ops import wkv6

    dev = torch.device("cuda", torch.cuda.current_device())
    out = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(out, ignore_errors=True)
    five = {**OPS, "wkv6": wkv6}
    for op in five.values():
        op.launches = 0
    tc = Toolchain(cache_dir="")
    try:
        # (a) instruction streams: export, golden, interpreter = card
        t0 = time.perf_counter()
        dirs = {name: os.path.join(out, "isa", name) for name in cks}
        for name, ck in cks.items():
            tc.export_streams(ck, dirs[name])
        _same_file(os.path.join(dirs["GEMM"], CSV_NAME), GOLDEN_CSV,
                   "GEMM-small instructions.csv")
        t1 = time.perf_counter()
        n = sum(cross_validate_dir(ck, dirs[name], seeds=TOOLS_XVAL_SEEDS,
                                   device=dev) for name, ck in cks.items())
        t2 = time.perf_counter()
        _, wall, busy = _profiled(lambda: cross_validate(
            cks["GEMM"], seeds=(0,), device=dev))
        _tools_step("a", f"exported {len(cks)} kernels' streams in "
                    f"{t1 - t0:.2f} s (GEMM's byte-equal to the golden "
                    f"file); interpreter = the card's simulator on {n} "
                    f"(kernel, seed) pairs; one seed of GEMM profiled",
                    t2 - t1, card, (wall, busy))
        for row in bench_isa_export(dev):
            print(f"[tools] step a {json.dumps(row)}")

        # (b) the static checker, its report and the mutation gate
        t0 = time.perf_counter()
        per_kernel = {}
        torus = dataclasses.replace(cks["GEMM"].arch, torus=True,
                                    name="morpher-cluster-4x4-torus")
        big = kernel_suite(morpher_8x8())
        groups = (("cluster_4x4", list(cks.values())),
                  ("torus_4x4", tc.compile_many(
                      list(kernel_suite(torus).values()))),
                  ("morpher_8x8", tc.compile_many(
                      [big[k] for k in TOOLS_CHECK_8X8])))
        for arch, group in groups:
            for ck in group:
                diags = check_kernel(ck)
                if diags:
                    raise AssertionError(f"{arch}/{ck.name}: {diags[:3]}")
                per_kernel[f"{arch}/{ck.name}"] = {
                    "II": ck.II, "cache_key": ck.cache_key,
                    "diagnostics": diags}
        check_report = report_json(per_kernel)
        os.makedirs(os.path.join(out, "check"), exist_ok=True)
        with open(os.path.join(out, "check", "check_report.json"),
                  "w") as f:
            f.write(check_report)
        _tools_step("b", f"check_kernel on {len(per_kernel)} kernels "
                    "(the set on cluster_4x4 and its 4x4 torus, "
                    f"{len(TOOLS_CHECK_8X8)} on morpher_8x8; the last two "
                    "compiled here): no diagnostic; check_report.json "
                    "sha256 "
                    f"{hashlib.sha256(check_report.encode()).hexdigest()}",
                    time.perf_counter() - t0, card)
        t0 = time.perf_counter()
        gate = mutation_gate(list(cks.values()), device=dev)
        t1 = time.perf_counter()
        cpu_gate = mutation_gate(list(cks.values()), device="cpu")
        if gate.to_json_dict() != cpu_gate.to_json_dict():
            raise AssertionError("the mutation gate on the card differs "
                                 "from the CPU's")
        if gate.score < MIN_SCORE:
            raise AssertionError(f"mutation score {gate.score}")
        t2 = time.perf_counter()
        verdicts = []
        for cls, (layer, _rule) in sorted(CLASSES.items()):
            if layer != "config":
                continue
            for name in ("requant-int8", "dwconv"):
                ck = cks[name]
                made = mutate_one(ck, cls, seed=0, index=0)
                if made is None:
                    continue
                on_card = _probe_dead(ck, layer, made[0], device=dev)
                if on_card != _probe_dead(ck, layer, made[0],
                                          device="cpu"):
                    raise AssertionError(f"probe of {name}/{cls} on the "
                                         "card differs from the CPU's")
                verdicts.append(on_card)
        _tools_step("b", f"mutation gate on the card ({t1 - t0:.2f} s): "
                    f"score {gate.score:.3f} over {gate.total} mutants, "
                    f"{len(gate.live_misses)} live misses, the CPU's "
                    f"outcomes and score; dead-mutant probe on the card "
                    f"on {len(verdicts)} config mutants ({sum(verdicts)} "
                    "dead), the CPU's verdicts", time.perf_counter() - t2,
                    card)
        print(f"[tools] step b {json.dumps(bench_check_static(dev)[0])}")

        # (c) the verify gates, and a corrupt artifact refused statically
        for env, seeds in TOOLS_GATE_SEEDS.items():
            with mock.patch.dict(os.environ, {env: "1"}):
                t0 = time.perf_counter()
                for ck in cks.values():
                    ck.verify_batch(seeds, device=dev)
                dt = time.perf_counter() - t0
                _, wall, busy = _profiled(lambda: cks["GEMM"].verify_batch(
                    seeds[:64], device=dev))
            _tools_step("c", f"verify_batch of {len(cks)} kernels x "
                        f"{len(seeds)} seeds with {env}=1 (GEMM's at "
                        f"{len(seeds[:64])} seeds profiled)", dt, card,
                        (wall, busy))
        cfg, desc = mutate_one(cks["GEMM"], "store_window", seed=0, index=0)
        bad = dataclasses.replace(cks["GEMM"], cfg=cfg)
        no_sim = mock.Mock(side_effect=RuntimeError(
            "simulated a statically corrupt artifact"))
        with mock.patch.dict(os.environ, {"MORPHER_CHECK": "1"}), \
                mock.patch.multiple(simulator, simulate=no_sim,
                                    simulate_batch=no_sim,
                                    simulate_multi=no_sim):
            for call in (lambda: bad.verify_batch(range(4), device=dev),
                         lambda: verify_stacked([bad], range(4),
                                                device=dev)):
                try:
                    call()
                except AssertionError as e:
                    if "CFG-STORE-WINDOW" not in str(e):
                        raise
                else:
                    raise AssertionError("the check gate passed a "
                                         "corrupt artifact")
        print(f"[tools] step c a corrupt GEMM ({desc}) refused by "
              "MORPHER_CHECK=1 (CFG-STORE-WINDOW) before any simulation")

        # (d) the tiny sweep: cold through the fleet, warm, resumed
        dse = os.path.join(out, "dse")
        ckpt = os.path.join(dse, "checkpoint.json")

        def sweep(label, cache, **kw):
            t0 = time.perf_counter()
            sweep_tc = Toolchain(options=MapperOptions(ii_max=20),
                                 cache_dir=os.path.join(dse, cache))
            res = run_sweep(get_space("tiny"), toolchain=sweep_tc,
                            device=dev, **kw)
            dt = time.perf_counter() - t0
            write_artifacts(res, os.path.join(dse, label), space="tiny")
            _same_file(os.path.join(dse, label, "dse_frontier.json"),
                       TINY_FRONTIER, f"the {label} sweep's frontier")
            return sweep_tc, dt, res

        # The one cold sweep: its compiles fan out through the
        # supervised fleet (compile_many's default jobs), and it gives
        # bench_dse_sweep's rows (repro_torch.bench.dse_sweep_rows)
        cold_tc, dt, cold = sweep("cold", "cache", checkpoint=ckpt)
        report = cold_tc.last_fleet_report
        if report is None or report.sequential:
            raise AssertionError("the cold sweep's compiles did not fan "
                                 "out through the fleet")
        if not torch.cuda.is_initialized():
            raise AssertionError("CUDA is not initialised in the parent")
        states = run_fleet(_worker_cuda_state, list(range(4)),
                           FleetConfig(groups=2)).results
        if states is None or any(states):
            raise AssertionError(f"fleet workers' CUDA state: {states}")
        _tools_step("d", "cold tiny sweep (4 variants x 10 kernels, "
                    "compiled on the host through the supervised compile "
                    "fleet, CUDA initialised in the parent and not in the "
                    "workers of a 2-group fleet; verified on the card), "
                    "frontier byte-equal to the committed one", dt, card)
        rows = dse_sweep_rows(cold, dt)
        print(f"[tools] step d {json.dumps(rows[0])}")
        _, dt, _ = sweep("warm", "cache")
        _tools_step("d", "warm tiny sweep, frontier byte-equal", dt, card)
        with open(ckpt) as f:
            d = json.load(f)
        del d["variants"][get_space("tiny")[-1].name]
        with open(ckpt, "w") as f:
            json.dump(d, f)
        _, dt, _ = sweep("resumed", "cache", checkpoint=ckpt)
        _tools_step("d", "tiny sweep resumed from a checkpoint missing "
                    "its last variant, frontier byte-equal", dt, card)
        with open(os.path.join(os.path.dirname(TINY_FRONTIER),
                               "BENCH_dse_sweep.json")) as f:
            committed = {r["name"]: r for r in json.load(f)["rows"]}
        for row in rows[1:]:
            print(f"[tools] step d   {json.dumps(row)}")
            want = committed[row["name"]]
            got = dict(row, derived=dict(row["derived"], pareto=None))
            if got != dict(want, derived=dict(want["derived"],
                                              pareto=None)):
                raise AssertionError(f"{row['name']}: the committed "
                                     f"row is {want}")
        print("[tools] step d the rows equal the committed "
              "BENCH_dse_sweep.json's (but for its pareto flag: that "
              "file sweeps the small space)")

        # (e) the search evaluator's row, and a search card = CPU
        print(f"[tools] step e {json.dumps(bench_dse_search(dev)[0])}")
        cfg = SearchConfig(**TOOLS_SEARCH)
        suite = list(SEARCH_KERNELS)
        fronts = {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            sr = run_search(get_space("tiny"), cfg, suite=suite,
                            device=where, toolchain=Toolchain(
                                options=MapperOptions(ii_max=20),
                                cache_dir=os.path.join(dse, "cache")))
            dt = time.perf_counter() - t0
            path = os.path.join(dse, f"search_{torch.device(where).type}")
            write_artifacts(sr.evaluated, path, space="tiny",
                            bench_name="dse_search", extra={"search": {
                                "config": cfg.to_json_dict(),
                                "population": sr.population,
                                "history": sr.history}})
            with open(os.path.join(path, "dse_frontier.json"), "rb") as f:
                fronts[torch.device(where).type] = f.read()
            _tools_step("e", f"{cfg.algo} search on {torch.device(where)} "
                        f"({cfg.generations} generations of "
                        f"{cfg.population}, {len(sr.evaluated)} points "
                        f"evaluated, suite {len(suite)} kernels)", dt, card)
        if fronts["cuda"] != fronts["cpu"]:
            raise AssertionError("the search's frontier on the card "
                                 "differs from the CPU's")
        print("[tools] step e the search's dse_frontier.json on the card "
              "is the CPU's byte for byte")
    finally:
        reset_pool(kill=True)
    launched = {name: op.launches for name, op in five.items()
                if op.launches}
    if launched:
        raise AssertionError(f"the CGRA tools launched {launched}")
    print("[tools] the CGRA tools launched none of the five kernels")


def phase_table1(card: str) -> None:
    """The paper's Table I (benchmarks/table1_torch.py): mapped at full
    size on the host, each small-dims variant verified by simulation on
    the card, under the profiler (CUDA activity only: the simulator's
    device launches); no kernel of the five may launch.  Every row's
    nodes, II, MII, util and speedup must equal ``run(verify=False)`` on
    the host, which the CPU tests hold to the reference's
    ``table1.run()``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench import OPS
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmarks import table1_torch

    _zero_counts(*OPS.values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = table1_torch.run(verify=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and getattr(e, "self_device_time_total", 0) > 0]
    n_launch = sum(e.count for e in kernels)
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    launched = {name: op.launches for name, op in OPS.items()}
    if any(launched.values()):
        raise AssertionError(f"Table I launched kernels: {launched}")
    table1_torch.print_table(results)
    host = table1_torch.run(verify=False)
    for name, c in results.items():
        h = host[name]
        if c is None or h is None:
            raise AssertionError(f"Table I: {name} did not map")
        got = (c.nodes, c.II, c.mii, c.utilization, c.speedup)
        want = (h.nodes, h.II, h.mii, h.utilization, h.speedup)
        if got != want:
            raise AssertionError(f"Table I {name}: card run {got}, host "
                                 f"{want}")
    print(f"[table1] run(verify=True) on the card: {seconds:.1f} s, the "
          f"simulator's {n_launch} device kernel launches (busy "
          f"{busy_s:.3f} s), the five kernels' launches {launched}; every "
          f"row's nodes / II / MII / util / speedup = run(verify=False) on "
          f"the host [{card}]")
    for r in table1_torch.rows_of(results):
        print(f"[table1] {json.dumps(r)}")


def _train_batch(cfg, nb: int, T: int, device) -> dict:
    from repro_torch.data.pipeline import DataConfig, TokenSource
    src = TokenSource(DataConfig(seq_len=T, global_batch=nb,
                                 vocab=cfg.vocab, seed=TRAIN_DATA_SEED))
    return {k: torch.from_numpy(v).to(device)
            for k, v in src.batch_at(0).items()}


def _grads_held(label: str, got: dict, want: dict, rel: float) -> float:
    """Each gradient of ``got`` within ``rel`` of its ``want`` tensor's
    largest |g|, by name; returns the worst |got - want| / max|want|."""
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: gradients of other parameters")
    worst = 0.0
    for name, w in want.items():
        scale = w.abs().max().item()
        err = (got[name].float() - w.float()).abs().max().item()
        if err > rel * scale:
            raise AssertionError(f"{label}: gradient {name} differs by {err}"
                                 f" > {rel} x {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def _param_grads(params) -> dict:
    """Every parameter's ``.grad`` by name (zeros where the loss did not
    reach it, as the train step fills them)."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in params.named_parameters()}


def _train_wkv6_held(model, state, batch, card: str) -> None:
    """One training forward at the trained state, with every layer's wkv6
    call recorded (its r, k, v, w, u as the model made them, from a zero
    state): each output and end state held against wkv6_ref in float64 on
    the same inputs, allowed one bf16 rounding (WKV6_TOL's rtol) and, as
    atol, the float32 plain version's own largest error against float64
    on that call (at least WKV6_TOL's and WKV6_STATE_TOL's atol).  The
    model's decays lie near 1 (0.996-1), where outputs of order 1e-3 are
    sums of terms of order 1e3: float32 sums carry absolute errors of
    order 1e-3 there, the plain version's as much as the kernel's, so the
    exact recurrence is the yardstick, as for the near-1 prefill case.
    These launches are a check, not the training path's."""
    import repro_torch.models.rwkv6 as rwkv6_mod
    from repro_torch.kernels.wkv6.kernel import route
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.train.step import make_loss_fn

    kernel = rwkv6_mod.wkv6
    calls = []

    def recording(*args):
        out = kernel(*args)
        calls.append((args, out))
        return out

    before = dict(kernel.launches_by_route)
    with torch.no_grad(), mock.patch.object(rwkv6_mod, "wkv6", recording):
        make_loss_fn(model)(state.params, batch)
    torch.cuda.synchronize()
    ran = {r: n - before[r] for r, n in kernel.launches_by_route.items()}
    r0 = calls[0][0][0]
    want_route = route(*r0.shape)
    if len(calls) != model.cfg.n_layers or \
            ran[want_route] != model.cfg.n_layers:
        raise AssertionError(f"training forward: {len(calls)} wkv6 calls, "
                             f"launches {ran}")
    rtol, atol = WKV6_TOL[r0.dtype]
    worst = {"out": 0.0, "state": 0.0, "plain out": 0.0, "plain state": 0.0}
    w_min, w_max = 1.0, 0.0
    for i, (args, (out, st)) in enumerate(calls):
        with torch.no_grad():
            exact = wkv6_ref(*(a.double() for a in args[:5]))
            plain = wkv6_ref(*(a.float() for a in args[:4]), args[4])
        plain_err = [(p.double() - e).abs().max().item()
                     for p, e in zip(plain, exact)]
        got = [_held(f"training wkv6 layer {i} {part}", g, e.to(g.dtype),
                     (r, max(a, pe)))
               for part, g, e, r, a, pe in zip(
                   ("output", "state"), (out, st), exact,
                   (rtol, WKV6_STATE_TOL), (atol, WKV6_STATE_TOL),
                   plain_err)]
        for key, v in zip(("out", "state", "plain out", "plain state"),
                          got + plain_err):
            worst[key] = max(worst[key], v)
        w_min = min(w_min, args[3].float().min().item())
        w_max = max(w_max, args[3].float().max().item())
    print(f"[train] {model.cfg.name}: one training forward's {len(calls)} "
          f"wkv6 calls {tuple(r0.shape)} {str(r0.dtype)[6:]} (decays "
          f"{w_min:.4f}-{w_max:.4f}) on the {want_route} route, each held "
          f"against wkv6_ref in float64 on the inputs the model made: "
          f"max_abs_err {worst['out']:.3e} (the float32 plain version's "
          f"{worst['plain out']:.3e}; tol rtol {rtol:.2e}, atol the larger "
          f"of {atol:.0e} and the plain version's), state "
          f"{worst['state']:.3e} (plain {worst['plain state']:.3e}) "
          f"[{card}]")


def _train_split(model, state, batch, card: str) -> None:
    """Where an rwkv6 training step goes, on the host clock (each part
    ends in a synchronize): the forward (loss), the backward and, inside
    it, the wkv6 backward kernel's calls (each timed alone, between
    synchronizes); and from torch.profiler (CUDA activity only) the device
    time of the forward's wkv6 kernels over one forward and of the
    backward kernel's own kernels over one forward and backward."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.train.step import make_loss_fn

    loss_fn = make_loss_fn(model)
    launcher = wkv6_ops.wkv6_backward_cuda
    spent = []

    def timed_backward(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = launcher(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    for p in state.params.parameters():
        p.grad = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _m = loss_fn(state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with mock.patch.object(wkv6_ops, "wkv6_backward_cuda", timed_backward):
        loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad(), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss_fn(state.params, batch)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")]
    kernel_ms = sum(e.self_device_time_total for e in ev
                    if "wkv6" in e.key) / 1e3
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    for p in state.params.parameters():
        p.grad = None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss_fn(state.params, batch)[0].backward()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")]
    bwd_kernel_ms = sum(e.self_device_time_total for e in ev
                        if "wkv6_backward" in e.key) / 1e3
    states_ms = sum(e.self_device_time_total for e in ev
                    if "wkv6" in e.key and "backward" not in e.key) / 1e3 \
        - kernel_ms
    step_busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    for p in state.params.parameters():
        p.grad = None
    print(f"[train] {model.cfg.name} step split: forward "
          f"{1e3 * (t1 - t0):.1f} ms (device busy {busy_ms:.1f} ms, of it "
          f"the wkv6 chunked kernels {kernel_ms:.2f} ms in "
          f"{model.cfg.n_layers} launches), backward "
          f"{1e3 * (t2 - t1):.1f} ms, of it the wkv6 backward kernel "
          f"{1e3 * sum(spent):.1f} ms in {len(spent)} calls (host clock, "
          f"each between synchronizes); forward + backward device busy "
          f"{step_busy_ms:.1f} ms, of it the backward kernel's "
          f"{bwd_kernel_ms:.2f} ms and its chunk states' {states_ms:.2f} "
          f"ms [{card}]")


def _plain_ran(*args, **kwargs):
    raise AssertionError("a plain wkv6 version ran on the training path")


def _wkv6_train_launches(want: int) -> bool:
    """True unless wkv6 launched ``want`` times, all on chunked, and its
    backward ``want`` times, all on WKV6_BWD_TRAIN_ROUTE, since their
    counts were zeroed (rwkv6's training shapes)."""
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_backward
    return (wkv6.launches, wkv6.launches_by_route["chunked"],
            wkv6_backward.launches,
            wkv6_backward.launches_by_route[WKV6_BWD_TRAIN_ROUTE]) != \
        (want,) * 4


def phase_train(card: str) -> dict:
    """Trains each of TRAIN_RUNS at full size on the card through
    repro_torch.train (random bf16 weights from seed 0, one repeated
    batch from the seeded token stream): every loss finite and the last
    below the first (the reference's own bar), ms a step, tokens/s, peak
    GiB, the losses and grad_norm printed.  llama3.2-1b then takes one
    2-microbatch step from its state, whose loss must be within
    TRAIN_MICROBATCH_REL of the 1-microbatch loss there.  rwkv6-1.6b's
    forward must run wkv6 on the chunked route once a layer and step, and
    the Function's backward must give the recurrence a gradient (u);
    transformer training reaches no kernel.  rwkv6's steps run with the
    plain versions (``wkv6_ref``, ``wkv6_backward_ref``) patched to raise
    where kernels/wkv6/ops.py would call them, and its backward must
    launch the backward kernel exactly once a layer and step.  Then
    rwkv6's step is split (``_train_split``): the wkv6 kernels against
    the rest.  Returns the launches of the training runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_backward
    from repro_torch.models.zoo import build_model
    from repro_torch.train import optimizer as optim
    from repro_torch.train.step import (init_train_state, make_loss_fn,
                                        make_train_step)

    launches: dict = {}
    for arch, nb, T, n_steps, microbatch in TRAIN_RUNS:
        cfg = get_config(arch)
        model = build_model(cfg)
        t0 = time.perf_counter()
        state = init_train_state(
            model, torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(p.numel() for p in state.params.parameters())
        batch = _train_batch(cfg, nb, T, model.device)
        step = make_train_step(model, optim.OptConfig(**TRAIN_OPT))
        torch.cuda.synchronize()
        print(f"[train] {cfg.name}: {cfg.n_layers} layers, d "
              f"{cfg.d_model}, vocab {cfg.vocab}{_family_line(cfg)}, "
              f"{str(cfg.dtype)[6:]}, {n_params / 1e9:.3f} B "
              f"parameters, set up in {time.perf_counter() - t0:.1f} s; "
              f"B={nb} T={T}, {n_steps} steps of one batch, "
              f"OptConfig({TRAIN_OPT}), remat on [{card}]")
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(decode_attn, wkv6, wkv6_backward)
        losses, norms, times = [], [], []
        with mock.patch.object(wkv6_ops, "wkv6_ref", _plain_ran), \
                mock.patch.object(wkv6_ops, "wkv6_backward_ref", _plain_ran):
            for _ in range(n_steps):
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
                times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = {**_counts(decode_attn), **_counts(wkv6),
                  **_counts(wkv6_backward)}
        _add_counts(launches, counts)
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"{arch}: a loss or norm is not finite: "
                                 f"{losses} {norms}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{arch}: loss {losses[0]} -> "
                                 f"{losses[-1]} did not fall")
        if cfg.family == "ssm":
            want = cfg.n_layers * n_steps
            if _wkv6_train_launches(want) or decode_attn.launches:
                raise AssertionError(f"{arch}: launches {counts}, want "
                                     f"wkv6 {want} on chunked and "
                                     f"wkv6_backward {want} on "
                                     f"{WKV6_BWD_TRAIN_ROUTE}, no "
                                     f"decode_attn")
            u_grad = state.params.layers[0].u.grad
            if u_grad is None or not bool(u_grad.abs().max() > 0):
                raise AssertionError(f"{arch}: no gradient through wkv6")
        elif decode_attn.launches or wkv6.launches or wkv6_backward.launches:
            raise AssertionError(f"{arch}: training launched {counts}")
        steady = times[1:]
        ms = 1e3 * sum(steady) / len(steady)
        print(f"[train] {arch}: losses {[round(x, 4) for x in losses]}, "
              f"grad_norm {[round(x, 4) for x in norms]}; step "
              f"{1e3 * times[0]:.1f} ms first, {ms:.1f} ms after "
              f"({nb * T / ms * 1e3:.0f} tokens/s); peak "
              f"{peak:.2f} GiB allocated; launches {counts} [{card}]")
        if microbatch:
            with torch.no_grad():
                one, _ = make_loss_fn(model)(state.params, batch)
            one = float(one)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met2 = make_train_step(
                model, optim.OptConfig(**TRAIN_OPT), 2)(state, batch)
            two = float(met2["loss"])
            rel = abs(two - one) / abs(one)
            print(f"[train] {arch}: 2 microbatches from the state after "
                  f"step {n_steps}: loss {two:.5f} against the "
                  f"1-microbatch loss {one:.5f} (rel {rel:.2e}, tol "
                  f"{TRAIN_MICROBATCH_REL}), "
                  f"{1e3 * (time.perf_counter() - t0):.1f} ms, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                  f"[{card}]")
            if not (math.isfinite(two) and rel <= TRAIN_MICROBATCH_REL):
                raise AssertionError(f"{arch}: microbatched loss {two}, "
                                     f"unbatched {one}")
        if cfg.family == "ssm":
            _train_wkv6_held(model, state, batch, card)
            _train_split(model, state, batch, card)
        _counted_step(model, state, batch, ms, card)
        del state, step, model, batch
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _counted_step(model, state, batch, ms: float, card: str) -> None:
    """One more training step counted by repro_torch.roofline.hlo's
    TraceCounter on the card's own tensors (each op's flops, and each
    kernel's by its formula): the achieved share of the card's 989e12
    bf16 FLOP/s at the measured ``ms`` a step."""
    from repro_torch.roofline.hlo import TraceCounter, cost_terms
    from repro_torch.train import optimizer as optim
    from repro_torch.train.step import make_train_step

    step = make_train_step(model, optim.OptConfig(**TRAIN_OPT))
    with TraceCounter() as trace:
        step(state, batch)
    torch.cuda.synchronize()
    cost = cost_terms(trace)
    achieved = cost["flops"] / (ms * 1e-3)
    print(f"[train] {model.cfg.name}: one step counted by cost_terms: "
          f"{cost['flops'] / 1e12:.3f} TFLOP, "
          f"{cost['bytes_accessed'] / 1e9:.2f} GB accessed, "
          f"{cost['transcendentals'] / 1e9:.3f} G "
          f"transcendentals; at the measured {ms:.1f} ms a step "
          f"{achieved / 1e12:.2f} TFLOP/s = {achieved / 989e12:.4f} of "
          f"989 TFLOP/s (bf16 dense peak), kernels {trace.kernels} "
          f"[{card}]")


def _float32_model(arch: str):
    """``arch`` at full size in float32 on the card: (model, params with
    gradients on from seed 0, its training batch from phase_train's
    stream)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.zoo import build_model

    (nb, T), = [r[1:3] for r in TRAIN_RUNS if r[0] == arch]
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    params.requires_grad_(True)
    return model, params, _train_batch(cfg, nb, T, model.device)


def _loss_held(label: str, got: float, want: float) -> float:
    rel = abs(got - want) / abs(want)
    if not (math.isfinite(got) and rel <= TRAIN_GRAD_REL):
        raise AssertionError(f"{label}: loss {got}, want {want}")
    return rel


def phase_train_grads(card: str) -> None:
    """The training runs' gradients at full size in float32 (TF32 off),
    random weights from seed 0, phase_train's batches.  llama3.2-1b: one
    make_train_step with 2 microbatches against one loss.backward over
    the whole batch, loss and every accumulated gradient within
    TRAIN_GRAD_REL.  rwkv6-1.6b: one loss.backward with wkv6 on the
    kernels (the autograd Function: the forward on the chunked route and
    the backward kernel, once a layer each) against the same with
    wkv6_ref in its place (autograd through the plain recurrence): loss
    and every gradient within TRAIN_GRAD_REL; and each of the backward
    kernel's calls, recorded with the model's own inputs and incoming
    gradients, held to float64 autograd through wkv6_ref by
    _wkv6_grads_held.  These launches are checks, not the training
    path's."""
    import repro_torch.models.rwkv6 as rwkv6_mod
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_backward
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.train import optimizer as optim
    from repro_torch.train.step import (TrainState, make_loss_fn,
                                        make_train_step)

    def backward(model, params, batch):
        for p in params.parameters():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = make_loss_fn(model)(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.item(), dict(_param_grads(params)),
                time.perf_counter() - t0)

    arch = TRAIN_RUNS[0][0]
    model, params, batch = _float32_model(arch)
    one, g_one, one_s = backward(model, params, batch)
    state = TrainState(params, optim.init(dict(params.named_parameters())))
    t0 = time.perf_counter()
    state, met = make_train_step(model, optim.OptConfig(**TRAIN_OPT), 2)(
        state, batch)
    two = float(met["loss"])
    two_s = time.perf_counter() - t0
    rel = _loss_held(f"float32 {arch} 2 microbatches", two, one)
    worst = _grads_held(f"float32 {arch} 2 microbatches",
                        _param_grads(state.params), g_one, TRAIN_GRAD_REL)
    print(f"[train] {arch} float32: 2 microbatches' loss {two:.6f} against "
          f"the whole batch's {one:.6f} (rel {rel:.2e}); {len(g_one)} "
          f"accumulated gradients against the whole batch's, worst |diff| "
          f"/ max|g| {worst:.2e} (tol {TRAIN_GRAD_REL}); {one_s:.2f} s "
          f"forward + backward, {two_s:.2f} s the 2-microbatch step; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    del model, params, batch, state, g_one
    gc.collect()
    torch.cuda.empty_cache()

    arch = TRAIN_RUNS[1][0]
    model, params, batch = _float32_model(arch)
    n_layers = model.cfg.n_layers
    calls = []
    launcher = wkv6_ops.wkv6_backward_cuda

    def recording(*args):
        out = launcher(*args)
        calls.append((args, out[:6]))
        return out

    _zero_counts(wkv6, wkv6_backward)
    with mock.patch.object(wkv6_ops, "wkv6_backward_cuda", recording):
        k_loss, k_grads, k_s = backward(model, params, batch)
    if _wkv6_train_launches(n_layers):
        raise AssertionError(f"float32 {arch}: launches "
                             f"{_counts(wkv6)} {_counts(wkv6_backward)}, "
                             f"want {n_layers} each, on chunked and "
                             f"{WKV6_BWD_TRAIN_ROUTE}")
    with mock.patch.object(rwkv6_mod, "wkv6", wkv6_ref):
        p_loss, p_grads, p_s = backward(model, params, batch)
    rel = _loss_held(f"float32 {arch}, kernel - plain wkv6", k_loss, p_loss)
    worst = _grads_held(f"float32 {arch}, kernel - plain wkv6", k_grads,
                        p_grads, TRAIN_GRAD_REL)
    print(f"[train] {arch} float32: loss with the wkv6 kernels {k_loss:.6f},"
          f" with wkv6_ref {p_loss:.6f} (rel {rel:.2e}); {len(p_grads)} "
          f"gradients, worst |kernel - plain| / max|g| {worst:.2e} (tol "
          f"{TRAIN_GRAD_REL}); forward + backward {k_s:.2f} s with the "
          f"kernels, {p_s:.2f} s plain [{card}]")
    del p_grads, k_grads
    held = [_wkv6_grads_held(f"float32 {arch} layer {i}'s wkv6 backward",
                             grads, args)
            for i, (args, grads) in enumerate(calls)]
    r0 = calls[0][0][0]
    print(f"[train] {arch} float32: the backward kernel's {len(calls)} "
          f"calls {tuple(r0.shape)}, on the model's own inputs and "
          f"incoming gradients, each held to float64 autograd through "
          f"wkv6_ref: worst |err| / max|g| "
          f"{max(h['err'] for h in held):.3e} (the plain backward's "
          f"{max(h['plain'] for h in held):.3e}; tol the larger of "
          f"{WKV6_GRAD_REL} and the plain's), max_abs_err "
          f"{max(h['abs'] for h in held):.3e} [{card}]")


def phase_train_card_cpu(card: str) -> None:
    """Training card against CPU: each of TRAIN_CARD_CPU at reduced() size
    in float32 (TF32 off), one step from the CPU's parameters copied to
    the card and the same batch: loss and grad_norm within
    TRAIN_CARD_CPU_REL relative, every gradient within it of its tensor's
    largest |g|, every MoE routing's idx and keep equal.  Then the wkv6
    autograd Function's gradients of r, k, v, w, u and state0 against
    autograd through wkv6_ref, float32, at WKV6_GRAD_CASES (T 16 and 128,
    both forward routes; D 64 and 80), from a nonzero state with a state
    gradient: its backward is the backward kernel, so this holds the
    kernel (one launch a call) and the Function's plumbing (argument
    order, the gradients it returns) to the plain recurrence's
    gradients."""
    import copy

    import repro_torch.models.moe as moe
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_backward
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.models.zoo import build_model
    from repro_torch.train import optimizer as optim
    from repro_torch.train.step import TrainState, make_train_step

    route = moe.moe_route
    for arch in TRAIN_CARD_CPU:
        cfg = get_config(arch).reduced()
        rng = np.random.default_rng(0)
        labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
        if cfg.input_mode == "tokens":
            inputs = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
        else:
            inputs = torch.from_numpy(rng.normal(size=(2, 8, cfg.d_model))
                                      .astype(np.float32))
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
        runs = {}
        for dev in ("cuda", "cpu"):
            model = cpu_model if dev == "cpu" else build_model(cfg)
            params = copy.deepcopy(cpu_params).to(model.device)
            params.requires_grad_(True)
            state = TrainState(params, optim.init(
                dict(params.named_parameters())))
            seen = []

            def recording(router, xf, k, C):
                out = route(router, xf, k, C)
                seen.append((out[2].cpu(), out[3].cpu()))
                return out

            with mock.patch.object(moe, "moe_route", recording):
                state, met = make_train_step(
                    model, optim.OptConfig(**TRAIN_OPT))(
                    state, {"inputs": inputs.to(model.device),
                            "labels": labels.to(model.device)})
            runs[dev] = ({k: float(v) for k, v in met.items()},
                         {n: g.cpu() for n, g in
                          _param_grads(state.params).items()}, seen)
        (cm, cg, cr), (pm, pg, pr) = runs["cuda"], runs["cpu"]
        for key in ("loss", "grad_norm"):
            if abs(cm[key] - pm[key]) > TRAIN_CARD_CPU_REL * abs(pm[key]):
                raise AssertionError(f"{arch}: {key} card {cm[key]}, CPU "
                                     f"{pm[key]}")
        worst = _grads_held(f"{arch} card - CPU", cg, pg, TRAIN_CARD_CPU_REL)
        if len(cr) != len(pr) or any(
                not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
                for a, b in zip(cr, pr)):
            raise AssertionError(f"{arch}: MoE routing differs card to CPU")
        print(f"[train_card_cpu] {cfg.name} reduced: loss card "
              f"{cm['loss']:.6f} CPU {pm['loss']:.6f}, grad_norm card "
              f"{cm['grad_norm']:.6f} CPU {pm['grad_norm']:.6f}; "
              f"{len(pg)} gradients, worst |card - CPU| / max|g| "
              f"{worst:.2e} (tol {TRAIN_CARD_CPU_REL}); {len(pr)} MoE "
              f"routings equal [{card}]")
    gen = torch.Generator(device="cuda").manual_seed(83)
    for d, T in WKV6_GRAD_CASES:
        shape = (2, T, 2, d)
        ins = [0.5 * torch.randn(shape, generator=gen, device="cuda"),
               0.5 * torch.randn(shape, generator=gen, device="cuda"),
               torch.randn(shape, generator=gen, device="cuda"),
               0.9 + 0.099 * torch.rand(shape, generator=gen, device="cuda"),
               0.3 * torch.randn((2, d), generator=gen, device="cuda"),
               torch.randn((2, 2, d, d), generator=gen, device="cuda")]
        ins = [t.requires_grad_() for t in ins]
        g_out = torch.randn(shape, generator=gen, device="cuda")
        g_state = torch.randn((2, 2, d, d), generator=gen, device="cuda")

        def grads(fn):
            out, st = fn(*ins)
            return torch.autograd.grad([out, st], ins, [g_out, g_state])

        before = wkv6.launches, wkv6_backward.launches
        got = grads(wkv6)
        torch.cuda.synchronize()
        if (wkv6.launches, wkv6_backward.launches) != \
                (before[0] + 1, before[1] + 1):
            raise AssertionError("the wkv6 Function did not launch its "
                                 "forward and backward kernels once each")
        err = max(_held(f"wkv6 gradient D={d} T={T} of input {i}", g, w,
                        (1e-4, 1e-4))
                  for i, (g, w) in enumerate(zip(got, grads(wkv6_ref))))
        print(f"[train_card_cpu] wkv6 Function D={d} T={T} (the backward "
              f"kernel): gradients of r, k, v, w, u, state0 against "
              f"autograd through wkv6_ref, max_abs_err {err:.3e} (tol "
              f"1e-4) [{card}]")


def _train_lm(args, ckpt_dir: str, cut_at=None):
    """examples/train_lm_torch.py ``args`` as a subprocess under
    deterministic algorithms (CKPT_ENV and torch.use_deterministic_
    algorithms, set by this launcher: the example has no flag for them).
    With ``cut_at`` the process is killed once it has logged that step
    and the checkpoint before it is on disk.  Returns (stdout lines,
    seconds)."""
    script = os.path.join(ROOT, "examples", "train_lm_torch.py")
    code = ("import runpy, sys, torch; "
            "torch.use_deterministic_algorithms(True); "
            f"sys.argv = {[script, *args, '--ckpt-dir', ckpt_dir]!r}; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    env = dict(os.environ, **CKPT_ENV,
               PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    err_path = ckpt_dir.rstrip(os.sep) + ".stderr"
    err_file = open(err_path, "w")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=err_file,
                            text=True)
    _CHILDREN.append(proc)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if cut_at is not None and line.startswith(f"step {cut_at:4d}"):
                before = (cut_at // 50) * 50
                deadline = time.time() + 120
                while not os.path.isdir(os.path.join(ckpt_dir,
                                                     f"step_{before}")):
                    if time.time() > deadline:
                        raise AssertionError(f"no checkpoint {before}")
                    time.sleep(0.05)
                proc.kill()
                break
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    proc.stdout.close()
    err_file.close()
    with open(err_path) as f:
        err = f.read()
    if cut_at is None and proc.returncode != 0:
        raise AssertionError(f"train_lm_torch {args} failed: {err[-3000:]}")
    return lines, time.perf_counter() - t0


def _arrays(ckpt_dir: str, step: int) -> dict:
    with np.load(os.path.join(ckpt_dir, f"step_{step}", "shard_0.npz")) \
            as z:
        return {k: z[k].tobytes() for k in z.files}


def _dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
               os.walk(path) for f in fs) / 1e9


def _checkpoint_train_lm(tmp: str, card: str) -> None:
    """(a) of phase_checkpoint: uninterrupted, cut, resumed; the resumed
    run's logged lines (the seconds column dropped) and its final
    checkpoint's arrays equal the uninterrupted run's."""
    def logged(lines):
        return [ln.rsplit("(", 1)[0] for ln in lines
                if ln.startswith("step ")]

    import concurrent.futures
    # The uninterrupted run goes alongside the cut and resumed ones: each
    # process is bound by its host thread's launches (PERF.md, D10), and
    # the card has room for two.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        whole_run = pool.submit(_train_lm, [], os.path.join(tmp, "whole"))
        cut_dir = os.path.join(tmp, "cut")
        cut, t_cut = _train_lm([], cut_dir, cut_at=CKPT_CUT)
        resumed, t_res = _train_lm([], cut_dir)
        whole, t_whole = whole_run.result()
    start = [ln for ln in resumed if ln.startswith("resuming from")]
    tail = logged(resumed)
    if not start or not tail or tail != logged(whole)[-len(tail):]:
        raise AssertionError(f"resumed run's log {resumed} is not the "
                             f"uninterrupted run's {whole}")
    a, b = _arrays(cut_dir, CKPT_STEPS), \
        _arrays(os.path.join(tmp, "whole"), CKPT_STEPS)
    if a.keys() != b.keys() or any(a[k] != b[k] for k in a):
        raise AssertionError("resumed final checkpoint differs from the "
                             "uninterrupted run's")
    print(f"[checkpoint] train_lm_torch ({whole[0]}), B 8 x T 128, "
          f"{CKPT_STEPS} steps, a checkpoint every 50, deterministic "
          f"algorithms: uninterrupted {t_whole:.1f} s ({whole[-1]}), "
          f"alongside: cut "
          f"after logging step {CKPT_CUT} at {t_cut:.1f} s; resumed "
          f"({start[0]}) {t_res:.1f} s: {len(tail)} logged lines and the "
          f"final checkpoint's {len(a)} arrays "
          f"({_dir_gb(os.path.join(cut_dir, f'step_{CKPT_STEPS}')):.2f} GB)"
          f" equal the uninterrupted run's bit for bit [{card}]")


def _checkpoint_rwkv6(tmp: str, card: str) -> dict:
    """(b) of phase_checkpoint: rwkv6-1.6b's training state through an
    async save under a step and a restore into a fresh state.  Returns
    the launches of its four steps (wkv6 on chunked and its backward
    kernels on WKV6_BWD_TRAIN_ROUTE once a layer and step each, no
    decode_attn)."""
    import dataclasses

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_backward
    from repro_torch.models.zoo import build_model
    from repro_torch.train import optimizer as optim
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("rwkv6-1.6b"),
                              n_layers=CKPT_RWKV_LAYERS)
    model = build_model(cfg)
    state = init_train_state(model,
                             torch.Generator(device="cuda").manual_seed(0))
    batch = _train_batch(cfg, 2, 256, model.device)
    step = make_train_step(model, optim.OptConfig(**TRAIN_OPT))
    n_params = sum(p.numel() for p in state.params.parameters())
    _zero_counts(decode_attn, wkv6, wkv6_backward)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    def words(st) -> dict:
        out = {f"p.{n}": p.detach().clone()
               for n, p in st.params.named_parameters()}
        for key in ("master", "m", "v"):
            out.update({f"{key}.{n}": t.clone()
                        for n, t in getattr(st.opt, key).items()})
        return out

    snap, snap_step = words(state), state.opt.step
    ck = Checkpointer(os.path.join(tmp, "rwkv6"), keep=1)
    t0 = time.perf_counter()
    ck.save(2, state)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, live = step(state, batch)         # the write runs meanwhile
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    live_grads = {n: g.clone() for n, g in _param_grads(state.params)
                  .items()}
    t0 = time.perf_counter()
    ck.wait()
    t_wait = time.perf_counter() - t0
    gb = _dir_gb(os.path.join(tmp, "rwkv6", "step_2"))
    del state
    gc.collect()
    fresh = init_train_state(model,
                             torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ck.restore(2, fresh)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    got = words(restored)
    if restored.opt.step != snap_step or got.keys() != snap.keys():
        raise AssertionError("restored state's structure differs")
    for name, want in snap.items():
        g = got[name]
        if g.dtype != want.dtype or not torch.equal(
                g.view(torch.int16 if g.element_size() == 2 else
                       torch.int32), want.view(torch.int16 if
                                               want.element_size() == 2
                                               else torch.int32)):
            raise AssertionError(f"restored {name} differs from the "
                                 f"snapshot")
    del snap, got
    restored, again = step(restored, batch)
    if float(again["loss"]) != float(live["loss"]):
        raise AssertionError(f"loss from the restored state "
                             f"{float(again['loss'])!r} != the live state's "
                             f"{float(live['loss'])!r}")
    worst = _grads_held("rwkv6 step from the restored state",
                        _param_grads(restored.params), live_grads,
                        TRAIN_GRAD_REL)
    counts = {**_counts(decode_attn), **_counts(wkv6),
              **_counts(wkv6_backward)}
    want = 4 * cfg.n_layers
    if _wkv6_train_launches(want) or decode_attn.launches:
        raise AssertionError(f"launches {counts}, want wkv6 and "
                             f"wkv6_backward {want} each, on chunked and "
                             f"{WKV6_BWD_TRAIN_ROUTE}, no decode_attn")
    print(f"[checkpoint] rwkv6-1.6b at full width, {cfg.n_layers} of 24 "
          f"layers ({n_params / 1e9:.3f} B parameters), B 2 x T 256, wkv6 "
          f"and its backward kernels once a layer and step: save "
          f"{t_save:.2f} s "
          f"(snapshot to host), the third step under the write "
          f"{1e3 * t_step:.1f} ms (the second alone {1e3 * times[1]:.1f} "
          f"ms), wait {t_wait:.2f} s, {gb:.2f} GB written "
          f"({gb / (t_save + t_step + t_wait):.2f} GB/s from save to "
          f"written); restore {t_restore:.2f} s ({gb / t_restore:.2f} "
          f"GB/s): every tensor equal to the snapshot word for word, the "
          f"next step's loss {float(again['loss'])!r} = the live state's "
          f"bit for bit, its gradients within {TRAIN_GRAD_REL} of max|g| "
          f"(worst {worst:.2e}); launches {counts} [{card}]")
    return counts


def phase_checkpoint(card: str) -> dict:
    """(a) examples/train_lm_torch.py at its default size, uninterrupted,
    cut and resumed; (b) rwkv6-1.6b's state through an async save and a
    restore.  Both write under a temporary directory, deleted at the
    end.  Returns (b)'s launches (a training path: wkv6 on chunked)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        _checkpoint_train_lm(tmp, card)
        return _checkpoint_rwkv6(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _start(cmd, tmp: str, name: str, env=None) -> dict:
    """``cmd`` as a child process of this run, its output to files under
    ``tmp`` (read once it ends: a pipe nobody reads could fill and stall
    it); stopped by _stop_children if the run fails first."""
    out = os.path.join(tmp, f"{name}.out")
    err = os.path.join(tmp, f"{name}.err")
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(cmd, stdout=fo, stderr=fe, cwd=ROOT,
                                env=env)
    _CHILDREN.append(proc)
    return {"proc": proc, "out": out, "err": err,
            "t0": time.perf_counter()}


def _finish(child: dict, timeout: float):
    """(exit code, stdout, stderr, seconds since the start) of a child
    started by _start, once it has ended."""
    proc = child["proc"]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(child["out"]) as fo, open(child["err"]) as fe:
        out, err = fo.read(), fe.read()
    return proc.returncode, out, err, time.perf_counter() - child["t0"]


def _stop_children() -> None:
    """Kill every child process this run started that is still running,
    and the CGRA compile pool's workers."""
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if "repro_torch.core.pool" in sys.modules:
        sys.modules["repro_torch.core.pool"].reset_pool(kill=True)


def start_dryrun(tmp: str) -> list:
    """phase_dryrun's three command lines, started as subprocesses to run
    alongside phase_checkpoint (they trace fake tensors on the host)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    arch, shape = DRYRUN_CELL
    runs = (("dryrun", f"dryrun {arch} {shape}",
             ["repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
              "--out", os.path.join(tmp, "dryrun.json")]),
            ("roofline", "roofline " + " ".join(ROOFLINE_CELLS),
             ["repro_torch.roofline.run", "--cells", *ROOFLINE_CELLS,
              "--dryrun-json", os.path.join(tmp, "none.json"), "--out",
              os.path.join(tmp, "roofline.json")]))
    runs += (("dryrun_c15", "dryrun " + " ".join(DRYRUN_C15_CELLS) +
              f" at {DRYRUN_C15_LAYERS} layers",
              ["repro_torch.launch.dryrun", "--cells", *DRYRUN_C15_CELLS,
               "--num-layers", str(DRYRUN_C15_LAYERS), "--out",
               os.path.join(tmp, "dryrun_c15.json")]),)
    return [(label, _start([sys.executable, "-m", *args], tmp, name, env))
            for name, label, args in runs]


def phase_dryrun(runs: list, card: str) -> None:
    """The launch dry run of one decode cell, the roofline of two train
    cells, and the dry run of C15's cells cut to DRYRUN_C15_LAYERS layers
    on the fake 16x16 mesh of fake tensors of the card's type, as their
    command lines run them (started by start_dryrun): each exits 0 and
    every JSON record's status is ``ok``."""
    for label, child in runs:
        rc, out, err, seconds = _finish(child, timeout=600)
        recs = [json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{")]
        if rc != 0 or not recs or \
                any(r.get("status") != "ok" for r in recs):
            raise AssertionError(f"{label}: exit {rc}, records {recs}: "
                                 f"{err[-3000:]}")
        for r in recs:
            print(f"[dryrun] {label}: {json.dumps(r)}")
        print(f"[dryrun] {label}: exit 0, {len(recs)} records ok, ended "
              f"within {seconds:.1f} s of its start, beside "
              f"phase_checkpoint [{card}]")


def start_cgra_process(tmp: str) -> dict:
    """phase_cgra and phase_cgra_tools in a second process on the same
    card (this script with CGRA_PROCESS_FLAG), to run alongside the
    serving, training and checkpoint phases: the CGRA flow is bound by
    its host thread and its compile pool, and leaves the card idle for
    most of its time (idle shares in its lines)."""
    return _start([sys.executable, os.path.abspath(__file__),
                   CGRA_PROCESS_FLAG], tmp, "cgra")


def finish_cgra_process(child: dict) -> None:
    """Wait for the CGRA process, print its lines, fail unless it
    exited 0."""
    rc, out, err, seconds = _finish(child, timeout=WATCHDOG_S)
    sys.stdout.write(out)
    if rc != 0:
        raise AssertionError(f"the CGRA process exited {rc}: "
                             f"{err[-3000:]}")
    print(f"[env] the CGRA process: exit 0, ended within {seconds:.1f} s "
          "of its start")


def cgra_process_main() -> int:
    """The body of the CGRA process: phase_cgra, then phase_cgra_tools
    over its compiled set; prints their lines and each one's seconds."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cks = phase_cgra(card)
    t1 = time.perf_counter()
    print(f"[env] phase_cgra: {t1 - t0:.1f} s")
    phase_cgra_tools(card, cks)
    print(f"[env] phase_cgra_tools: {time.perf_counter() - t1:.1f} s")
    return 0


def _watchdog() -> None:
    """After WATCHDOG_S: every thread's stack and the CGRA process's lines
    so far to stderr, every child stopped, exit 1 (a hang shows where it
    is instead of running into a caller's limit)."""
    def fire():
        print(f"[env] chip_smoke still running after {WATCHDOG_S} s; "
              "every thread's stack:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        for proc in _CHILDREN:
            state = "running" if proc.poll() is None else proc.returncode
            print(f"[env] child {str(proc.args)[:160]}: {state}",
                  file=sys.stderr, flush=True)
        _stop_children()
        os._exit(1)

    timer = threading.Timer(WATCHDOG_S, fire)
    timer.daemon = True
    timer.start()


def main() -> int:
    if sys.argv[1:] == [CGRA_PROCESS_FLAG]:
        return cgra_process_main()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)
    _watchdog()
    card = card_line()
    t_start = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = time.perf_counter()

    def lap(label: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        line = f"[env] {label}: {now - clock:.1f} s"
        print(line)
        print(f"{line} (at {now - t_start:.1f} s)", file=sys.stderr,
              flush=True)
        clock = now

    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_build()
        lap("build")
        entries = [phase_decode_attn_check(card), *phase_wkv6_check(card)]
        lap("decode_attn and wkv6 checks")
        table1, launches = phase_table1_kernels(card, entries)
        entries += table1
        lap("Table-I kernels and the kernel path")
        gc.collect()
        torch.cuda.empty_cache()
        phase_c16(card, entries)
        lap("phase_c16")
        cgra = start_cgra_process(tmp)
        _add_counts(launches, phase_serve_cgra(card))
        gc.collect()
        torch.cuda.empty_cache()
        lap("phase_serve_cgra (the CGRA process alongside from here)")
        for arch, n_layers in SERVED:
            _add_counts(launches, phase_serve(card, arch, n_layers))
            gc.collect()
            torch.cuda.empty_cache()
            lap(f"phase_serve {arch}")
        for arch in EMBEDDED:
            _add_counts(launches, phase_embedded(card, arch))
            gc.collect()
            torch.cuda.empty_cache()
            lap(f"phase_embedded {arch}")
        phase_card_cpu(card)
        lap("phase_card_cpu")
        phase_table1(card)
        lap("phase_table1")
        train_launches = phase_train(card)
        gc.collect()
        torch.cuda.empty_cache()
        lap("phase_train")
        phase_train_grads(card)
        gc.collect()
        torch.cuda.empty_cache()
        lap("phase_train_grads")
        phase_train_card_cpu(card)
        lap("phase_train_card_cpu")
        dryruns = start_dryrun(tmp)
        _add_counts(train_launches, phase_checkpoint(card))
        gc.collect()
        torch.cuda.empty_cache()
        lap("phase_checkpoint (the dry runs alongside)")
        phase_dryrun(dryruns, card)
        lap("phase_dryrun (the rest of its time)")
        finish_cgra_process(cgra)
        lap("waiting for the CGRA process")
    finally:
        _stop_children()
        shutil.rmtree(tmp, ignore_errors=True)
    for entry in entries:     # a routed kernel's entry: its route's count
        counts = train_launches if entry.get("path") == "train" \
            else launches
        key = f"{entry['name']}:{entry.get('kernel_route')}"
        entry["launches"] = counts.get(key, counts[entry["name"]])
    print(f"[env] chip_smoke took {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
