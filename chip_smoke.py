#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

1. Builds the port's CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a)
   and prints the build time and what ptxas reports.
2. Holds each kernel against its plain PyTorch version on the card at the
   serving paths' shapes, and times kernel, plain version and, where one
   exists, the closest single PyTorch call (a yardstick only; the port
   never calls it): decode attention at llama3.2-1b's decode shape (and
   rows of length 0, and the GQA groups 3, 5 and 48 of llama3.2-3b,
   llama4-maverick and granite-34b, checked), the WKV6 recurrence at
   rwkv6-1.6b's decode and prefill shapes (prefill on the chunked route,
   with decays near 0 and near 1 too, the step kernel it replaced timed
   on the same inputs; both routes timed around the route's threshold).
3. The Table-I kernels (phase_table1_kernels): gemm_os at llama3.2-1b's
   ffn_in GEMM site (prefill in bf16 and float32, decode in bf16, the
   fused bias+silu and bias+gelu epilogues in both types, a ragged
   shape, both tile grids bit for bit), conv2d_os at the paper's Table-I
   CONV as a batch of 32 edge images (bf16, float32) and as Listing 2
   writes it (one input channel), and qgemm_int8 at the ffn_in site, bit
   for bit; each held against its plain version and timed like the
   others.  Then holds each row of the kernel path's entry point,
   repro_torch.bench.bench_kernel_micro, on the row's own inputs against
   the plain version, drives the entry point, and checks that each
   kernel launched exactly as often as its rows called it, on the routes
   the rule gives them.
   Every kernel has two routes, chosen by its kernel.route (tensor_core
   and simt; wkv6 step and chunked); every case of steps 2 and 3 prints
   the route it ran on, from the ops' per-route launch counts, and fails
   unless it is the one the rule gives (bf16, and int8, at the full-size
   shapes on the tensor cores; wkv6 prefill on chunked).  Where a case
   runs on the redesigned route, the kernel that route replaced is held
   and timed on the same inputs (prev_ms).  torch._int_mm is timed in
   every layout of b it accepts.
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
   before anything simulates; (d) the tiny design-space sweep cold,
   warm, resumed from its checkpoint and through a 2-worker compile fleet
   (whose workers must not have initialised CUDA), each
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
   and every prefill (decode on the step route, each prefill on the route
   its length gives); and neither kernel on deepseek-v3's MLA path.  Then
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
10. Prints each phase's seconds, the kernels as one JSON line (launches:
   the sums over the serving paths of steps 6-8, and the kernel path),
   the card's name and power limit, and as its last line
   {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
Any failure exits nonzero; without a card it exits 1 before doing work.
"""
from __future__ import annotations

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
TINY_FRONTIER = os.path.join(ROOT, "benchmarks", "results", "after",
                             "dse_frontier_tiny.json")


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


def decode_attn_bound(lengths, dtype):
    """(bound_ms, bound_by): K/V rows up to each length read once, q read,
    output written; 4 flops per (query head, cached element)."""
    n = int(sum(lengths))
    nbytes = (2 * HKV * n * D + 2 * B * H * D) * dtype.itemsize + 4 * B
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


def _simt_decode_attn(q, k, v, lens):
    """decode_attn on the SIMT route's C entry, whatever the rule would
    choose: in bfloat16 the kernel the tensor-core route replaced, run here
    as the redesign's "before".  q (B, H, D), k/v (B, Hkv, S, D)."""
    from repro_torch.kernels.decode_attn import kernel as dk
    Bq, Hq, Dq = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    splits, chunk = dk.plan("simt", Bq, Hkv, G, S, Dq, q.dtype,
                            dk._sm_count(q.device.index))
    out = torch.empty_like(q)
    n = Bq * Hkv * splits * G
    part = torch.empty(n * (Dq + 2), dtype=torch.float32, device=q.device)
    base = part.data_ptr()
    err = dk._entries()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           lens.data_ptr(), out.data_ptr(), base, base + 4 * n,
                           base + 8 * n, Bq, Hkv, G, S, Dq, splits, chunk,
                           1.0 / (Dq ** 0.5), dk._DTYPES[q.dtype],
                           torch.cuda.current_stream().cuda_stream)
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


def phase_decode_attn_check(card: str):
    """decode_attn against its plain version at the serving shapes, each
    case on the route the rule gives it (bf16 on the tensor cores, float32
    on SIMT); in bf16 the SIMT kernel is timed on the same inputs.  Then
    the edge cases of _decode_attn_edge_checks."""
    import torch.nn.functional as F
    from repro_torch.bench import sleep_cycles_per_ms, time_ms
    from repro_torch.kernels.decode_attn.kernel import route
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref

    cyc = sleep_cycles_per_ms()
    entry = None
    decode_attn.launches_by_route.update(
        dict.fromkeys(decode_attn.launches_by_route, 0))
    for dtype in (torch.bfloat16, torch.float32):
        for S in (S_MAX, 1000):
            gen = torch.Generator(device="cuda").manual_seed(S)
            ragged = [1, 63, 64, 65, S, S // 2, 129, S - 1]
            cases = [("ragged", ragged)]
            if dtype == torch.bfloat16 and S == S_MAX:
                cases.append(("full", [S] * B))
            kv_bytes = 2 * B * HKV * S * D * dtype.itemsize
            copies = max(2, math.ceil(2 * L2_BYTES / kv_bytes))
            bufs = [tuple(torch.randn(shape, generator=gen, device="cuda")
                          .to(dtype) for shape in
                          ((B, H, D), (B, HKV, S, D), (B, HKV, S, D)))
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
                kind = ran_on(decode_attn, route(D, H // HKV, dtype),
                              f"decode_attn {dtype} S={S} {label}")
                mask = (torch.arange(S, device="cuda")[None, :]
                        < lens[:, None])[:, None, None, :]

                def library(q, k, v):
                    return F.scaled_dot_product_attention(
                        q.view(B, H, 1, D), k, v, attn_mask=mask,
                        enable_gqa=True)

                if not ok:
                    raise AssertionError(
                        f"decode_attn disagrees with its plain version: "
                        f"{dtype} S={S} max_abs_err {err}")
                ms, host_ms = time_ms([lambda b=b: decode_attn(*b, lens)
                                       for b in bufs], 200, cyc)
                ran_on(decode_attn, kind, f"decode_attn {dtype} S={S} "
                                          f"{label} timed")
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
                bound_ms, bound_by = decode_attn_bound(lens_list, dtype)
                print(f"[decode_attn] {str(dtype)[6:]} S={S} lengths "
                      f"{label} {lens_list} on the {kind} route: "
                      f"max_abs_err {err:.3e} (tol {tol}) kernel {ms:.5f} ms "
                      f"(host {host_ms:.5f} ms per call){prev}, plain "
                      f"{plain_ms:.5f} ms, sdpa {library_ms:.5f} ms "
                      f"({ms / library_ms:.2f}x), bound {bound_ms:.5f} ms "
                      f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound "
                      f"[{card}]")
                if label == "full":
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
    return entry


def _wkv6_entry(kind, r, k, v, w, u, s0=None):
    """wkv6 on the ``kind`` route's C entry, whatever the rule would
    choose: at prefill the step kernel is the one the chunked route
    replaced, run here as the redesign's "before".  Not counted as a
    launch of the path.  Returns (out, state)."""
    from repro_torch.kernels.wkv6 import kernel as wk
    nb, T, nh, d = r.shape
    out = torch.empty_like(r)
    state = torch.empty((nb, nh, d, d), dtype=torch.float32, device="cuda")
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            out.data_ptr(), state.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "step":
        err = wk._entries()["step"](*args, nb, T, nh, d,
                                    wk._DTYPES[r.dtype], stream)
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
    nonzero state on the step route, and batch-1 prefills from zeros on
    the chunked route, whole and in two halves with the carried state,
    with decays as the model draws them and near 0 and near 1.  At
    prefill the step kernel is held and timed on the same inputs.  Then
    both routes at batch-1 prompts on either side of the threshold.
    Returns the decode and the prefill entries of the kernels line."""
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
            label = f"{'decode' if T == 1 else 'prefill'}, decays {lo}-{hi}"
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
            if kind == "chunked" and decays == "mid":
                _held(f"wkv6 {dtype} T={T} {decays} on the step entry",
                      _wkv6_entry("step", *bufs[0])[0], want[0],
                      (rtol, atol))
                prev_ms, _ = time_ms([lambda b=b: _wkv6_entry("step", *b)
                                      for b in bufs], 20, cyc)
                timing += f", step route {prev_ms:.5f} ms " \
                    f"({prev_ms / ms:.2f}x the kernel)"
            plain_ms = None
            if decays == "mid":
                plain_ms, _ = time_ms([lambda b=b: wkv6_ref(*b)
                                       for b in bufs], 20 if T == 1 else 2,
                                      cyc)
                timing += f", plain {plain_ms:.5f} ms"
            if kind == "chunked" and decays == "mid":
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
                    T in (1, WKV6_PREFILL_T[0]):
                entry = dict(
                    name="wkv6", route="cuda", kernel_route=kind,
                    source="src/repro_torch/csrc/wkv6.cu",
                    replaces="src/repro/kernels/wkv6/kernel.py:53",
                    shape=f"B={nb} T={T} H={H} D={D} bf16, " +
                    ("decode step" if T == 1 else "batch-1 prefill"),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
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
    return entries


def _device_ms_by_kernel(fn, bufs, calls: int = 10) -> str:
    """Device ms per call of each kernel that ``calls`` calls of ``fn``
    over ``bufs`` launch, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*bufs[i % len(bufs)])
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        name = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
        if us > 0:
            out.append(f"{name.group(1) if name else e.key[:40]} "
                       f"{us / 1e3 / calls:.5f} ms")
    return ", ".join(out)


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


def _simt_gemm(a, b):
    """a @ b on the SIMT route's C entry, whatever the rule would choose:
    in bfloat16 the kernel the tensor-core route replaced, run here as the
    redesign's "before".  bf16 output, no bias, 2-D grid."""
    from repro_torch.kernels.gemm_os.kernel import _entries
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    err = _entries()[0](a.data_ptr(), b.data_ptr(), None, out.data_ptr(), M,
                        N, K, 1, 1, 0, 0,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"SIMT gemm_os launch failed: CUDA error {err}")
    return out


def _simt_conv(x, w):
    """As _simt_gemm, for conv2d_os's SIMT route on bfloat16 x, w."""
    from repro_torch.kernels.conv2d_os.kernel import _entries
    N, H, W, Cin = x.shape
    KH, KW, _, Cout = w.shape
    out = torch.empty((N, H - KH + 1, W - KW + 1, Cout), dtype=x.dtype,
                      device=x.device)
    err = _entries()[0](x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W,
                        Cin, Cout, KH, KW, 1, 1,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"SIMT conv2d_os launch failed: CUDA error {err}")
    return out


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


def phase_table1_kernels(card: str):
    """gemm_os, conv2d_os and qgemm_int8 against their plain versions at
    full size, timed beside their bounds and the closest PyTorch call;
    then the kernel path's entry point, bench_kernel_micro: every row's
    own inputs held against the plain versions, and each kernel's
    launches held to the calls its rows made.  Returns (entries of the
    kernels line, launches on the kernel path)."""
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

    # gemm_os at the ffn_in site; the bf16 prefill is the kernels line's.
    # The bf16 cases take the tensor-core route, float32 the SIMT one; each
    # case's checks run on the route it asserts, then it is timed.
    gemm_os.launches_by_route.update(dict.fromkeys(gemm_os.launches_by_route,
                                                   0))
    for label, m, dtype, want in (
            ("prefill", M, torch.bfloat16, "tensor_core"),
            ("prefill", M, torch.float32, "simt"),
            ("decode", GEMM_DECODE_M, torch.bfloat16, "tensor_core")):
        isz = dtype.itemsize
        nbytes = (m * K + K * N + m * N) * isz
        bufs = [(randn((m, K), dtype), randn((K, N), dtype, K ** -0.5))
                for _ in range(_copies(nbytes))]
        a, b = bufs[0]
        got = gemm_os(a, b)
        flat = gemm_os(a, b, coalesce_grid=True)
        torch.cuda.synchronize()
        err = _held(f"gemm_os {label} {dtype}", got, gemm_ref(a, b),
                    TABLE1_TOL[dtype])
        _held(f"gemm_os {label} {dtype} 1-D tile grid", flat, got, None)
        checks = ""
        if label == "prefill":     # the epilogue on the route's fragments
            bias = randn((N,), torch.float32)
            for act in ("silu", "gelu"):
                e = _held(f"gemm_os {dtype} bias+{act}",
                          gemm_os(a, b, bias, activation=act),
                          gemm_ref(a, b, bias, act), TABLE1_TOL[dtype])
                checks += f"; bias+{act} max_abs_err {e:.3e}"
        route = ran_on(gemm_os, want, f"gemm_os {label} {dtype}")
        ms, host_ms = time_ms([lambda a=a, b=b: gemm_os(a, b)
                               for a, b in bufs], 10, cyc)
        plain_ms, _ = time_ms([lambda a=a, b=b: gemm_ref(a, b)
                               for a, b in bufs], 10, cyc)
        library_ms, _ = time_ms([lambda a=a, b=b: torch.matmul(a, b)
                                 for a, b in bufs], 50, cyc)
        ran_on(gemm_os, want, f"gemm_os {label} {dtype} timed")
        prev = ""
        if dtype == torch.bfloat16:   # the SIMT kernel it replaced
            _held(f"gemm_os {label} {dtype} on the SIMT entry",
                  _simt_gemm(a, b), gemm_ref(a, b), TABLE1_TOL[dtype])
            prev_ms, _ = time_ms([lambda a=a, b=b: _simt_gemm(a, b)
                                  for a, b in bufs], 10, cyc)
            prev = f", SIMT route {prev_ms:.5f} ms"
        bound_ms, bound_by = roofline(nbytes, 2 * m * N * K,
                                      PEAK_FLOPS[dtype])
        print(f"[gemm_os] {str(dtype)[6:]} {label} M={m} K={K} N={N} on "
              f"the {route} route: max_abs_err {err:.3e} (tol rtol "
              f"{TABLE1_TOL[dtype][0]:.2e} atol {TABLE1_TOL[dtype][1]:.0e}),"
              f" 1-D grid bit-equal{checks}; kernel {ms:.5f} ms (host "
              f"{host_ms:.5f} ms per call){prev}, plain {plain_ms:.5f} ms, "
              f"torch.matmul {library_ms:.5f} ms ({ms / library_ms:.2f}x), "
              f"bound {bound_ms:.5f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of bound [{card}]")
        if label == "decode":     # beside the prefill's entry
            next(e for e in entries if e["name"] == "gemm_os").update(
                decode_ms=ms, decode_library_ms=library_ms,
                decode_bound_ms=bound_ms, decode_prev_ms=prev_ms)
        if label == "prefill" and dtype == torch.bfloat16:
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
    # kernels line's.  Then Listing 2 as written (one image, Cin = 1).
    n, H, W, Cin, Cout, KS = SHAPES["conv"]
    OH, OW = H - KS + 1, W - KS + 1
    conv2d_os.launches_by_route.update(
        dict.fromkeys(conv2d_os.launches_by_route, 0))
    for dtype, want in ((torch.bfloat16, "tensor_core"),
                        (torch.float32, "simt")):
        isz = dtype.itemsize
        nbytes = (n * H * W * Cin + KS * KS * Cin * Cout
                  + n * OH * OW * Cout) * isz
        bufs = [(randn((n, H, W, Cin), dtype),
                 randn((KS, KS, Cin, Cout), dtype, (KS * KS * Cin) ** -0.5))
                for _ in range(_copies(nbytes))]
        x, w = bufs[0]
        got = conv2d_os(x, w)
        torch.cuda.synchronize()
        err = _held(f"conv2d_os {dtype}", got, conv2d_ref(x, w),
                    TABLE1_TOL[dtype])
        route = ran_on(conv2d_os, want, f"conv2d_os {dtype}")
        # cuDNN on the same NHWC memory, viewed as channels-last NCHW
        lib = [(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)) for x, w in bufs]
        ms, host_ms = time_ms([lambda x=x, w=w: conv2d_os(x, w)
                               for x, w in bufs], 20, cyc)
        plain_ms, _ = time_ms([lambda x=x, w=w: conv2d_ref(x, w)
                               for x, w in bufs], 5, cyc)
        library_ms, _ = time_ms([lambda x=x, w=w: F.conv2d(x, w)
                                 for x, w in lib], 50, cyc)
        ran_on(conv2d_os, want, f"conv2d_os {dtype} timed")
        prev = ""
        if dtype == torch.bfloat16:   # the SIMT kernel it replaced
            _held(f"conv2d_os {dtype} on the SIMT entry", _simt_conv(x, w),
                  conv2d_ref(x, w), TABLE1_TOL[dtype])
            prev_ms, _ = time_ms([lambda x=x, w=w: _simt_conv(x, w)
                                  for x, w in bufs], 20, cyc)
            prev = f", SIMT route {prev_ms:.5f} ms"
        bound_ms, bound_by = roofline(
            nbytes, 2 * n * OH * OW * Cout * KS * KS * Cin, PEAK_FLOPS[dtype])
        print(f"[conv2d_os] {str(dtype)[6:]} N={n} H=W={H} Cin={Cin} "
              f"Cout={Cout} {KS}x{KS} on the {route} route: max_abs_err "
              f"{err:.3e} (tol rtol {TABLE1_TOL[dtype][0]:.2e} atol "
              f"{TABLE1_TOL[dtype][1]:.0e}); kernel {ms:.5f} ms (host "
              f"{host_ms:.5f} ms per call){prev}, plain {plain_ms:.5f} ms, "
              f"F.conv2d {library_ms:.5f} ms ({ms / library_ms:.2f}x), "
              f"bound {bound_ms:.5f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of bound [{card}]")
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
    torch.cuda.synchronize()
    routed = {"gemm_os": gemm_os, "conv2d_os": conv2d_os,
              "qgemm_int8": qgemm_int8, "decode_attn": decode_attn}
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
    if by_route != want_by_route or any(
            by_route[op]["tensor_core"] == 0
            for op in ("gemm_os", "conv2d_os", "qgemm_int8")):
        raise AssertionError(f"kernel path launches by route {by_route}, "
                             f"its rows' routes {want_by_route}")
    print(f"[bench] launches on the kernel path: {launches}; by route "
          f"{by_route}")
    return entries, {e["name"]: launches[e["name"]] for e in entries}


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


def phase_serve(card: str, arch: str, n_layers=None):
    """``arch`` at full width, served through the Engine at full depth or
    cut to ``n_layers``; its kernel runs as ``_serve_spec`` says, and
    neither kernel runs on the MLA path."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.models.zoo import build_model, cache_tensors
    from repro_torch.serve.engine import Engine, Request

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
    while pending or eng.n_active:
        while pending and eng.has_free_slot():
            req = pending.popleft()
            t0 = time.perf_counter()
            if not eng.admit(req):
                raise AssertionError(f"no slot for request {req.rid}")
            torch.cuda.synchronize()
            prefill_s += time.perf_counter() - t0
            prompt_tokens += len(req.prompt)
        t0 = time.perf_counter()
        decoded += len(eng.step())
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
        steps += 1
    counts = {**_counts(decode_attn), **_counts(wkv6)}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    want = per_step * steps + per_prompt * N_REQUESTS
    for other in (decode_attn, wkv6):
        expect = want if other is op else 0
        if other.launches != expect:
            raise AssertionError(f"{other.__name__} launched "
                                 f"{other.launches} times, not {expect}, in "
                                 f"{steps} decode steps and {N_REQUESTS} "
                                 f"prefills of {cfg.name}")
    for r in reqs:
        if not (r.done and len(r.out) == r.max_new
                and all(0 <= t < cfg.vocab for t in r.out)):
            raise AssertionError(f"request {r.rid} ended wrongly: "
                                 f"{len(r.out)}/{r.max_new} tokens")
    how = f"{per_step} x {steps}" if not per_prompt else \
        f"{per_step} x ({steps} + {N_REQUESTS})"
    if op is None:
        how = "decode_attn and wkv6 both 0"
    elif op is decode_attn:     # bf16, every D and G: the tensor cores
        how += f", {ran_on(decode_attn, 'tensor_core', name)} route"
    else:     # decode steps on the step route, each prefill by its length
        from repro_torch.kernels.wkv6.kernel import route as wkv6_route
        by_route = dict(wkv6.launches_by_route)
        hd = cfg.d_model // cfg.n_heads
        want_by_route = dict.fromkeys(by_route, 0)
        want_by_route["step"] += per_step * steps
        for r in reqs:
            want_by_route[wkv6_route(1, len(r.prompt), cfg.n_heads,
                                     hd)] += per_prompt
        if by_route != want_by_route:
            raise AssertionError(f"wkv6 launches by route {by_route}, not "
                                 f"{want_by_route}")
        how += f"; by route {by_route}"
    print(f"[serve] {N_REQUESTS} requests, {prompt_tokens} prompt tokens, "
          f"{decoded} decoded tokens in {steps} decode steps; launches "
          f"{name} {op.launches if op is not None else 0} = {how}")
    print(f"[serve] prefill {prefill_s * 1e3:.1f} ms total "
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
                                   bench_verify_batched, rf_cohort_arch)
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
    gates, the tiny design-space sweep (cold, warm, resumed, through a
    2-worker fleet) and a search.  Raises on any mismatch."""
    import dataclasses

    from repro_torch.bench import (OPS, SEARCH_KERNELS, bench_check_static,
                                   bench_dse_search, bench_dse_sweep,
                                   bench_isa_export)
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

        # (d) the tiny sweep: cold, warm, resumed, through the fleet
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
            return sweep_tc, dt

        _, dt = sweep("cold", "cache", checkpoint=ckpt)
        _tools_step("d", "cold tiny sweep (4 variants x 10 kernels, "
                    "compiled on the host, verified on the card), "
                    "frontier byte-equal to the committed one", dt, card)
        _, dt = sweep("warm", "cache")
        _tools_step("d", "warm tiny sweep, frontier byte-equal", dt, card)
        with open(ckpt) as f:
            d = json.load(f)
        del d["variants"][get_space("tiny")[-1].name]
        with open(ckpt, "w") as f:
            json.dump(d, f)
        _, dt = sweep("resumed", "cache", checkpoint=ckpt)
        _tools_step("d", "tiny sweep resumed from a checkpoint missing "
                    "its last variant, frontier byte-equal", dt, card)
        if not torch.cuda.is_initialized():
            raise AssertionError("CUDA is not initialised in the parent")
        fleet_tc, dt = sweep("fleet", "cache_fleet", jobs=2)
        report = fleet_tc.last_fleet_report
        if report is None or report.sequential:
            raise AssertionError("the jobs=2 sweep did not fan out")
        states = run_fleet(_worker_cuda_state, list(range(4)),
                           FleetConfig(groups=2)).results
        if states is None or any(states):
            raise AssertionError(f"fleet workers' CUDA state: {states}")
        _tools_step("d", "cold tiny sweep through compile_many(jobs=2) "
                    "(a 2-worker fleet, CUDA initialised in the parent, "
                    "not in the workers), frontier byte-equal", dt, card)
        rows = bench_dse_sweep(dev)
        print(f"[tools] step d {json.dumps(rows[0])}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
        print(f"[env] {label}: {now - clock:.1f} s")
        clock = now

    phase_build()
    lap("build")
    entries = [phase_decode_attn_check(card), *phase_wkv6_check(card)]
    lap("decode_attn and wkv6 checks")
    table1, launches = phase_table1_kernels(card)
    entries += table1
    lap("Table-I kernels and the kernel path")
    cks = phase_cgra(card)
    lap("phase_cgra")
    phase_cgra_tools(card, cks)
    lap("phase_cgra_tools")
    _add_counts(launches, phase_serve_cgra(card))
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase_serve_cgra")
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
    for entry in entries:     # a routed kernel's entry: its route's count
        key = f"{entry['name']}:{entry.get('kernel_route')}"
        entry["launches"] = launches.get(key, launches[entry["name"]])
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
