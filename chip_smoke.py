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
4. Serves llama3.2-1b and then rwkv6-1.6b at full width and depth (random
   weights from a seed) through the port's Engine: 12 requests over 8
   slots each, so slots are reused, and checks that the model's kernel
   ran once per layer in every decode step (decode_attn, on the tensor
   cores) or in every decode step and every prefill (wkv6: decode on the
   step route, each prefill on the route its length gives).  Then holds
   one decode step's logits, kernel-backed, against the same step with
   the plain version, and profiles a few decode steps.
5. Prints the kernels as one JSON line, the card's name and power limit,
   and as its last line {"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
Any failure exits nonzero; without a card it exits 1 before doing work.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from collections import deque

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
    for op in OPS.values():
        op.launches = 0
    for op in routed.values():
        op.launches_by_route.update(dict.fromkeys(op.launches_by_route, 0))
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


def _serve_spec(arch: str):
    """(kernel op, module whose attribute names it, plain version, kernel
    launches per layer and admitted prompt, a part of the names of the
    op's device kernels) of ``arch``'s path."""
    if arch == "llama3.2-1b":
        import repro_torch.models.attention as module
        from repro_torch.kernels.decode_attn.ops import decode_attn as op
        from repro_torch.kernels.decode_attn.ref import decode_attn_ref as ref
        return op, module, ref, 0, "decode_"
    import repro_torch.models.rwkv6 as module
    from repro_torch.kernels.wkv6.ops import wkv6 as op
    from repro_torch.kernels.wkv6.ref import wkv6_ref as ref
    return op, module, ref, 1, "wkv6_"


def phase_serve(card: str, arch: str):
    """``arch`` at full width and depth, served through the Engine; its
    kernel runs once per layer in every decode step and, with
    ``per_prompt``, in every prefill."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.models.zoo import build_model, cache_tensors
    from repro_torch.serve.engine import Engine, Request

    op, module, ref, per_prompt, device_kernel = _serve_spec(arch)
    name = op.__name__
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}"
          f", {n_params / 1e9:.3f} B parameters ({cfg.dtype}), init "
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
    decode_attn.launches = wkv6.launches = 0
    for routed in (decode_attn, wkv6):
        routed.launches_by_route.update(
            dict.fromkeys(routed.launches_by_route, 0))
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
    launches = op.launches
    by_route = dict(op.launches_by_route)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    want = cfg.n_layers * (steps + per_prompt * N_REQUESTS)
    if launches != want:
        raise AssertionError(f"{name} launched {launches} times, not "
                             f"{want}, in {steps} decode steps and "
                             f"{N_REQUESTS} prefills of {cfg.n_layers} "
                             f"layers")
    for r in reqs:
        if not (r.done and len(r.out) == r.max_new
                and all(0 <= t < cfg.vocab for t in r.out)):
            raise AssertionError(f"request {r.rid} ended wrongly: "
                                 f"{len(r.out)}/{r.max_new} tokens")
    how = f"{cfg.n_layers} x {steps}" if not per_prompt else \
        f"{cfg.n_layers} x ({steps} + {N_REQUESTS})"
    if op is decode_attn:     # bf16 at D 64, G 4: the tensor-core route
        how += f", {ran_on(decode_attn, 'tensor_core', name)} route"
    else:     # decode steps on the step route, each prefill by its length
        from repro_torch.kernels.wkv6.kernel import route as wkv6_route
        hd = cfg.d_model // cfg.n_heads
        want_by_route = dict.fromkeys(by_route, 0)
        want_by_route["step"] += cfg.n_layers * steps
        for r in reqs:
            want_by_route[wkv6_route(1, len(r.prompt), cfg.n_heads,
                                     hd)] += cfg.n_layers
        if by_route != want_by_route:
            raise AssertionError(f"wkv6 launches by route {by_route}, not "
                                 f"{want_by_route}")
        how += f"; by route {by_route}"
    print(f"[serve] {N_REQUESTS} requests, {prompt_tokens} prompt tokens, "
          f"{decoded} decoded tokens in {steps} decode steps; {name} "
          f"launches {launches} = {how}")
    print(f"[serve] prefill {prefill_s * 1e3:.1f} ms total "
          f"({prompt_tokens / prefill_s:.0f} prompt tokens/s, batch-1 "
          f"prefills); decode {decode_s * 1e3:.1f} ms total, "
          f"{decode_s / steps * 1e3:.2f} ms/step, {decoded / decode_s:.1f} "
          f"tokens/s; peak memory {peak_gib:.2f} GiB [{card}]")

    # One decode step with all slots busy: kernel against plain version.
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
    for c, s in zip(cache_tensors(eng.caches), saved):
        c.copy_(s)
    setattr(module, name, ref)
    try:
        plain, _ = model.decode(params, eng.caches, toks, pos, lens)
    finally:
        setattr(module, name, op)
    for c, s in zip(cache_tensors(eng.caches), saved):
        c.copy_(s)
    logits, plain = logits.float(), plain.float()
    if not (torch.isfinite(logits).all() and logits.shape == (B, 1, cfg.vocab)):
        raise AssertionError(f"decode logits not finite or shaped "
                             f"{tuple(logits.shape)}")
    err = (logits - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"[serve] decode step, kernel vs plain {name}: max_abs_err "
          f"{err:.3e}, max |logit| {scale:.3f}, tol "
          f"{LOGITS_REL_TOL * scale:.3e}, argmax agreement {agree:.3f}")
    if err > LOGITS_REL_TOL * scale:
        raise AssertionError("kernel-backed decode logits disagree with the "
                             "plain-backed ones")
    profile_steps(eng, card, device_kernel)
    return {name: launches, **{f"{name}:{r}": n for r, n in by_route.items()}}


def profile_steps(eng, card: str, kernel: str) -> None:
    """Device busy time and the costliest kernels of a few decode steps
    with all slots busy, from torch.profiler, and the rows whose names
    hold ``kernel`` wherever they rank."""
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
    for e in ranked[:8] + [e for e in ranked[8:] if kernel in e.key]:
        print(f"[profile]   {dev_us(e) / 1e3 / PROFILE_STEPS:.4f} ms/step, "
              f"{e.count / PROFILE_STEPS:.0f} launches/step: {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    entries = [phase_decode_attn_check(card), *phase_wkv6_check(card)]
    table1, launches = phase_table1_kernels(card)
    entries += table1
    for arch in ("llama3.2-1b", "rwkv6-1.6b"):
        launches.update(phase_serve(card, arch))
        torch.cuda.empty_cache()
    for entry in entries:     # a routed kernel's entry: its route's count
        key = f"{entry['name']}:{entry.get('kernel_route')}"
        entry["launches"] = launches.get(key, launches[entry["name"]])
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
