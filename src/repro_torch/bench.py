"""Kernel micro-benchmark of the port: the counterpart of
``benchmarks/run.py``'s ``bench_kernel_micro``, which times the Pallas
kernels.

Rows have the harness's schema-1 shape (``name``, ``us``, ``derived``),
with ``_torch`` names: the JAX rows' own shapes (a 256^3 float32 GEMM,
decode attention over 512 cached positions), then ``gemm_os``,
``conv2d_os`` and ``qgemm_int8`` at full size: llama3.2-1b's ffn_in GEMM
site in prefill (M 1024, K 2048, N 8192) and the paper's Table-I CONV
(64 x 64 out, 3 x 3 taps, 64 channels) as a batch of 32 edge images.
Each row's ``derived`` names the op it calls and how often (``calls``,
warm-up included), so a caller can hold the ops' launch counts to it.
``micro_cases`` gives each row's inputs, drawn from one seed, so a caller
can hold the very inputs the rows time against the plain versions.

``time_ms`` is the port's timer of device work, also used by
``chip_smoke.py``.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from .device import DeviceLike, resolve_device
from .kernels.conv2d_os.ops import conv2d_os
from .kernels.decode_attn.ops import decode_attn
from .kernels.gemm_os.ops import gemm_os
from .kernels.qgemm_int8.ops import qgemm_int8
from .kernels.qgemm_int8.ref import quantize_rowwise

# (M, K, N) of the ffn_in site; (N, H, W, Cin, Cout, KH = KW) of the conv
SHAPES = dict(gemm=(1024, 2048, 8192), conv=(32, 66, 66, 64, 64, 3))
# Timed calls a row, after the untimed ones
ITERS = {"cuda": 20, "cpu": 3}
OPS = {"gemm_os": gemm_os, "decode_attn": decode_attn,
       "conv2d_os": conv2d_os, "qgemm_int8": qgemm_int8}


def sleep_cycles_per_ms() -> float:
    """Rate of ``torch.cuda._sleep``, which spins the card for a number of
    clock cycles."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def time_ms(calls: Sequence[Callable[[], object]], iters: int,
            cycles_per_ms: float) -> Tuple[float, float]:
    """(device ms, host ms) per call, cycling through ``calls``; each runs
    twice untimed first (warm-up, then the host's pass).  Device time is
    taken with CUDA events while a spin kernel queued first keeps the card
    busy until every timed call is queued, so the events see the calls
    back to back and not the host's launch rate."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in calls:
        c()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(calls)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (2 * iters * host_ms + 1)))
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def micro_cases(device: torch.device) -> List[Tuple[str, str, tuple, Dict]]:
    """(row name, op name, the op's arguments, derived fields) of each row,
    at SHAPES, drawn on ``device`` from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)
                ).to(dtype)

    cases = [("gemm_os_256_torch", "gemm_os",
              (randn(256, 256), randn(256, 256)), dict(flops=2 * 256 ** 3))]
    q, kv = randn(2, 8, 64), randn(2, 2, 512, 64)
    lens = torch.tensor([512, 300], dtype=torch.int32, device=device)
    cases.append(("decode_attn_torch", "decode_attn", (q, kv, kv, lens),
                  dict(kv=512)))

    M, K, N = SHAPES["gemm"]
    a = randn(M, K, dtype=torch.bfloat16)
    b = randn(K, N, dtype=torch.bfloat16, scale=1 / math.sqrt(K))
    cases.append(("gemm_os_ffn_in_torch", "gemm_os", (a, b),
                  dict(M=M, K=K, N=N, dtype="bfloat16",
                       flops=2 * M * N * K)))

    n, H, W, Cin, Cout, KS = SHAPES["conv"]
    x = randn(n, H, W, Cin, dtype=torch.bfloat16)
    w = randn(KS, KS, Cin, Cout, dtype=torch.bfloat16,
              scale=1 / math.sqrt(KS * KS * Cin))
    OH, OW = H - KS + 1, W - KS + 1
    cases.append(("conv2d_os_edge_torch", "conv2d_os", (x, w),
                  dict(N=n, H=H, W=W, Cin=Cin, Cout=Cout, KH=KS, KW=KS,
                       dtype="bfloat16",
                       flops=2 * n * OH * OW * Cout * KS * KS * Cin)))

    qa, sa = quantize_rowwise(randn(M, K))
    qb, sb = quantize_rowwise(randn(N, K))
    cases.append(("qgemm_int8_ffn_in_torch", "qgemm_int8",
                  (qa, qb.t().contiguous(), sa, sb),
                  dict(M=M, K=K, N=N, ops=2 * M * N * K)))
    return cases


def _time_us(fn: Callable[[], object], iters: int, device: torch.device,
             cycles_per_ms) -> Tuple[float, int]:
    """(microseconds per call, calls made): device time from ``time_ms``
    on a card, the host clock after one warm-up call on the CPU."""
    if device.type == "cuda":
        return time_ms([fn], iters, cycles_per_ms)[0] * 1e3, iters + 2
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e6 / iters, iters + 1


def bench_kernel_micro(device: DeviceLike = None) -> List[Dict]:
    """Times each kernel's entry point at SHAPES; on the card (the
    default) the kernels run, on ``device="cpu"`` their plain versions.
    Each row reuses one set of inputs, as the JAX rows do."""
    dev = resolve_device(device)
    cyc = sleep_cycles_per_ms() if dev.type == "cuda" else None
    rows = []
    for name, op, args, derived in micro_cases(dev):
        us, calls = _time_us(lambda: OPS[op](*args), ITERS[dev.type], dev,
                             cyc)
        rows.append({"name": name, "us": round(us, 1),
                     "derived": dict(kernel=op, calls=calls, **derived)})
    return rows
