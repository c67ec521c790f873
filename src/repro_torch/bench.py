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

``bench_sim_throughput`` and ``bench_verify_batched`` are the CGRA flow's
rows (``simulator_gemm_torch``, ``verify_batched_torch``), the
counterparts of ``benchmarks/run.py``'s ``bench_sim_throughput`` and
``bench_verify_batched``: the cycle-accurate simulator on the Table-I
GEMM, and sequential ``verify`` against one ``verify_batch`` per kernel
over the ten-kernel verification set, on ``device``.

``bench_isa_export``, ``bench_check_static``, ``bench_dse_sweep`` and
``bench_dse_search`` are the rows of the flow's tools
(``isa_export_torch``, ``isa_xval_torch``, ``check_static_torch``,
``dse_sweep_torch``, ``dse_search_torch``), the counterparts of
``benchmarks/run.py``'s rows of the same names without the suffix, with
the same ``derived`` keys; their simulations run on ``device``.

``bench_serve_decode`` gives the rows ``serve_decode_llama3.2-1b`` and
``serve_decode_rwkv6-1.6b`` of ``benchmarks/run.py``'s ``serve_decode``
bench, under the reference's names: CGRA-backed serving of the smoke
configs on plan-modeled latency, the engine and the plan's spot check on
``device``.

``time_ms`` is the port's timer of device work, also used by
``chip_smoke.py``.
"""
from __future__ import annotations

import math
import shutil
import tempfile
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


# register-file sizes of the stacked-verification cohort: one 4 x 4 mesh
# fabric with four 4 kB banks (the design-space point
# ArchPoint(4, 4, regfile_size=rf, bank_kb=4, banks_per_col=2))
RF_COHORT = (4, 8, 16)


def rf_cohort_arch(rf: int):
    """The cohort's fabric with an ``rf``-register file."""
    from .dse.space import ArchPoint
    return ArchPoint(4, 4, regfile_size=rf, bank_kb=4,
                     banks_per_col=2).build()


def _simcache_derived(st: Dict[str, int]) -> Dict[str, int]:
    """The runner-cache counters a verify row carries (informational)."""
    return {"sim_cache_entries": st["entries"], "sim_cache_hits": st["hits"],
            "sim_cache_misses": st["misses"]}


def bench_sim_throughput(device: DeviceLike = None) -> List[Dict]:
    """Simulated cycles per second of one ``CompiledKernel.run`` of the
    Table-I GEMM (6 x 8 x 6, base variant) on ``device``, best of 3 after
    a warm-up run."""
    from .core.kernels_lib import build_gemm
    from .core.toolchain import Toolchain
    from .core.verify import generate_test_data

    dev = resolve_device(device)
    spec = build_gemm(TI=6, TK=8, TJ=6, unroll=1)
    ck = Toolchain(cache_dir="").compile(spec)
    data = generate_test_data(spec)
    n_cycles = ck.cfg.n_cycles(spec.mapped_iters) * len(spec.invocations)
    ck.run(data.init_banks, device=dev)
    dt = float("inf")                 # best of 3: shields against noise
    for _ in range(3):
        t0 = time.perf_counter()
        ck.run(data.init_banks, device=dev)
        dt = min(dt, time.perf_counter() - t0)
    return [{"name": "simulator_gemm_torch", "us": round(dt * 1e6, 1),
             "derived": dict(cycles=n_cycles,
                             cycles_per_s=round(n_cycles / dt))}]


_set_toolchain = None


def _verification_set():
    """The ten-kernel verification set (six Table-I kernels at small dims,
    four DSL kernels), compiled without a disk cache; the rows share one
    in-process memo (keyed by content address), so the set compiles once
    a process."""
    global _set_toolchain
    from .core.kernels_lib import table1_kernels
    from .core.toolchain import Toolchain
    from .frontend.library import dsl_kernels

    if _set_toolchain is None:
        _set_toolchain = Toolchain(cache_dir="")
    specs = {**table1_kernels(small=True), **dsl_kernels()}
    return _set_toolchain.compile_many(list(specs.values()))


def share_verification_toolchain(tc) -> None:
    """Compile the rows' verification set through ``tc``: a caller that
    has compiled the set with it already hands the rows its memo instead
    of a second cold compile."""
    global _set_toolchain
    _set_toolchain = tc


# the seed batch of the verify row, as benchmarks/run.py's
VERIFY_SEEDS = tuple(range(8))


def bench_verify_batched(device: DeviceLike = None) -> List[Dict]:
    """Verification throughput over the Table-I (small dims) + DSL kernel
    set: per-seed sequential ``verify`` against one ``verify_batch`` per
    kernel at VERIFY_SEEDS, both on ``device`` after one untimed pass of
    each."""
    from .core import simcache

    dev = resolve_device(device)
    seeds = list(VERIFY_SEEDS)
    cks = _verification_set()
    for ck in cks:
        ck.verify(seed=seeds[0], device=dev)
        ck.verify_batch(seeds, device=dev)
    cache = simcache.stats()

    t0 = time.perf_counter()
    for ck in cks:
        for s in seeds:
            ck.verify(seed=s, device=dev)
    seq = time.perf_counter() - t0
    t0 = time.perf_counter()
    for ck in cks:
        ck.verify_batch(seeds, device=dev)
    bat = time.perf_counter() - t0

    n = len(cks) * len(seeds)
    return [{"name": "verify_batched_torch", "us": round(bat * 1e6, 1),
             "derived": dict(seq_us=round(seq * 1e6), kernels=len(cks),
                             batch=len(seeds), verifies=n,
                             seq_verifies_per_s=round(n / seq, 1),
                             batch_verifies_per_s=round(n / bat, 1),
                             speedup=round(seq / bat, 2),
                             **_simcache_derived(cache))}]


def bench_isa_export(device: DeviceLike = None) -> List[Dict]:
    """Instruction-stream backend over the verification set: export
    (encode all three artifacts, best of 3) and the standalone-interpreter
    cross-validation against ``simulate()`` on ``device`` (one seed, best
    of 3)."""
    from .isa.encode import encode_kernel
    from .isa.xval import cross_validate, stream_for

    dev = resolve_device(device)
    cks = _verification_set()
    insns = sum(ck.cfg.II * ck.cfg.P for ck in cks)
    for ck in cks:                       # warm: imports, one run each
        encode_kernel(ck)
        cross_validate(ck, seeds=(0,), device=dev)

    exp = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        arts = [encode_kernel(ck) for ck in cks]
        exp = min(exp, time.perf_counter() - t0)
    streams = [stream_for(ck) for ck in cks]
    xval = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for ck, st in zip(cks, streams):
            cross_validate(ck, seeds=(0,), stream=st, device=dev)
        xval = min(xval, time.perf_counter() - t0)
    return [{"name": "isa_export_torch", "us": round(exp * 1e6, 1),
             "derived": dict(kernels=len(cks), insns=insns,
                             bytes=sum(len(t) for a in arts
                                       for t in a.values()),
                             insns_per_s=round(insns / exp))},
            {"name": "isa_xval_torch", "us": round(xval * 1e6, 1),
             "derived": dict(kernels=len(cks), seeds=1,
                             kernels_per_s=round(len(cks) / xval, 1))}]


def bench_check_static(device: DeviceLike = None) -> List[Dict]:
    """Static legality audit over the verification set (all three layers
    per kernel, best of 3); ``verify_us`` is one batch-1 ``verify`` of the
    same set on ``device`` (best of 3): the cost the ``MORPHER_CHECK=1``
    pre-screen lets a fleet skip for an artifact corrupt on paper."""
    from .check import check_kernel, errors

    dev = resolve_device(device)
    cks = _verification_set()
    for ck in cks:                       # warm: imports, one run each
        assert not errors(check_kernel(ck))
        ck.verify(seed=0, device=dev)

    chk = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        n_diags = sum(len(check_kernel(ck)) for ck in cks)
        chk = min(chk, time.perf_counter() - t0)
    ver = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for ck in cks:
            ck.verify(seed=0, device=dev)
        ver = min(ver, time.perf_counter() - t0)
    return [{"name": "check_static_torch", "us": round(chk * 1e6, 1),
             "derived": dict(kernels=len(cks), diagnostics=n_diags,
                             kernels_per_s=round(len(cks) / chk, 1),
                             verify_us=round(ver * 1e6),
                             verify_ratio=round(ver / chk, 1))}]


# the design space of the sweep row, as benchmarks/run.py's
SWEEP_SPACE = "tiny"


def bench_dse_sweep(device: DeviceLike = None) -> List[Dict]:
    """The ``tiny`` design-space sweep end to end from a cold cache: every
    variant compiles the ten-kernel library on the host and verifies it on
    ``device``.  The first row, ``dse_sweep_torch``, is the sweep's wall
    time; the others are the sweep's own rows
    (:func:`~repro_torch.dse.pareto.sweep_bench_rows`: modeled latency,
    deterministic, the JAX package's rows word for word)."""
    from .core.mapper import MapperOptions
    from .core.toolchain import Toolchain
    from .dse import get_space, run_sweep

    dev = resolve_device(device)
    cache = tempfile.mkdtemp(prefix="morpher-dse-bench-")
    try:
        tc = Toolchain(options=MapperOptions(ii_max=20), cache_dir=cache)
        t0 = time.perf_counter()
        results = run_sweep(get_space(SWEEP_SPACE), toolchain=tc,
                            device=dev)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return dse_sweep_rows(results, wall)


def dse_sweep_rows(results, wall: float) -> List[Dict]:
    """``bench_dse_sweep``'s rows from a cold sweep of the SWEEP_SPACE
    (``run_sweep``'s results) that took ``wall`` seconds."""
    from .core import simcache
    from .dse import frontier, sweep_bench_rows

    rows = sweep_bench_rows(results)
    n_kernels = sum(len(r.kernels) for r in results)
    head = {"name": "dse_sweep_torch", "us": round(wall * 1e6, 1),
            "derived": dict(variants=len(results),
                            verified=sum(r.ok for r in results),
                            kernels=n_kernels,
                            frontier=len(frontier(results)),
                            kernels_per_s=round(n_kernels / wall, 2),
                            **_simcache_derived(simcache.stats()))}
    return [head] + rows


# the cohort of the search row, as benchmarks/run.py's: homogeneous 4 x 4
# variants of the wide space, four kernels, four seeds
SEARCH_POINTS = 12
SEARCH_KERNELS = ("GEMM", "CONV", "dwconv", "requant-int8")
SEARCH_SEEDS = tuple(range(4))


def bench_dse_search(device: DeviceLike = None) -> List[Dict]:
    """Cross-architecture batched simulation, the DSE search evaluator's
    core, on ``device``: a cohort of homogeneous 4 x 4 wide-space variants
    (RF 4/8/16) compiles SEARCH_KERNELS (off the clock), then the same
    verification batches are simulated one ``run_batch`` per (variant,
    kernel) (``exhaustive``) and stacked by shape bucket into one
    ``simulate_multi`` cycle loop per group (``stacked``).  Each path is
    timed once with an empty runner cache (``exhaustive_us`` / ``us``),
    then once warm (``warm_*``), and the warm outputs are held word for
    word.  An eager runner compiles nothing, so cold and warm differ only
    by its construction (the JAX package's row takes the best of 2 of
    each, its cold runs paying XLA builds)."""
    import numpy as np

    from .core import simcache
    from .core.mapper import MapperOptions
    from .core.simulator import simulate_multi, stack_signature
    from .core.toolchain import Toolchain, _batch_oracle
    from .dse import get_space, kernel_suite

    dev = resolve_device(device)
    points = [p for p in get_space("wide")
              if p.rows == 4 and p.cols == 4 and p.het == "none"
              ][:SEARCH_POINTS]
    seeds = list(SEARCH_SEEDS)
    tc = Toolchain(options=MapperOptions(ii_max=20), cache_dir="")
    units = []                                    # (ck, init_banks_batch)
    for p in points:
        suite = kernel_suite(p.build())
        cks = tc.compile_many([suite[k] for k in SEARCH_KERNELS],
                              allow_unmapped=True)
        units += [(ck, _batch_oracle(ck, seeds, False, dev)[0])
                  for ck in cks if ck is not None]

    def exhaustive():
        return [ck.run_batch(init, device=dev) for ck, init in units]

    def stacked():
        groups: Dict[tuple, List[int]] = {}
        for i, (ck, _init) in enumerate(units):
            sig = stack_signature(ck.cfg, ck.mapped_iters,
                                  len(ck.invocations))
            groups.setdefault(sig, []).append(i)
        outs: List = [None] * len(units)
        for sig in sorted(groups):
            idxs = groups[sig]
            finals = simulate_multi(
                [(units[i][0].cfg, units[i][1], units[i][0].invocations)
                 for i in idxs],
                n_iters=units[idxs[0]][0].mapped_iters, device=dev)
            for i, f in zip(idxs, finals):
                outs[i] = f
        return outs

    def timed(fn, cold: bool):
        if cold:
            simcache.clear()
        t0 = time.perf_counter()
        out = fn()               # returns host banks: the card is done
        return out, time.perf_counter() - t0, simcache.stats()["misses"]

    _, exh, builds_exh = timed(exhaustive, True)
    outs_exh, warm_exh, _ = timed(exhaustive, False)
    _, flat, builds_flat = timed(stacked, True)
    outs_flat, warm_flat, _ = timed(stacked, False)
    for fa, fb in zip(outs_exh, outs_flat):      # [seed][bank] arrays
        for da, db in zip(fa, fb):
            assert set(da) == set(db)
            for k in da:
                if not np.array_equal(da[k], db[k]):
                    raise AssertionError(f"stacked and exhaustive "
                                         f"simulation differ in {k}")
    return [{"name": "dse_search_torch", "us": round(flat * 1e6, 1),
             "derived": dict(points=len(points),
                             kernels=len(SEARCH_KERNELS),
                             seeds=len(seeds), units=len(units),
                             builds_exhaustive=builds_exh,
                             builds_stacked=builds_flat,
                             evals_per_s=round(len(points) / flat, 1),
                             exhaustive_us=round(exh * 1e6),
                             exhaustive_evals_per_s=round(
                                 len(points) / exh, 1),
                             speedup=round(exh / flat, 2),
                             warm_us=round(warm_flat * 1e6),
                             warm_exhaustive_us=round(warm_exh * 1e6),
                             **_simcache_derived(simcache.stats()))}]


SERVE_ARCHS = ("llama3.2-1b", "rwkv6-1.6b")


def bench_serve_decode(device: DeviceLike = None) -> List[Dict]:
    """End-to-end CGRA-backed serving on the smoke configs, the
    counterpart of ``benchmarks/run.py``'s row of the same name: build a
    ServePlan (feasible tiles, compile_many, one site spot-checked
    bit-exactly against the cycle-accurate simulator on ``device``), then
    run a seeded Poisson traffic episode through the engine on ``device``
    on plan-derived latency.  Rows carry the *modeled* episode duration
    and throughput under the reference's names, so they compare byte for
    byte with its ``BENCH_serve_decode.json`` rows."""
    from .configs.registry import serve_smoke_config
    from .core.toolchain import Toolchain
    from .models.zoo import build_model
    from .serve.engine import Engine
    from .serve.plan import CGRAExecutionModel, build_serve_plan
    from .serve.traffic import TrafficConfig, report_bench_rows, run_traffic

    dev = resolve_device(device)
    cache = tempfile.mkdtemp(prefix="morpher-serve-bench-")
    rows: List[Dict] = []
    try:
        tc = Toolchain(cache_dir=cache)
        for arch_id in SERVE_ARCHS:
            cfg = serve_smoke_config(arch_id)
            plan = build_serve_plan(cfg, toolchain=tc, device=dev)
            model = build_model(cfg, device=dev)
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            eng = Engine(model, params, batch=4, max_len=48,
                         exec_model=CGRAExecutionModel(plan), device=dev)
            report = run_traffic(
                eng, TrafficConfig(seed=0, n_requests=12,
                                   arrival_rate=100.0), cfg.vocab)
            rows += report_bench_rows(report,
                                      name=f"serve_decode_{arch_id}",
                                      sites=len(plan.sites),
                                      tiles=len(plan.kernels))
        return rows
    finally:
        shutil.rmtree(cache, ignore_errors=True)
