"""Benchmark harness of the port (the counterpart of
``benchmarks/run.py``, importing only ``repro_torch``).

  table1_torch          -- the paper's Table I (benchmarks/table1_torch.py;
                           verification simulated on the card)
  mapper_sweep_torch    -- II vs MII across cluster variants (host mapper)
  toolchain_cache_torch -- cold vs warm Toolchain.compile over the Table-I
                           kernel set (the content-addressed artifact cache)
  frontend_trace_torch  -- frontend DSL tracing vs a warm-cache compile
  kernel_micro_torch, sim_throughput_torch, verify_batched_torch,
  isa_export_torch, check_static_torch, dse_sweep_torch,
  dse_search_torch, serve_decode_torch
                        -- the rows of ``repro_torch.bench`` as they are
                           (the Hopper kernels, the simulator, the flow's
                           tools and CGRA-backed serving, on the card)

The first four are copies of ``benchmarks/run.py``'s benches on the port's
modules, and their rows carry the reference's row names; the bench names
carry ``_torch``, so a ``BENCH_<name>.json`` written here never collides
with the reference's.  Each benchmark prints ``name,us_per_call,derived``
CSV rows and ``main`` writes one ``BENCH_<name>.json`` artifact per
benchmark (schema 1: ``{"bench", "schema", "git_sha", "rows": [{"name",
"us", "derived": {...}}]}``).

CLI:  python -m benchmarks.run_torch [--only table1_torch,mapper_sweep_torch]
                                     [--out DIR] [--device cpu]
      python -m benchmarks.run_torch --check-regression BEFORE AFTER
                                     [--tol 0.15]
The output directory defaults to ``$MORPHER_BENCH_DIR`` or the cwd; the
benches that simulate or launch run on ``--device`` (default the CUDA
card, and they raise without one).  The regression comparator is the
reference's: it accepts files or directories of BENCH artifacts and exits
nonzero when any row slows beyond the tolerance.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

BENCH_SCHEMA = 1


def _row(name: str, us: float, **derived) -> Dict:
    return {"name": name, "us": round(us, 1), "derived": derived}


def _print_rows(rows: List[Dict]) -> None:
    for r in rows:
        d = ";".join(f"{k}={v}" for k, v in r["derived"].items())
        us = "n/a" if r["us"] is None else f"{r['us']:.0f}"
        print(f"{r['name']},{us},{d}")


def _git_sha() -> Optional[str]:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            text=True, stderr=subprocess.DEVNULL).strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def bench_table1(device=None) -> List[Dict]:
    from . import table1_torch
    return table1_torch.main(device=device)


def bench_mapper_sweep(device=None) -> List[Dict]:
    del device                          # host mapping only
    from repro_torch.core.adl import cluster_4x4
    from repro_torch.core.kernels_lib import build_gemm
    from repro_torch.core.mapper import MapError, MapperOptions
    from repro_torch.core.toolchain import Toolchain

    # use_cache=False: this benchmark measures real mapper search time
    tc = Toolchain(options=MapperOptions(ii_max=24, seeds=(0, 1, 2, 3),
                                         time_budget_s=60))
    rows = []
    for rf in (4, 8, 16):
        for unroll in (1, 2, 4):
            arch = cluster_4x4(regfile=rf)
            spec = build_gemm(TI=6, TK=8, TJ=6, unroll=unroll, arch=arch)
            t0 = time.time()
            try:
                ck = tc.compile(spec, use_cache=False)
                rows.append(_row(f"mapper_rf{rf}_u{unroll}",
                                 (time.time() - t0) * 1e6, II=ck.II,
                                 MII=ck.mii,
                                 util=round(ck.utilization, 3)))
            except MapError:
                rows.append(_row(f"mapper_rf{rf}_u{unroll}",
                                 (time.time() - t0) * 1e6, unmapped=1))
    _print_rows(rows)
    return rows


def bench_toolchain_cache(device=None) -> List[Dict]:
    """Cold vs warm compile of the Table-I kernel set through the content-
    addressed artifact cache (small dims, identical DFG structure).  Host
    code only: ``device`` is unused."""
    del device
    from repro_torch.core.kernels_lib import table1_kernels
    from repro_torch.core.mapper import MapperOptions
    from repro_torch.core.toolchain import Toolchain

    # no per-kernel wall-clock budget: the cold pass measures full mapper
    # cost, and budgets misfire under CPU oversubscription anyway
    opts = MapperOptions(seeds=tuple(range(8)))
    cache = tempfile.mkdtemp(prefix="morpher-cache-bench-")
    try:
        specs = list(table1_kernels(small=True).values())
        t0 = time.time()
        Toolchain(options=opts, cache_dir=cache).compile_many(specs)
        cold = time.time() - t0
        # fresh Toolchain: no in-process memo, artifacts come off disk
        t0 = time.time()
        warm_cks = Toolchain(options=opts, cache_dir=cache).compile_many(
            list(table1_kernels(small=True).values()))
        warm = time.time() - t0
        assert all(ck.from_cache for ck in warm_cks)
        rows = [_row("toolchain_cache", cold * 1e6,
                     warm_us=round(warm * 1e6), kernels=len(specs),
                     speedup=round(cold / warm, 1))]
        _print_rows(rows)
        return rows
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def bench_frontend_trace(device=None) -> List[Dict]:
    """Front-end tracing overhead: time to trace each Table-I kernel
    through the ``repro_torch.frontend`` DSL vs a warm-cache Toolchain.compile
    of the same kernel (target: trace < 5% of the warm compile).  Host
    code only: ``device`` is unused."""
    del device
    from repro_torch.core.adl import cluster_4x4
    from repro_torch.core.kernels_lib import build_conv, build_gemm
    from repro_torch.core.mapper import MapperOptions
    from repro_torch.core.toolchain import Toolchain

    # arch is shared across kernels (as in any real sweep): what's timed
    # below is tracing + spec assembly, not ADL construction
    g = dict(TI=6, TK=8, TJ=6, arch=cluster_4x4())
    c = dict(OH=5, OW=5, K=3, arch=cluster_4x4())
    builders = {
        "GEMM": lambda: build_gemm(**g, unroll=1),
        "GEMM-U": lambda: build_gemm(**g, unroll=4),
        "GEMM-U-C": lambda: build_gemm(**g, unroll=4, coalesced=True),
        "CONV": lambda: build_conv(**c, variant="base"),
        "CONV-U-C-1": lambda: build_conv(**c, variant="uc1"),
        "CONV-U-C-2": lambda: build_conv(**c, variant="uc2"),
    }
    opts = MapperOptions()
    cache = tempfile.mkdtemp(prefix="morpher-frontend-bench-")
    try:
        Toolchain(options=opts, cache_dir=cache).compile_many(
            [b() for b in builders.values()])       # warm the disk cache
        rows = []
        for name, build in builders.items():
            trace_us = float("inf")
            for _ in range(20):                      # best-of: shields noise
                t0 = time.perf_counter()
                spec = build()
                trace_us = min(trace_us, (time.perf_counter() - t0) * 1e6)
            warm_us = float("inf")
            for _ in range(10):
                tc = Toolchain(options=opts, cache_dir=cache)  # no memo
                t0 = time.perf_counter()
                ck = tc.compile(spec)
                warm_us = min(warm_us, (time.perf_counter() - t0) * 1e6)
                assert ck.from_cache
            rows.append(_row(f"trace_{name}", trace_us,
                             warm_compile_us=round(warm_us),
                             nodes=spec.dfg.n_nodes,
                             ratio=round(trace_us / warm_us, 3)))
        _print_rows(rows)
        return rows
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def _port_bench(fn_name: str):
    """A row function of ``repro_torch.bench``, as it is, printed."""
    def bench(device=None) -> List[Dict]:
        from repro_torch import bench as port_bench
        rows = getattr(port_bench, fn_name)(device)
        _print_rows(rows)
        return rows
    bench.__name__ = fn_name
    return bench


BENCHES = {
    "table1_torch": ("Table I (paper reproduction)", bench_table1),
    "frontend_trace_torch": ("frontend DSL tracing overhead (vs warm "
                             "compile)", bench_frontend_trace),
    "mapper_sweep_torch": ("mapper sweep (ADL design-space exploration)",
                           bench_mapper_sweep),
    "toolchain_cache_torch": ("toolchain artifact cache (cold vs warm)",
                              bench_toolchain_cache),
    "kernel_micro_torch": ("Hopper kernel micro",
                           _port_bench("bench_kernel_micro")),
    "sim_throughput_torch": ("simulator throughput",
                             _port_bench("bench_sim_throughput")),
    "verify_batched_torch": ("batched vs sequential verification "
                             "throughput",
                             _port_bench("bench_verify_batched")),
    "isa_export_torch": ("instruction-stream export + interpreter xval",
                         _port_bench("bench_isa_export")),
    "check_static_torch": ("static legality audit throughput",
                           _port_bench("bench_check_static")),
    "dse_sweep_torch": ("tiny design-space sweep (modeled latency)",
                        _port_bench("bench_dse_sweep")),
    "dse_search_torch": ("cross-architecture stacked simulation throughput",
                         _port_bench("bench_dse_search")),
    "serve_decode_torch": ("CGRA-backed serving traffic episode (modeled)",
                           _port_bench("bench_serve_decode")),
}


def check_regression(before: str, after: str, tol: float = 0.15) -> int:
    """Compare two BENCH_<name>.json artifacts (or two directories of
    them): any row whose ``us`` grew by more than ``tol`` (relative) is a
    throughput regression.  Returns a nonzero exit status if any row
    regressed; rows present on only one side are reported but never fail.
    """
    def load_rows(path: str) -> Dict[str, Dict]:
        files = (sorted(os.path.join(path, f) for f in os.listdir(path)
                        if f.startswith("BENCH_") and f.endswith(".json"))
                 if os.path.isdir(path) else [path])
        rows: Dict[str, Dict] = {}
        for fn in files:
            with open(fn, "r", encoding="utf-8") as f:
                d = json.load(f)
                for r in d["rows"]:
                    # key by (bench, row): same-named rows from different
                    # benchmarks must not shadow each other
                    rows[f"{d['bench']}/{r['name']}"] = r
        return rows

    b_rows, a_rows = load_rows(before), load_rows(after)
    failed = []
    for name in sorted(set(b_rows) | set(a_rows)):
        if name not in b_rows:
            print(f"NEW       {name}: {a_rows[name]['us']}us")
            continue
        if name not in a_rows:
            print(f"REMOVED   {name} (was {b_rows[name]['us']}us)")
            continue
        b_us, a_us = b_rows[name]["us"], a_rows[name]["us"]
        if b_us is None or a_us is None:
            # informational rows (e.g. an unmapped table1 kernel) carry
            # no duration; report, never gate
            print(f"{'n/a':9s} {name}: {b_us}us -> {a_us}us")
            continue
        rel = (a_us - b_us) / b_us if b_us else 0.0
        verdict = "REGRESSED" if rel > tol else "ok"
        print(f"{verdict:9s} {name}: {b_us:.0f}us -> {a_us:.0f}us "
              f"({rel:+.1%}, tol {tol:.0%})")
        if rel > tol:
            failed.append(name)
    if failed:
        print(f"# {len(failed)} row(s) regressed beyond {tol:.0%}: "
              f"{', '.join(failed)}")
        return 1
    print("# no regressions")
    return 0


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default=None,
                    help="comma-separated benchmark names "
                         f"(default: all of {', '.join(BENCHES)})")
    ap.add_argument("--out", default=None,
                    help="directory for BENCH_<name>.json artifacts "
                         "(default: $MORPHER_BENCH_DIR or cwd)")
    ap.add_argument("--device", default=None,
                    help="device of the benches that simulate or launch "
                         "(default: the CUDA card)")
    ap.add_argument("--check-regression", nargs=2,
                    metavar=("BEFORE", "AFTER"),
                    help="compare two BENCH json files (or directories of "
                         "them) instead of running benchmarks; exits "
                         "nonzero if any row slowed beyond --tol")
    ap.add_argument("--tol", type=float, default=0.15,
                    help="relative slowdown tolerated by "
                         "--check-regression (default 0.15)")
    args = ap.parse_args(argv)
    if args.check_regression:
        raise SystemExit(check_regression(*args.check_regression,
                                          tol=args.tol))
    names = list(BENCHES) if not args.only else [
        n.strip() for n in args.only.split(",") if n.strip()]
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown benchmark(s): {', '.join(unknown)}")
    out_dir = args.out or os.environ.get("MORPHER_BENCH_DIR") or "."
    os.makedirs(out_dir, exist_ok=True)
    sha = _git_sha()
    for name in names:
        title, fn = BENCHES[name]
        print(f"# === {title} ===")
        t0 = time.perf_counter()
        rows = fn(args.device)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s")
        path = os.path.join(out_dir, f"BENCH_{name}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"bench": name, "schema": BENCH_SCHEMA,
                       "git_sha": sha, "rows": rows}, f, indent=1)
            f.write("\n")
        print(f"# wrote {path}")


if __name__ == "__main__":
    main()
