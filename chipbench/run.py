#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exit codes: 0 with a result; 2 when the cell, the program or the cards it
asks for are missing; 3 when JAX or the JAX package ``repro`` is loaded.
Every build and kernel cache stays under ``build/`` in the checkout.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from chipbench import guard  # noqa: E402


def fail(msg: str, code: int = 2) -> None:
    print(f"chipbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    guard.check("start")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from chipbench import harness
    try:
        cell = harness.workload(args.workload)
        bench = harness.benchmark()
    except FileNotFoundError as e:
        fail(f"no such file: {e.filename}")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < int(cell["chips"]):
        fail(f"the cell asks for {cell['chips']} cards, "
             f"{torch.cuda.device_count()} present")
    try:
        import repro_torch
    except ImportError:
        fail("the program (src/repro_torch) is not in this checkout")
    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        fail(f"repro_torch loads from {repro_torch.__file__}, outside "
             f"this checkout")

    cfg = harness.config(cell["config"])
    device = torch.device("cuda", 0)
    run = harness.Run(cell=cell, cfg=cfg, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device=device)
    harness.driver(cell).run(run, T_START)
    metrics = harness.read_metrics(
        run, harness.metrics_of(bench, args.workload, bool(args.trace)))
    run.correct = harness.judge(run.checks)

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace and run.stretch is not None:
        from chipbench import program, trace
        st = run.stretch
        print(f"chipbench: traced {len(st.ops)} device operations in "
              f"{st.seconds:.3f} s, {st.matched} matched to their launch, "
              f"{sum(1 for o in st.ops if o.span)} in a span",
              file=sys.stderr)
        dev["busy_s"] = run.stretch.busy_s()
        dev["window_s"] = run.stretch.seconds
        result["breakdown"] = {
            "device_ops": trace.top_device_ops(run.stretch),
            "idle_gaps": trace.idle_by_host_span(run.stretch, run.spans)}
        by_program = program.idle_gaps_program(run)
        if by_program is not None:
            result["breakdown"]["idle_gaps_program"] = by_program
    result["checks"] = run.checks
    guard.check("end")
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
