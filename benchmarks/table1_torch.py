"""Table I reproduction on the port (the counterpart of
``benchmarks/table1.py``, importing only ``repro_torch``): map all six
kernels on the 4x4 cluster, verify each mapping by cycle-accurate
simulation (small dims, identical DFG structure) on ``device`` (the CUDA
card by default), and evaluate the paper's cost model on the full problem
(GEMM 64^3, CONV 64^3 x 3^2) at 100 MHz / 50 MB/s.

Mapping and the cost model are host code, the reference's own copied; the
simulation and the DFG oracle run in torch on ``device``.  So every field
of the table equals the reference's ``table1.run()``.

Output: CSV rows name,us_per_call,derived plus a side-by-side table
against the paper's numbers.

    python -m benchmarks.table1_torch              # verifies on the card
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.core.costmodel import (KernelCost, conv_traffic_bytes,
                                        gemm_traffic_bytes, kernel_cost)
from repro_torch.core.kernels_lib import table1_kernels
from repro_torch.core.mapper import MapError, MapperOptions
from repro_torch.core.toolchain import Toolchain

PAPER = {  # Table I of the paper
    "GEMM":       dict(nodes=26, II=4, mii=4, util=40.63, compute=0.56,
                       transfer=2.13, total=2.69, speedup=1.0),
    "GEMM-U":     dict(nodes=58, II=6, mii=4, util=60.42, compute=0.25,
                       transfer=2.13, total=2.38, speedup=1.1),
    "GEMM-U-C":   dict(nodes=79, II=8, mii=8, util=61.72, compute=0.27,
                       transfer=0.49, total=0.76, speedup=3.5),
    "CONV":       dict(nodes=27, II=4, mii=4, util=42.19, compute=8.32,
                       transfer=306.38, total=314.70, speedup=1.0),
    "CONV-U-C-1": dict(nodes=100, II=12, mii=7, util=52.08, compute=1.53,
                       transfer=12.75, total=14.28, speedup=22.0),
    "CONV-U-C-2": dict(nodes=153, II=11, mii=10, util=86.93, compute=1.26,
                       transfer=11.19, total=12.45, speedup=25.2),
}

# off-chip traffic per kernel (full problem, output-stationary schedule)
TRAFFIC = {
    "GEMM": gemm_traffic_bytes(),
    "GEMM-U": gemm_traffic_bytes(),
    "GEMM-U-C": gemm_traffic_bytes(),
    "CONV": conv_traffic_bytes(),
    "CONV-U-C-1": conv_traffic_bytes(),
    "CONV-U-C-2": conv_traffic_bytes(),
}
PROBLEM_SCALE = {   # sequential tile steps per cluster for the full problem
    "GEMM": 4, "GEMM-U": 4, "GEMM-U-C": 4,        # K/TK = 64/16
    "CONV": 16, "CONV-U-C-1": 16, "CONV-U-C-2": 16,  # Co / clusters
}
HANDSHAKE_US = 20.0   # per-invocation host handshake (calibrated: CONV base)


def run(verify: bool = True, options: Optional[MapperOptions] = None,
        device=None) -> Dict[str, Optional[KernelCost]]:
    """The table: each kernel's cost (None where it does not map).  With
    ``verify`` each mapping's small-dims variant is simulated on
    ``device`` (``None``: the CUDA card; it raises without one) and held
    to the DFG oracle."""
    options = options or MapperOptions(seeds=tuple(range(8)),
                                       time_budget_s=120.0)
    toolchain = Toolchain(options=options)
    small = table1_kernels(small=True)
    full = table1_kernels(small=False)
    results: Dict[str, Optional[KernelCost]] = {}
    base_total = {}
    for name, spec in full.items():
        try:
            ck = toolchain.compile(spec)
        except MapError as e:
            print(f"# {name}: MAPPING FAILED ({e})")
            results[name] = None
            continue
        if verify:
            # verify with the structurally-identical small-dims variant
            toolchain.compile(small[name]).verify(device=device)
        cost = kernel_cost(
            spec, ck.mapping, problem_scale=PROBLEM_SCALE[name],
            array_bytes_moved=TRAFFIC[name], handshake_us=HANDSHAKE_US)
        base = "GEMM" if name.startswith("GEMM") else "CONV"
        if name == base:
            base_total[base] = cost.total_ms
        if base in base_total:
            cost.speedup = base_total[base] / cost.total_ms
        results[name] = cost
    return results


def print_table(results: Dict[str, Optional[KernelCost]]) -> None:
    hdr = (f"{'Kernel':<12} {'Nodes':>5} {'II(MII)':>8} {'Util':>8} "
           f"{'Compute':>9} {'Transfer':>9} {'Total':>9} {'Speedup':>8}"
           f"   | paper: II(MII) Util Total Speedup")
    print(hdr)
    print("-" * len(hdr))
    for name, c in results.items():
        p = PAPER[name]
        if c is None:
            print(f"{name:<12} {'—':>5} {'unmapped':>8}"
                  f"{'':>36}   | {p['II']}({p['mii']}) "
                  f"{p['util']:.1f}% {p['total']:.2f}ms {p['speedup']}x")
            continue
        print(f"{name:<12} {c.nodes:>5} {c.II:>4}({c.mii:>2}) "
              f"{c.utilization*100:7.2f}% {c.compute_ms:8.2f}m "
              f"{c.transfer_ms:8.2f}m {c.total_ms:8.2f}m "
              f"{c.speedup:7.2f}x   | {p['II']}({p['mii']}) "
              f"{p['util']:.1f}% {p['total']:.2f}ms {p['speedup']}x")


def rows_of(results: Dict[str, Optional[KernelCost]]) -> list:
    """The table's benchmark rows (schema of ``benchmarks/run.py``): the
    modeled total in us and II / MII / util / speedup, or unmapped."""
    rows = []
    for name, c in results.items():
        if c is None:
            rows.append({"name": name, "us": None,
                         "derived": {"unmapped": 1}})
            continue
        us = c.total_ms * 1e3
        rows.append({"name": name, "us": round(us, 1),
                     "derived": {"II": c.II, "MII": c.mii,
                                 "util": round(c.utilization, 4),
                                 "speedup": round(c.speedup, 2)}})
    return rows


def main(device=None) -> list:
    """Run + print the table; returns machine-readable benchmark rows
    (same shape as the other ``benchmarks.run_torch`` benchmarks)."""
    t0 = time.time()
    results = run(device=device)
    print_table(results)
    for name, c in results.items():
        if c is not None:
            print(f"{name},{c.total_ms * 1e3:.1f},II={c.II};MII={c.mii};"
                  f"util={c.utilization:.3f};speedup={c.speedup:.2f}")
    print(f"# table1 done in {time.time() - t0:.0f}s")
    return rows_of(results)


if __name__ == "__main__":
    main()
