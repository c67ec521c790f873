"""Pareto scoring and reporting for design-space sweeps.

Each fully-verified variant is a point in (suite latency, area) space:
latency is the cost model's total over the ten-kernel library (each
mapping spans the variant's whole fabric and is scored as one configured
instance; transfer rides the shared host link), area is a deterministic
proxy in integer "area units":

    area = n_pes * (PE_AREA + (regfile + livein regs) * REG_AREA)
         + total_bank_kb * BANK_AREA_PER_KB

The constants are relative weights (a PE datapath ~ a few registers, a
kilobyte of SRAM ~ a couple of PEs), not silicon numbers — the frontier
shape, not absolute mm^2, is what the sweep reports.  The frontier is
the set of non-dominated variants (no other variant is at most as slow
AND at most as small), ordered by ascending latency; ties are broken by
name so the report is byte-deterministic.

``write_artifacts`` emits two files: ``dse_frontier.json`` (the full
deterministic report) and ``BENCH_dse_sweep.json`` (one row per variant
in the ``benchmarks.run`` schema, ``us`` = modeled suite latency — also
deterministic, so the regression comparator gates the cost model and
mapper quality, not wall clock).
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

from ..core.adl import CGRAArch

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .explore import VariantResult

PE_AREA = 4          # FU + crossbar + control, in area units
REG_AREA = 1         # one routing/live-in register
BANK_AREA_PER_KB = 8  # 1 kB of banked SRAM + bus port

BENCH_SCHEMA = 1


def area_units(arch: CGRAArch) -> int:
    """Deterministic integer area proxy for a CGRA variant."""
    per_pe = PE_AREA + REG_AREA * (arch.regfile_size + arch.livein_regs)
    bank_kb = sum(b.size_bytes for b in arch.banks) // 1024
    return arch.n_pes * per_pe + bank_kb * BANK_AREA_PER_KB


def frontier(results: Sequence["VariantResult"]) -> List["VariantResult"]:
    """The Pareto-optimal subset of the fully-verified variants,
    minimizing (suite latency, area); ascending latency order."""
    ok = [r for r in results if r.ok]
    ok.sort(key=lambda r: (r.total_ms, r.area, r.name))
    front: List["VariantResult"] = []
    best_area: Optional[int] = None
    for r in ok:
        if best_area is None or r.area < best_area:
            front.append(r)
            best_area = r.area
    return front


def frontier_table(results: Sequence["VariantResult"]) -> str:
    """Human-readable sweep report: every variant, frontier marked."""
    front = {r.name for r in frontier(results)}
    lines = [f"{'variant':<28} {'PEs':>4} {'area':>6} {'ok':>5} "
             f"{'maxII':>5} {'util':>7} {'latency_ms':>11}  pareto"]
    lines.append("-" * len(lines[0]))
    for r in sorted(results, key=lambda r: (r.total_ms if r.ok else 1e18,
                                            r.area, r.name)):
        ok = f"{r.mapped}/{len(r.kernels)}"
        lat = f"{r.total_ms:11.3f}" if r.ok else f"{'—':>11}"
        lines.append(f"{r.name:<28} {r.n_pes:>4} {r.area:>6} {ok:>5} "
                     f"{r.max_ii:>5} {r.mean_utilization * 100:6.1f}% "
                     f"{lat}  {'*' if r.name in front else ''}")
    return "\n".join(lines)


def _git_sha() -> Optional[str]:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            text=True, stderr=subprocess.DEVNULL).strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def sweep_bench_rows(results: Sequence["VariantResult"]) -> List[Dict]:
    """Benchmark rows (``benchmarks.run`` schema) for the sweep: one row
    per fully-verified variant, ``us`` = modeled suite latency
    (deterministic, so the regression gate tracks mapper/cost-model
    quality).  Partially-mapped variants are reported only in
    ``dse_frontier.json`` — a ``None`` duration has no place in a gated
    benchmark row."""
    front = {r.name for r in frontier(results)}
    rows: List[Dict] = []
    for r in results:
        if not r.ok:
            continue
        rows.append({"name": r.name,
                     "us": round(r.total_ms * 1e3, 1),
                     "derived": {"area": r.area, "pes": r.n_pes,
                                 "mapped": r.mapped,
                                 "kernels": len(r.kernels),
                                 "max_ii": r.max_ii,
                                 "util": round(r.mean_utilization, 4),
                                 "pareto": int(r.name in front)}})
    return rows


def write_artifacts(results: Sequence["VariantResult"], out_dir: str,
                    space: str = "custom",
                    seeds: Sequence[int] = (0,),
                    verified: bool = True,
                    bench_name: str = "dse_sweep",
                    extra: Optional[Dict] = None) -> Dict[str, str]:
    """Write ``dse_frontier.json`` + ``BENCH_<bench_name>.json`` under
    ``out_dir``; returns {artifact name: path}.  Both files are
    byte-deterministic for a given sweep configuration and commit.
    ``verified=False`` (a ``--no-verify`` sweep) is stamped into both
    artifacts so score-only output can never masquerade as a verified
    baseline.  ``extra`` (e.g. the search trajectory from
    :func:`repro_torch.dse.search.run_search`) merges into the frontier report;
    the defaults keep sweep artifacts byte-identical to earlier
    releases."""
    os.makedirs(out_dir, exist_ok=True)
    front = frontier(results)
    report = {
        "schema": BENCH_SCHEMA,
        "space": space,
        "seeds": list(seeds),
        "verified": bool(verified),
        "suite_kernels": sorted({k for r in results for k in r.kernels}),
        "variants": [r.to_json_dict() for r in results],
        "frontier": [r.name for r in front],
    }
    if extra:
        report.update(extra)
    paths = {}
    p = os.path.join(out_dir, "dse_frontier.json")
    with open(p, "w", encoding="utf-8") as f:
        json.dump(report, f, sort_keys=True, indent=1)
        f.write("\n")
    paths["dse_frontier.json"] = p

    fname = f"BENCH_{bench_name}.json"
    p = os.path.join(out_dir, fname)
    with open(p, "w", encoding="utf-8") as f:
        json.dump({"bench": bench_name, "schema": BENCH_SCHEMA,
                   "git_sha": _git_sha(), "verified": bool(verified),
                   "rows": sweep_bench_rows(results)}, f, indent=1)
        f.write("\n")
    paths[fname] = p
    return paths
