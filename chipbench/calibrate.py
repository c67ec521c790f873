#!/usr/bin/env python3
"""Readings for a cell's limits: for each seed, in one process, the
program's number and its control's on the same outputs (the reference one
precision below the configuration's dtype), after a window of
``--seconds``, each judged against the cell's limit (``correct``,
``control_correct``), and the card's peak allocation of the check
(``check_peak_bytes``).  Prints one JSON line a seed and, with ``--out``,
writes them all.

    python3 chipbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--out chiprun_out/calibrate.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from chipbench import guard, harness
    from chipbench.drivers import common
    cell = harness.workload(args.workload)
    cfg = harness.config(cell["config"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = harness.Run(cell=cell, cfg=cfg, seed=seed,
                          seconds=args.seconds, trace=False,
                          device=torch.device("cuda", 0))
        row = harness.driver(cell).calibrate(run)
        row.update(seed=seed, seconds=time.time() - t0,
                   attempted=run.attempted)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del run
        common.free(torch.device("cuda", 0))
    print(f"calibrate: the program judged correct on "
          f"{sum(r['correct'] for r in rows)} of {len(rows)} seeds, the "
          f"control on {sum(r['control_correct'] for r in rows)}",
          file=sys.stderr)
    guard.check("end")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
