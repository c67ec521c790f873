"""CLI: export per-PE instruction streams for the kernel library.

    python -m repro_torch.isa --out streams                 # ten kernels, small
    python -m repro_torch.isa --out streams --xval --seeds 0,1
    python -m repro_torch.isa --out streams --kernels GEMM,CONV

Each kernel lands in ``<out>/<kernel>/`` as ``instructions.csv`` /
``kernel.asm`` / ``stream_manifest.json``.  The artifacts are
byte-deterministic: exporting twice and ``cmp``-ing is the CI
``isa-smoke`` determinism check.  ``--xval`` re-parses the on-disk
artifacts through the standalone interpreter and asserts bit-identity
with ``simulate()`` for every seed, simulating on ``--device`` (default:
the CUDA card).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.isa",
        description="export per-PE instruction streams "
                    "(+ optional cross-validation)")
    ap.add_argument("--out", required=True,
                    help="output directory (one subdirectory per kernel)")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated subset (default: the full "
                         "ten-kernel library)")
    ap.add_argument("--table1", action="store_true",
                    help="restrict to the six Table-I kernels")
    ap.add_argument("--xval", action="store_true",
                    help="cross-validate the exported streams against "
                         "simulate() bit-for-bit")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated verification seeds for --xval")
    ap.add_argument("--device", default=None,
                    help="torch device of the --xval simulations "
                         "(default: the CUDA card; 'cpu' for the host)")
    args = ap.parse_args(argv)

    from repro_torch.core.kernels_lib import table1_kernels
    from repro_torch.core.toolchain import Toolchain
    from repro_torch.frontend.library import dsl_kernels
    from repro_torch.isa.encode import export_streams
    from repro_torch.isa.xval import cross_validate_dir

    suite = dict(table1_kernels(small=True))
    if not args.table1:
        suite.update(dsl_kernels())
    if args.kernels:
        names = args.kernels.split(",")
        unknown = [n for n in names if n not in suite]
        if unknown:
            ap.error(f"unknown kernels {unknown}; have {sorted(suite)}")
        suite = {n: suite[n] for n in names}

    tc = Toolchain()
    seeds = [int(s) for s in args.seeds.split(",")]
    cks = tc.compile_many(list(suite.values()))
    import os
    for name, ck in zip(suite, cks):
        out_dir = os.path.join(args.out, name)
        t0 = time.time()
        paths = export_streams(ck, out_dir)
        msg = (f"{name:<14} II={ck.II:<3d} -> {out_dir} "
               f"({(time.time() - t0) * 1e3:.1f} ms)")
        if args.xval:
            t0 = time.time()
            n = cross_validate_dir(ck, out_dir, seeds=seeds,
                                   device=args.device)
            msg += (f"  xval OK ({n} seed(s), "
                    f"{(time.time() - t0) * 1e3:.0f} ms)")
        print(msg)
        assert sorted(paths) == sorted(
            ("instructions.csv", "kernel.asm", "stream_manifest.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
