"""CLI: static legality checking over the kernel library.

    python -m repro_torch.check --out report                # ten kernels, small
    python -m repro_torch.check --out report --table1       # six Table-I kernels
    python -m repro_torch.check --out report --arch cluster_4x4,torus_4x4
    python -m repro_torch.check --out report --mutate       # + corruption gate

Writes ``<out>/check_report.json`` — the byte-deterministic audit of
every kernel's mapping, configuration and instruction stream (two runs
``cmp`` identical; the CI ``check-smoke`` determinism check).  With
``--mutate`` also runs the seeded corruption corpus
(:mod:`repro_torch.check.mutate`, its probes simulating on ``--device``,
default the CUDA card) and writes ``<out>/mutation_report.json``;
the exit code is non-zero if any diagnostic fires on the clean library
or the mutation gate fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

_ARCHS = ("cluster_4x4", "torus_4x4", "morpher_8x8")


def _build_arch(name: str):
    import dataclasses

    from repro_torch.core.adl import cluster_4x4, morpher_8x8
    if name == "cluster_4x4":
        return cluster_4x4()
    if name == "torus_4x4":
        return dataclasses.replace(cluster_4x4(),
                                   name="morpher-cluster-4x4-torus",
                                   torus=True)
    if name == "morpher_8x8":
        return morpher_8x8()
    raise ValueError(f"unknown arch {name!r}; have {_ARCHS}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="static legality audit of compiled kernel artifacts")
    ap.add_argument("--out", default=".",
                    help="directory for check_report.json (default: .)")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated subset (default: the full "
                         "ten-kernel library)")
    ap.add_argument("--table1", action="store_true",
                    help="restrict to the six Table-I kernels")
    ap.add_argument("--arch", default="cluster_4x4",
                    help=f"comma-separated target(s) from {_ARCHS} "
                         f"(default: cluster_4x4; multi-arch entries are "
                         f"keyed '<arch>/<kernel>')")
    ap.add_argument("--mutate", action="store_true",
                    help="also run the seeded corruption corpus and "
                         "enforce the mutation gate")
    ap.add_argument("--seed", type=int, default=0,
                    help="corpus seed for --mutate (default: 0)")
    ap.add_argument("--per-class", type=int, default=2,
                    help="mutants per (kernel, class) for --mutate")
    ap.add_argument("--device", default=None,
                    help="torch device of --mutate's dead-mutant probes "
                         "(default: the CUDA card; 'cpu' for the host)")
    args = ap.parse_args(argv)

    from repro_torch.check import check_kernel, errors, report_json
    from repro_torch.core.kernels_lib import table1_kernels
    from repro_torch.core.toolchain import Toolchain
    from repro_torch.frontend.library import dsl_kernels

    arch_names = args.arch.split(",")
    for a in arch_names:
        if a not in _ARCHS:
            ap.error(f"unknown arch {a!r}; have {_ARCHS}")

    tc = Toolchain()
    per_kernel = {}
    n_errors = 0
    all_cks = []
    for aname in arch_names:
        arch = _build_arch(aname)
        if aname == "cluster_4x4":
            suite = dict(table1_kernels(small=True))
            if not args.table1:
                suite.update(dsl_kernels())
        else:
            # non-default targets take the arch-parameterized DSE suite
            from repro_torch.dse.explore import kernel_suite
            suite = kernel_suite(arch)
            if args.table1:
                suite = {k: v for k, v in suite.items()
                         if k.lower().startswith(("gemm", "conv"))
                         and "bias" not in k.lower()}
        if args.kernels:
            names = args.kernels.split(",")
            unknown = [n for n in names if n not in suite]
            if unknown:
                ap.error(f"unknown kernels {unknown}; have {sorted(suite)}")
            suite = {n: suite[n] for n in names}
        t0 = time.time()
        cks = tc.compile_many(list(suite.values()))
        all_cks.extend(cks)
        for name, ck in zip(suite, cks):
            t1 = time.time()
            diags = check_kernel(ck)
            bad = errors(diags)
            n_errors += len(bad)
            key = name if len(arch_names) == 1 else f"{aname}/{name}"
            per_kernel[key] = {"II": ck.II, "cache_key": ck.cache_key,
                               "diagnostics": diags}
            print(f"{key:<28} II={ck.II:<3d} diagnostics={len(bad)} "
                  f"({(time.time() - t1) * 1e3:.1f} ms)")
            for d in bad[:5]:
                print(f"    {d}")
        print(f"# {aname}: {len(suite)} kernel(s) in "
              f"{time.time() - t0:.2f}s")

    os.makedirs(args.out, exist_ok=True)
    report_path = os.path.join(args.out, "check_report.json")
    with open(report_path, "w") as f:
        f.write(report_json(per_kernel))
    print(f"# wrote {report_path} ({n_errors} error diagnostic(s))")

    rc = 0 if n_errors == 0 else 1
    if args.mutate:
        from repro_torch.check.mutate import (MIN_SCORE, mutation_gate,
                                              run_corpus)
        t0 = time.time()
        try:
            rep = mutation_gate(all_cks, seed=args.seed,
                                per_class=args.per_class,
                                device=args.device)
            gate = "PASS"
        except AssertionError as e:
            rep = run_corpus(all_cks, seed=args.seed,
                             per_class=args.per_class, device=args.device)
            gate = "FAIL"
            print(e)
            rc = 1
        mut_path = os.path.join(args.out, "mutation_report.json")
        with open(mut_path, "w") as f:
            f.write(json.dumps(rep.to_json_dict(), sort_keys=True,
                               separators=(",", ":")) + "\n")
        print(f"# mutation gate {gate}: score {rep.score:.3f} "
              f"(>= {MIN_SCORE} required) over {rep.total} mutants, "
              f"{len(rep.live_misses)} live miss(es) "
              f"({time.time() - t0:.1f}s) -> {mut_path}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
