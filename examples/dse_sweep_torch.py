"""Design-space sweep CLI of the PyTorch port (``repro_torch.dse``):
explore CGRA architecture variants with the full compile/verify flow and
report the Pareto frontier.  Compiles run on the host (and in the
supervised fleet's worker processes); every verification simulates on
``--device``, by default the CUDA card.

For every variant of the chosen space (grid size, mesh/torus, register-
file size, bank count/size, heterogeneous ALU-lite interiors) the sweep
compiles the ten-kernel library (six Table-I kernels at verification
dims + four DSL kernels) through the unified Toolchain, verifies each
mapping with the batched IV-C engine, scores it with the cost model
against a deterministic area proxy, and writes:

  <out>/dse_frontier.json      full deterministic sweep report
  <out>/BENCH_dse_sweep.json   per-variant benchmark rows (modeled
                               latency; feeds --check-regression)

Per-(variant, kernel) compiles are memoized through the content-
addressed mapping cache, and finished variants checkpoint to
``<out>/dse_checkpoint.json`` — re-running a finished sweep is all cache
hits, and an interrupted sweep resumes where it stopped.  Two runs of
the same sweep produce byte-identical reports.

``--search nsga2|halving`` switches from exhaustive sweep to seeded
multi-objective search (repro_torch.dse.search): the space becomes the
candidate universe (use ``--space wide``), evaluation batches whole
populations per stacked cycle loop, and the artifacts gain the search
trajectory.  Search runs are byte-deterministic for a given
``--search-seed`` — cold, warm and checkpoint-resumed runs emit
identical ``dse_frontier.json`` bytes (CI's search-smoke job enforces
this with ``cmp``).

Run:  python examples/dse_sweep_torch.py --space small
      add --space tiny for the 4-variant CI smoke sweep
      add --device cpu to simulate on the host
      add --fresh to ignore an existing checkpoint
      add --search nsga2 --generations 4 --population 12 to search
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.core import MapperOptions, Toolchain  # noqa: E402
from repro_torch.dse import (SEARCH_ALGOS, SPACE_NAMES,  # noqa: E402
                             SearchConfig, frontier, frontier_table,
                             get_space, run_search, run_sweep,
                             write_artifacts)


def main():
    ap = argparse.ArgumentParser(
        description="CGRA architecture design-space explorer")
    ap.add_argument("--space", default="small", metavar="NAME",
                    help=f"variant set to sweep (one of "
                         f"{', '.join(SPACE_NAMES)}; default: small)")
    ap.add_argument("--search", default=None, choices=SEARCH_ALGOS,
                    metavar="ALGO",
                    help="search the space instead of sweeping it "
                         f"exhaustively (one of {', '.join(SEARCH_ALGOS)})")
    ap.add_argument("--generations", type=int, default=4, metavar="N",
                    help="search rounds: NSGA-II generations / halving "
                         "rungs (default: 4)")
    ap.add_argument("--population", type=int, default=12, metavar="N",
                    help="NSGA-II population per generation / halving "
                         "finalists (default: 12)")
    ap.add_argument("--search-seed", type=int, default=0, metavar="S",
                    help="search RNG seed; the whole trajectory is a pure "
                         "function of it (default: 0)")
    ap.add_argument("--mutation", type=float, default=0.25, metavar="P",
                    help="per-knob mutation probability (default: 0.25)")
    ap.add_argument("--out", default=".", metavar="DIR",
                    help="directory for report artifacts (default: cwd)")
    ap.add_argument("--seeds", type=int, default=1, metavar="N",
                    help="verification seeds per kernel (default: 1)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="compile fan-out width (default: auto)")
    ap.add_argument("--ii-max", type=int, default=20,
                    help="mapper II escalation cap (default: 20)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint file (default: <out>/"
                         "dse_checkpoint.json; '' disables)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore any existing checkpoint")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip simulation-based verification (score only)")
    ap.add_argument("--workers", type=int, default=None, metavar="N",
                    help="shard compile work units across N supervised "
                         "worker groups (repro_torch.dist.fleet: deadlines, "
                         "retry, killed-worker recovery, work stealing)")
    ap.add_argument("--inject-faults", action="store_true",
                    help="deterministically kill one compile worker and "
                         "delay one straggler past its deadline "
                         "(repro_torch.dist.faults); the sweep must still emit "
                         "byte-identical artifacts")
    ap.add_argument("--task-timeout-s", type=float, default=None,
                    metavar="S",
                    help="per-work-unit deadline (default: "
                         "$MORPHER_TASK_TIMEOUT_S or 300; --inject-faults "
                         "defaults it to 15 so the straggler is visible)")
    ap.add_argument("--device", default=None,
                    help="torch device the verifications simulate on "
                         "(default: the CUDA card; 'cpu' for the host)")
    ap.add_argument("--cache-dir", default=None,
                    help="mapping cache dir (default: $MORPHER_CACHE_DIR "
                         "or ~/.cache/morpher-toolchain)")
    args = ap.parse_args()
    if args.seeds < 1:
        ap.error("--seeds must be >= 1 (use --no-verify to skip "
                 "simulation-based verification explicitly)")
    if args.search and (args.generations < 1 or args.population < 2):
        ap.error("--search needs --generations >= 1 and --population >= 2")

    try:
        points = get_space(args.space)
    except ValueError as e:
        ap.error(str(e))  # unknown --space: list the valid SPACE_NAMES
    checkpoint = args.checkpoint
    if checkpoint is None:
        checkpoint = f"{args.out}/dse_checkpoint.json"
    elif checkpoint == "":
        checkpoint = None
    if args.fresh and checkpoint:
        if os.path.exists(checkpoint):
            os.unlink(checkpoint)

    fleet_cfg = None
    if args.workers or args.inject_faults:
        from repro_torch.dist.faults import FaultPlan
        from repro_torch.dist.fleet import FleetConfig
        timeout_s = args.task_timeout_s
        faults = None
        if args.inject_faults:
            # one killed worker + one straggler sleeping past its
            # deadline, fire-once each — the canonical disturbance the
            # dist-smoke CI job byte-compares against the undisturbed
            # baseline
            timeout_s = timeout_s if timeout_s is not None else 15.0
            faults = FaultPlan(kill_units=(1,),
                               delay_units=((2, 2.5 * timeout_s),)).armed()
            print(f"# fault injection: kill unit 1, delay unit 2 by "
                  f"{2.5 * timeout_s:g}s (deadline {timeout_s:g}s)")
        fleet_cfg = FleetConfig(groups=args.workers or 2,
                                timeout_s=timeout_s, faults=faults)

    tc = Toolchain(options=MapperOptions(ii_max=args.ii_max),
                   cache_dir=args.cache_dir)
    seeds = list(range(args.seeds))
    search_extra = None
    bench_name = "dse_sweep"
    t0 = time.time()
    if args.search:
        cfg = SearchConfig(algo=args.search, seed=args.search_seed,
                           generations=args.generations,
                           population=args.population,
                           mutation=args.mutation)
        print(f"# searching {len(points)}-point universe with "
              f"{cfg.algo} (seed={cfg.seed}, generations="
              f"{cfg.generations}, population={cfg.population}"
              + (f", workers={fleet_cfg.groups}" if fleet_cfg else "") + ")")
        sr = run_search(points, cfg, seeds=seeds, toolchain=tc,
                        checkpoint=checkpoint, jobs=args.jobs,
                        verify=not args.no_verify, fleet=fleet_cfg,
                        log=print, device=args.device)
        results = sr.evaluated
        bench_name = "dse_search"
        search_extra = {"search": {"config": cfg.to_json_dict(),
                                   "population": sr.population,
                                   "history": sr.history,
                                   "n_requested": sr.n_requested,
                                   "n_partial": sr.n_partial}}
    else:
        print(f"# sweeping {len(points)} variants x ten kernels "
              f"(space={args.space}, seeds={seeds}"
              + (f", workers={fleet_cfg.groups}" if fleet_cfg else "") + ")")
        results = run_sweep(points, seeds=seeds, toolchain=tc,
                            checkpoint=checkpoint, jobs=args.jobs,
                            verify=not args.no_verify, fleet=fleet_cfg,
                            log=print, device=args.device)
    dt = time.time() - t0

    print()
    print(frontier_table(results))
    front = frontier(results)
    ok = sum(1 for r in results if r.ok)
    verb = "searched" if args.search else "swept"
    print(f"\n# {ok}/{len(results)} variants fully verified, "
          f"{len(front)} on the Pareto frontier, {verb} in {dt:.1f}s "
          f"(warm re-runs are cache hits)")
    paths = write_artifacts(results, args.out, space=args.space,
                            seeds=seeds, verified=not args.no_verify,
                            bench_name=bench_name, extra=search_extra)
    for name, path in paths.items():
        print(f"# wrote {path}")


if __name__ == "__main__":
    main()
