"""Seeded multi-objective design-space search (ROADMAP item 3).

Exhaustive enumeration caps out at ``full_space()``; this driver explores
the widened universe (``wide_space()`` and beyond) with two classic
budgeted strategies, both **byte-deterministic**:

  nsga2    an NSGA-II-style evolutionary loop: non-dominated sorting with
           crowding distance over the (suite latency, area) objectives,
           binary-tournament parent selection, uniform knob crossover and
           seeded mutation over the universe's ``axis_domains``.
  halving  successive halving: start from ``population * eta**(rungs-1)``
           sampled candidates, evaluate each rung on a growing prefix of
           the kernel suite (cheap partial-fidelity scoring, no verify),
           keep the best ``1/eta`` per rung, and evaluate the survivors
           at full fidelity on the last rung.

Determinism contract (the search extension of the DSE contract): the RNG
is ``random.Random(config.seed)`` consumed in a fixed trajectory, scores
are the analytic cost model, and there are **no wall-clock budgets** — so
cold, warm, resumed and fleet-faulted runs emit byte-identical
``dse_frontier.json`` artifacts (pinned by ``tests/test_search.py`` and
the CI ``search-smoke`` job).  Resume works by *replaying* the whole
trajectory: every point evaluation is memoized in the
:mod:`repro_torch.dse.explore` checkpoint ledger (fingerprint =
(options, seeds, verify, suite) — deliberately free of search
hyper-parameters), so the replay costs ledger lookups, a short run's
checkpoint is a valid prefix of a longer one, and sweep and search
ledgers interoperate.  Partial-fidelity (halving rung) evaluations are
stored under ``<name>@<k>nv`` keys that no :class:`ArchPoint` name can
collide with; ``run_sweep`` simply ignores them.

Evaluation is the batched path (:func:`repro_torch.dse.explore.evaluate_points`):
one ``compile_many`` fan-out per round across every (variant, kernel)
unit, then stacked multi-architecture verification — one cycle loop per
shape bucket scores the whole cohort (``BENCH_dse_search``'s
evaluated-points-per-second headline).
"""
from __future__ import annotations

import math
import random
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.mapper import MapperOptions
from ..core.toolchain import Toolchain
from .explore import (SUITE_KERNELS, VariantResult, _fingerprint,
                      _load_checkpoint, _store_checkpoint, evaluate_points)
from .space import ArchPoint, axis_domains, crossover, mutate

SEARCH_ALGOS = ("nsga2", "halving")


@dataclass(frozen=True)
class SearchConfig:
    """Hyper-parameters of one search run.  None of these enter the
    checkpoint fingerprint — evaluations are pure functions of
    (point, options, seeds, verify, suite) — so ledgers are shared
    across budgets and algorithms."""
    algo: str = "nsga2"
    seed: int = 0
    generations: int = 4          # nsga2: rounds; halving: rungs
    population: int = 12          # nsga2: per generation; halving: finalists
    mutation: float = 0.25        # per-knob mutation probability
    crossover: float = 0.9        # probability a child crosses two parents
    eta: int = 2                  # halving keep-fraction denominator

    def to_json_dict(self) -> Dict:
        return asdict(self)


@dataclass
class SearchResult:
    """Everything a search run produced, in trajectory order."""
    evaluated: List[VariantResult]      # full-fidelity evals, first-eval order
    population: List[str]               # final population / survivors (names)
    history: List[Dict] = field(default_factory=list)
    n_requested: int = 0                # point-evals requested (incl. repeats)
    n_partial: int = 0                  # partial-fidelity evals (halving rungs)


# ------------------------------------------------------------- objectives
def _objectives(vr: VariantResult,
                n_kernels: int) -> Optional[Tuple[float, int]]:
    """The (suite latency, area) minimization objectives — or None when
    the variant failed any evaluated kernel (infeasible points rank
    behind every feasible front)."""
    if (len(vr.kernels) == n_kernels
            and all(o.status == "ok" for o in vr.kernels.values())):
        return (round(vr.total_ms, 6), vr.area)
    return None


def _dominates(a: Tuple[float, int], b: Tuple[float, int]) -> bool:
    return a[0] <= b[0] and a[1] <= b[1] and a != b


def _fronts(items: Sequence[Tuple[str, Optional[Tuple[float, int]]]]
            ) -> List[List[str]]:
    """Non-dominated sorting: feasible fronts first (each sorted by name),
    then one trailing front of every infeasible point."""
    feas = {n: o for n, o in items if o is not None}
    fronts: List[List[str]] = []
    remaining = dict(feas)
    while remaining:
        front = sorted(
            n for n, o in remaining.items()
            if not any(_dominates(o2, o) for n2, o2 in remaining.items()
                       if n2 != n))
        fronts.append(front)
        for n in front:
            del remaining[n]
    infeas = sorted(n for n, o in items if o is None)
    if infeas:
        fronts.append(infeas)
    return fronts


def _crowding(front: Sequence[str],
              objs: Dict[str, Tuple[float, int]]) -> Dict[str, float]:
    """NSGA-II crowding distance within one feasible front (boundary
    points are infinitely crowded-distant, i.e. always kept)."""
    if len(front) <= 2:
        return {n: math.inf for n in front}
    d = {n: 0.0 for n in front}
    for k in range(2):
        s = sorted(front, key=lambda n: (objs[n][k], n))
        d[s[0]] = d[s[-1]] = math.inf
        span = float(objs[s[-1]][k] - objs[s[0]][k])
        if span <= 0:
            continue
        for i in range(1, len(s) - 1):
            if d[s[i]] != math.inf:
                d[s[i]] += (objs[s[i + 1]][k] - objs[s[i - 1]][k]) / span
    return d


def _rank(points: Sequence[ArchPoint],
          results: Dict[str, VariantResult], n_kernels: int
          ) -> Tuple[Dict[str, int], Dict[str, float]]:
    """(front index, crowding distance) per point name — the NSGA-II
    fitness ordering (lower front wins; within a front, higher crowding
    wins; ties break by name)."""
    items = [(p.name, _objectives(results[p.name], n_kernels))
             for p in points]
    objs = {n: o for n, o in items if o is not None}
    rank: Dict[str, int] = {}
    crowd: Dict[str, float] = {}
    for fi, front in enumerate(_fronts(items)):
        cd = (_crowding(front, objs) if front[0] in objs
              else {n: 0.0 for n in front})
        for n in front:
            rank[n] = fi
            crowd[n] = cd[n]
    return rank, crowd


def _select(points: Sequence[ArchPoint],
            results: Dict[str, VariantResult], n_kernels: int,
            n: int) -> List[ArchPoint]:
    """Environmental selection: fill by front; the cut front orders by
    descending crowding distance, ties by name.  Deterministic."""
    by_name = {p.name: p for p in points}
    items = [(p.name, _objectives(results[p.name], n_kernels))
             for p in points]
    objs = {nm: o for nm, o in items if o is not None}
    chosen: List[str] = []
    for front in _fronts(items):
        if len(chosen) + len(front) <= n:
            chosen.extend(front)
        else:
            cd = (_crowding(front, objs) if front[0] in objs
                  else {nm: 0.0 for nm in front})
            rest = sorted(front, key=lambda nm: (-cd[nm], nm))
            chosen.extend(rest[:n - len(chosen)])
            break
    return [by_name[nm] for nm in chosen]


def _tournament(rng: random.Random, names: Sequence[str],
                rank: Dict[str, int], crowd: Dict[str, float]) -> str:
    """Binary tournament on (front, -crowding, name)."""
    a = names[rng.randrange(len(names))]
    b = names[rng.randrange(len(names))]
    ka = (rank[a], -crowd[a], a)
    kb = (rank[b], -crowd[b], b)
    return a if ka <= kb else b


def _sample(rng: random.Random, universe: Sequence[ArchPoint],
            n: int) -> List[ArchPoint]:
    """Seeded sample of n distinct points from the universe."""
    n = min(n, len(universe))
    return [universe[i] for i in rng.sample(range(len(universe)), n)]


# ------------------------------------------------------------------ driver
def run_search(points: Sequence[ArchPoint],
               config: Optional[SearchConfig] = None, *,
               seeds: Sequence[int] = (0,),
               options: Optional[MapperOptions] = None,
               toolchain: Optional[Toolchain] = None,
               checkpoint: Optional[str] = None,
               jobs: Optional[int] = None,
               verify: bool = True,
               workers: Optional[int] = None,
               faults=None,
               fleet=None,
               suite: Optional[Sequence[str]] = None,
               log: Optional[Callable[[str], None]] = None,
               device=None
               ) -> SearchResult:
    """Run a seeded multi-objective search over the candidate universe
    ``points``.

    The universe defines the gene pool (``axis_domains``): crossover and
    mutation may visit knob combinations absent from the input list —
    that widening is the point.  Checkpointing, fleet fan-out, and the
    ``options``/``toolchain``/``verify`` semantics match
    :func:`repro_torch.dse.explore.run_sweep` (the ledger is shared); see the
    module docstring for the determinism/resume contract.

    ``suite`` restricts scoring to a subset of ``SUITE_KERNELS`` (tests
    and quick scans); it enters the checkpoint fingerprint.  Returns a
    :class:`SearchResult` whose ``evaluated`` list (full-fidelity
    evaluations, first-evaluation order) feeds
    :func:`repro_torch.dse.pareto.write_artifacts` unchanged.
    Verification simulates on ``device`` (``None``: the CUDA card).
    """
    config = config or SearchConfig()
    if config.algo not in SEARCH_ALGOS:
        raise ValueError(f"unknown search algo {config.algo!r} "
                         f"(choose from {SEARCH_ALGOS})")
    if config.population < 2:
        raise ValueError("run_search: population must be >= 2")
    if config.generations < 1:
        raise ValueError("run_search: generations must be >= 1")
    if config.algo == "halving" and config.eta < 2:
        raise ValueError("run_search: halving needs eta >= 2")
    if toolchain is not None and options is not None \
            and options != toolchain.options:
        raise ValueError("run_search: options conflicts with "
                         "toolchain.options; pass one or the other")
    if verify and not len(seeds):
        raise ValueError("run_search: verify=True needs at least one seed; "
                         "pass verify=False to skip verification explicitly")
    universe = list(points)
    if not universe:
        raise ValueError("run_search: empty candidate universe")
    options = options or MapperOptions(ii_max=20)
    tc = toolchain or Toolchain(options=options)
    say = log or (lambda s: None)
    if fleet is None and (workers is not None or faults is not None):
        from ..dist.fleet import FleetConfig
        fleet = FleetConfig(groups=workers or 2, faults=faults)

    suite_names = list(suite if suite is not None else SUITE_KERNELS)
    unknown = [k for k in suite_names if k not in SUITE_KERNELS]
    if unknown or not suite_names:
        raise ValueError(f"run_search: unknown suite kernel(s) {unknown} "
                         f"(choose from {list(SUITE_KERNELS)})")
    n_full = len(suite_names)
    fp = _fingerprint(tc.options, seeds, verify, suite=suite_names)
    ledger = _load_checkpoint(checkpoint, fp)
    if ledger:
        say(f"# checkpoint: {len(ledger)} evaluation(s) on ledger")

    domains = axis_domains(universe)
    rng = random.Random(config.seed)
    events: List[Dict] = []
    history: List[Dict] = []
    order: List[str] = []          # full-fidelity names, first-eval order
    seen_full: set = set()
    n_requested = 0
    n_partial = 0

    def evaluate(pts: Sequence[ArchPoint], n_kernels: int,
                 vflag: bool) -> List[VariantResult]:
        """Resolve one fidelity level for each point: ledger hits replay
        for free, the rest go through ONE batched evaluate_points call.
        Results are independent of the hit/miss split — that is the
        resume contract."""
        nonlocal n_requested, n_partial
        # full fidelity = whole suite AND the run's verify policy; a
        # whole-suite-but-unverified rung (tiny suites clamp there) is
        # still partial and must not publish under the plain name key
        full = n_kernels == n_full and vflag == verify

        def key(p: ArchPoint) -> str:
            return p.name if full else f"{p.name}@{n_kernels}nv"

        n_requested += len(pts)
        if not full:
            n_partial += len(pts)
        uniq: List[ArchPoint] = []
        seen = set()
        for p in pts:
            if key(p) not in seen:
                seen.add(key(p))
                uniq.append(p)
        todo = [p for p in uniq if key(p) not in ledger]
        if todo:
            res = evaluate_points(todo, toolchain=tc, seeds=seeds,
                                  jobs=jobs, verify=vflag,
                                  suite_names=suite_names[:n_kernels],
                                  fleet=fleet, device=device)
            for p, vr in zip(todo, res):
                ledger[key(p)] = vr
            report = tc.last_fleet_report
            if report is not None and not report.quiet():
                events.append({"round": len(history),
                               **report.events_json_dict()})
                say(f"# fleet[round {len(history)}]: "
                    f"{len(report.timeouts)} timeout(s), "
                    f"{report.retries} retrie(s), "
                    f"{report.pool_rebuilds} pool rebuild(s)")
            _store_checkpoint(checkpoint, fp, ledger, events)
        if full:
            for p in uniq:
                if p.name not in seen_full:
                    seen_full.add(p.name)
                    order.append(p.name)
        return [ledger[key(p)] for p in pts]

    if config.algo == "nsga2":
        pop = _sample(rng, universe, config.population)
        res = evaluate(pop, n_full, verify)
        by_name = {p.name: r for p, r in zip(pop, res)}
        feas = sum(1 for p in pop
                   if _objectives(by_name[p.name], n_full) is not None)
        history.append({"round": 0, "evaluated": [p.name for p in pop],
                        "population": [p.name for p in pop],
                        "feasible": feas})
        say(f"[gen 1/{config.generations}] evaluated {len(pop)} "
            f"point(s), {feas} feasible")
        for gen in range(1, config.generations):
            rank, crowd = _rank(pop, by_name, n_full)
            names = [p.name for p in pop]
            by_point = {p.name: p for p in pop}
            offspring: List[ArchPoint] = []
            taken = set(names)
            guard = 0
            while (len(offspring) < config.population
                   and guard < config.population * 20):
                guard += 1
                pa = by_point[_tournament(rng, names, rank, crowd)]
                pb = by_point[_tournament(rng, names, rank, crowd)]
                child = (crossover(rng, pa, pb)
                         if rng.random() < config.crossover else pa)
                child = mutate(rng, child, domains, config.mutation)
                if child.name in taken:
                    continue
                taken.add(child.name)
                offspring.append(child)
            res_off = evaluate(offspring, n_full, verify)
            for p, r in zip(offspring, res_off):
                by_name[p.name] = r
            pool = pop + offspring
            pop = _select(pool, by_name, n_full, config.population)
            feas = sum(1 for p in pop
                       if _objectives(by_name[p.name], n_full) is not None)
            history.append({"round": gen,
                            "evaluated": [p.name for p in offspring],
                            "population": [p.name for p in pop],
                            "feasible": feas})
            say(f"[gen {gen + 1}/{config.generations}] "
                f"{len(offspring)} offspring, population {len(pop)}, "
                f"{feas} feasible")
    else:  # successive halving
        rungs = config.generations
        cands = _sample(rng, universe,
                        config.population * config.eta ** (rungs - 1))
        for r in range(rungs):
            last = r == rungs - 1
            if last:
                n_k, vflag = n_full, verify
            else:
                n_k = max(1, min(n_full - 1,
                                 -(-n_full * (r + 1) // rungs)))
                vflag = False
            res = evaluate(cands, n_k, vflag)
            by_name = {p.name: vr for p, vr in zip(cands, res)}
            feas = sum(1 for p in cands
                       if _objectives(by_name[p.name], n_k) is not None)
            say(f"[rung {r + 1}/{rungs}] {len(cands)} candidate(s) at "
                f"{n_k}/{n_full} kernels"
                f"{' + verify' if vflag and verify else ''}, "
                f"{feas} feasible")
            if last:
                pop = _select(cands, by_name, n_k, config.population)
            else:
                keep = max(config.population, -(-len(cands) // config.eta))
                pop = _select(cands, by_name, n_k, keep)
            history.append({"round": r, "fidelity": n_k,
                            "evaluated": [p.name for p in cands],
                            "population": [p.name for p in pop],
                            "feasible": feas})
            cands = pop

    return SearchResult(
        evaluated=[ledger[name] for name in order],
        population=[p.name for p in pop],
        history=history, n_requested=n_requested, n_partial=n_partial)
