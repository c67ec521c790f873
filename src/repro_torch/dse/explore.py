"""Design-space sweep driver: fan the kernel library across architecture
variants with memoized compiles, batched verification and resumable
checkpointing.

For every :class:`~repro_torch.dse.space.ArchPoint` the driver builds the
ten-kernel suite (the six Table-I kernels at verification dims plus the
four DSL-only kernels) against that variant, compiles the whole suite
through ``Toolchain.compile_many`` (process fan-out; per-(arch, kernel)
results are content-addressed cache hits on re-runs), verifies each
mapped kernel with the batched IV-C engine, and scores it with
``costmodel.kernel_cost``.  Each mapping spans the variant's whole
fabric, so it is scored as one configured instance (``clusters=1``);
the variant's logical cluster count is reported as metadata only.

Infeasible points are results, not errors: a kernel that cannot be laid
out (bank overflow), mapped (MapError within ``ii_max``) or verified is
recorded with its status, and the variant simply drops out of the Pareto
candidate set.

Checkpointing: pass ``checkpoint=<path>`` and every finished variant is
flushed to JSON (atomic tmp+rename); an interrupted sweep resumes by
skipping variants already on disk.  The checkpoint records a fingerprint
of (mapper options, seeds, suite) and ignores stale files whose
fingerprint differs.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..core.adl import CGRAArch
from ..core.costmodel import WORD_BYTES, kernel_cost
from ..core.kernels_lib import KernelSpec, table1_kernels
from ..core.mapper import MapperOptions
from ..core.toolchain import Toolchain
from ..frontend.library import dsl_kernels
from .pareto import area_units
from .space import ArchPoint

# the ten-kernel library every variant is scored on, in report order
SUITE_KERNELS = ("GEMM", "GEMM-U", "GEMM-U-C", "CONV", "CONV-U-C-1",
                 "CONV-U-C-2", "dwconv", "avgpool2x2", "gemm-bias-relu",
                 "requant-int8")

CHECKPOINT_SCHEMA = 1


def kernel_suite(arch: CGRAArch) -> Dict[str, KernelSpec]:
    """The full kernel library bound to ``arch`` (Table-I verification
    dims + DSL kernels), keyed in ``SUITE_KERNELS`` order."""
    suite = {**table1_kernels(small=True, arch=arch), **dsl_kernels(arch)}
    return {k: suite[k] for k in SUITE_KERNELS}


# --------------------------------------------------------------- results
@dataclass
class KernelOutcome:
    """One (variant, kernel) cell of the sweep."""
    kernel: str
    status: str                   # ok | layout_error | map_error | verify_error
    II: int = 0
    mii: int = 0
    utilization: float = 0.0
    cycles_per_inv: int = 0
    invocations: int = 0
    compute_ms: float = 0.0
    total_ms: float = 0.0
    from_cache: bool = False
    cache_key: str = ""
    error: str = ""

    def to_json_dict(self) -> Dict:
        # from_cache is a property of the *run*, not the result — keeping
        # it out of the artifact is what makes cold and warm sweeps
        # byte-identical
        return {k: v for k, v in self.__dict__.items() if k != "from_cache"}

    @staticmethod
    def from_json_dict(d: Dict) -> "KernelOutcome":
        return KernelOutcome(**d)


@dataclass
class VariantResult:
    """One architecture variant: per-kernel outcomes + aggregate score."""
    name: str
    point: ArchPoint
    n_pes: int
    clusters: int
    area: int
    kernels: Dict[str, KernelOutcome] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        """Every suite kernel compiled AND verified on this variant."""
        return (len(self.kernels) == len(SUITE_KERNELS)
                and all(o.status == "ok" for o in self.kernels.values()))

    @property
    def mapped(self) -> int:
        return sum(1 for o in self.kernels.values() if o.status == "ok")

    @property
    def total_ms(self) -> float:
        """Suite latency: modeled total over all (verified) kernels."""
        return sum(o.total_ms for o in self.kernels.values()
                   if o.status == "ok")

    @property
    def mean_utilization(self) -> float:
        utils = [o.utilization for o in self.kernels.values()
                 if o.status == "ok"]
        return sum(utils) / len(utils) if utils else 0.0

    @property
    def max_ii(self) -> int:
        return max((o.II for o in self.kernels.values()
                    if o.status == "ok"), default=0)

    def to_json_dict(self) -> Dict:
        return {"name": self.name, "point": self.point.to_json_dict(),
                "n_pes": self.n_pes, "clusters": self.clusters,
                "area": self.area,
                "kernels": {k: o.to_json_dict()
                            for k, o in self.kernels.items()}}

    @staticmethod
    def from_json_dict(d: Dict) -> "VariantResult":
        return VariantResult(
            name=d["name"], point=ArchPoint.from_json_dict(d["point"]),
            n_pes=d["n_pes"], clusters=d["clusters"], area=d["area"],
            kernels={k: KernelOutcome.from_json_dict(o)
                     for k, o in d["kernels"].items()})


# ------------------------------------------------------------ checkpoint
def _fingerprint(options: MapperOptions, seeds: Sequence[int],
                 verify: bool,
                 suite: Optional[Sequence[str]] = None) -> Dict:
    # verify is part of the identity: resuming a --no-verify checkpoint
    # must not let unsimulated mappings pass as "fully verified".  The
    # fingerprint deliberately carries only what determines a point's
    # *evaluation* — never search hyper-parameters — so sweep and search
    # ledgers interoperate and a short search run is a valid resume
    # prefix of a longer one.
    return {"schema": CHECKPOINT_SCHEMA,
            "options": options.to_json_dict(),
            "seeds": list(seeds),
            "verify": bool(verify),
            "suite": list(SUITE_KERNELS if suite is None else suite)}


# paths already warned about this process (one warning per path per
# failure mode, not one per variant — a sweep stores after every variant)
_warned_store_paths: set = set()
_warned_corrupt_paths: set = set()


def _load_checkpoint(path: Optional[str], fp: Dict
                     ) -> Dict[str, VariantResult]:
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        if d.get("fingerprint") != fp:
            return {}  # different sweep configuration: start fresh
        return {name: VariantResult.from_json_dict(v)
                for name, v in d["variants"].items()}
    except (OSError, ValueError, KeyError, TypeError) as e:
        # corrupt checkpoint: recompute (cache soaks the cost) — but say
        # so, or an operator never learns their resume point was lost
        if path not in _warned_corrupt_paths:
            _warned_corrupt_paths.add(path)
            warnings.warn(
                f"DSE checkpoint {path!r} is unreadable "
                f"({type(e).__name__}: {e}); ignoring it and recomputing "
                f"(warm cache soaks the cost)", RuntimeWarning,
                stacklevel=3)
        return {}


def _store_checkpoint(path: Optional[str], fp: Dict,
                      done: Dict[str, VariantResult],
                      events: Optional[List[Dict]] = None) -> None:
    if not path:
        return
    blob_dict = {"fingerprint": fp,
                 "variants": {name: v.to_json_dict()
                              for name, v in sorted(done.items())}}
    if events:
        # fleet recovery ledger (timeouts, retries, evictions) — recorded
        # so an operator can audit a disturbed sweep; loaders ignore it,
        # and it never enters the byte-deterministic report artifacts
        blob_dict["events"] = events
    blob = json.dumps(blob_dict, sort_keys=True, indent=1)
    out_dir = os.path.dirname(os.path.abspath(path))
    try:
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(blob)
        os.replace(tmp, path)  # atomic: a killed sweep never corrupts it
    except OSError as e:
        # checkpointing is an optimization only — the sweep continues —
        # but a silently dead checkpoint costs hours on the next
        # interruption, so warn once per path
        if path not in _warned_store_paths:
            _warned_store_paths.add(path)
            warnings.warn(
                f"DSE checkpoint write to {path!r} failed "
                f"({type(e).__name__}: {e}); sweep progress is NOT being "
                f"saved and an interrupted sweep will restart from the "
                f"compile cache only", RuntimeWarning, stacklevel=3)


# ------------------------------------------------------------------ sweep
def _kernel_outcome(kname: str, spec, ck, status: str,
                    err: str) -> KernelOutcome:
    """The scored outcome of one mapped (variant, kernel) cell — shared
    by the per-variant and the batched evaluators so both emit identical
    results."""
    cost = kernel_cost(
        spec, ck.mapping,
        array_bytes_moved=sum(p.words for p in
                              spec.layout.placements.values())
        * WORD_BYTES)
    return KernelOutcome(
        kernel=kname, status=status, II=ck.II, mii=ck.mii,
        utilization=round(ck.utilization, 6),
        cycles_per_inv=cost.cycles_per_inv,
        invocations=cost.invocations,
        compute_ms=round(cost.compute_ms, 6),
        total_ms=round(cost.total_ms, 6),
        from_cache=ck.from_cache, cache_key=ck.cache_key, error=err)


def _static_check_wanted(static_check: Optional[bool]) -> bool:
    """DSE pre-screen opt-in: explicit argument wins, otherwise follow the
    MORPHER_CHECK=1 environment gate (so a checked CI run statically
    pre-screens every evaluated point at no configuration cost)."""
    if static_check is not None:
        return static_check
    from ..core.verify import check_enabled
    return check_enabled()


def _prescreen(ck) -> str:
    """Static legality pre-screen for one mapped point; returns the empty
    string when clean, else a summary of the first few diagnostics."""
    from ..check import check_kernel, errors
    found = errors(check_kernel(ck))
    if not found:
        return ""
    head = "; ".join(str(d) for d in found[:3])
    more = "" if len(found) <= 3 else f" (+{len(found) - 3} more)"
    return f"{len(found)} static diagnostic(s): {head}{more}"


def _score_variant(point: ArchPoint, arch: CGRAArch, tc: Toolchain,
                   seeds: Sequence[int], jobs: Optional[int],
                   verify: bool, fleet=None,
                   static_check: Optional[bool] = None,
                   device=None) -> VariantResult:
    # clusters is descriptive metadata here, NOT a cost divisor: the
    # mapper schedules each kernel across the variant's whole fabric
    # (one configured instance), so modeling extra data-parallel copies
    # on top would double-count the same PEs.  kernel_cost's clusters
    # division is for per-cluster mappings scaled to a multi-cluster
    # deployment (the Table-I convention).
    n_clusters = max(1, len(arch.clusters))
    result = VariantResult(name=point.name, point=point, n_pes=arch.n_pes,
                           clusters=n_clusters, area=area_units(arch))

    try:
        suite = kernel_suite(arch)
    except ValueError as e:
        # a kernel's arrays do not fit this variant's banks: the whole
        # suite is un-layoutable here (the builders share the bank scheme)
        result.kernels = {k: KernelOutcome(kernel=k, status="layout_error",
                                           error=str(e))
                          for k in SUITE_KERNELS}
        return result

    names = list(SUITE_KERNELS)
    do_check = _static_check_wanted(static_check)
    cks = tc.compile_many([suite[k] for k in names], jobs=jobs,
                          allow_unmapped=True, fleet=fleet)
    for kname, ck in zip(names, cks):
        if ck is None:
            reason = (tc.cached_map_error(suite[kname])
                      or f"unmappable within ii_max={tc.options.ii_max}")
            result.kernels[kname] = KernelOutcome(
                kernel=kname, status="map_error", error=reason)
            continue
        status, err = "ok", ""
        if do_check:
            bad = _prescreen(ck)
            if bad:
                status, err = "check_error", bad
        if verify and status == "ok":
            try:
                ck.verify_batch(seeds, device=device)
            except AssertionError as e:
                status, err = "verify_error", str(e)
        result.kernels[kname] = _kernel_outcome(kname, suite[kname], ck,
                                                status, err)
    return result


def evaluate_points(points: Sequence[ArchPoint], *,
                    toolchain: Optional[Toolchain] = None,
                    seeds: Sequence[int] = (0,),
                    jobs: Optional[int] = None,
                    verify: bool = True,
                    check_dfg: bool = True,
                    suite_names: Optional[Sequence[str]] = None,
                    fleet=None,
                    static_check: Optional[bool] = None,
                    device=None
                    ) -> List[VariantResult]:
    """Score a whole population of variants in one batched pass — the
    search driver's evaluator and the throughput path the
    ``dse_search`` benchmark measures.

    Produces :class:`VariantResult`\\ s identical to ``run_sweep``'s
    per-point scoring (same mapper, oracles, cost model, rounding — the
    results interleave freely in one checkpoint ledger); only the
    batching changes:

      * ONE ``compile_many`` fan-out across every (variant, kernel) unit
        of the population (instead of one per variant), and
      * stacked multi-architecture verification
        (:func:`repro_torch.core.toolchain.verify_stacked`): every group of
        mapped kernels sharing a shape bucket is a single cycle loop,
        so one loop scores dozens of candidate fabrics.

    ``suite_names`` restricts evaluation to a subset of
    ``SUITE_KERNELS`` — the successive-halving driver's partial-fidelity
    rungs.  A verify mismatch inside a stacked group (contract-breaking,
    so effectively never) falls back to per-kernel ``verify_batch`` to
    attribute the failure to its kernel.  Simulations and oracles run on
    ``device`` (``None``: the CUDA card); compiles stay on the host.
    """
    from ..core.toolchain import verify_stacked
    suite_names = list(suite_names or SUITE_KERNELS)
    tc = toolchain or Toolchain(options=MapperOptions(ii_max=20))
    results: List[VariantResult] = []
    units: List[tuple] = []               # (variant index, kernel, spec)
    for point in points:
        try:
            arch = point.build()
        except ValueError as e:
            vr = VariantResult(name=point.name, point=point, n_pes=0,
                               clusters=0, area=0)
            vr.kernels = {k: KernelOutcome(kernel=k, status="layout_error",
                                           error=str(e))
                          for k in suite_names}
            results.append(vr)
            continue
        vr = VariantResult(name=point.name, point=point, n_pes=arch.n_pes,
                           clusters=max(1, len(arch.clusters)),
                           area=area_units(arch))
        results.append(vr)
        try:
            suite = kernel_suite(arch)
        except ValueError as e:
            vr.kernels = {k: KernelOutcome(kernel=k, status="layout_error",
                                           error=str(e))
                          for k in suite_names}
            continue
        for k in suite_names:
            units.append((len(results) - 1, k, suite[k]))

    cks = tc.compile_many([spec for _, _, spec in units], jobs=jobs,
                          allow_unmapped=True, fleet=fleet)
    mapped: List[tuple] = []              # (variant index, kernel, spec, ck)
    for (vi, kname, spec), ck in zip(units, cks):
        if ck is None:
            reason = (tc.cached_map_error(spec)
                      or f"unmappable within ii_max={tc.options.ii_max}")
            results[vi].kernels[kname] = KernelOutcome(
                kernel=kname, status="map_error", error=reason)
        else:
            mapped.append((vi, kname, spec, ck))

    if _static_check_wanted(static_check) and mapped:
        # statically pre-screen every mapped point: flagged artifacts are
        # scored as check_error and never reach the (much more expensive)
        # stacked simulation — clean artifacts are unaffected, so frontier
        # bytes are unchanged when nothing fires
        screened: List[tuple] = []
        for vi, kname, spec, ck in mapped:
            bad = _prescreen(ck)
            if bad:
                results[vi].kernels[kname] = _kernel_outcome(
                    kname, spec, ck, "check_error", bad)
            else:
                screened.append((vi, kname, spec, ck))
        mapped = screened

    statuses: Dict[tuple, tuple] = {}
    if verify and mapped and len(seeds):
        try:
            verify_stacked([ck for *_, ck in mapped], seeds,
                           check_dfg=check_dfg, device=device)
            statuses = {(vi, k): ("ok", "") for vi, k, _, _ in mapped}
        except AssertionError:
            for vi, kname, _spec, ck in mapped:
                try:
                    ck.verify_batch(seeds, check_dfg=check_dfg,
                                    device=device)
                    statuses[(vi, kname)] = ("ok", "")
                except AssertionError as e:
                    statuses[(vi, kname)] = ("verify_error", str(e))
    else:
        statuses = {(vi, k): ("ok", "") for vi, k, _, _ in mapped}
    for vi, kname, spec, ck in mapped:
        status, err = statuses[(vi, kname)]
        results[vi].kernels[kname] = _kernel_outcome(kname, spec, ck,
                                                     status, err)
    for vr in results:  # report order: suite order, as _score_variant emits
        vr.kernels = {k: vr.kernels[k] for k in suite_names
                      if k in vr.kernels}
    return results


def run_sweep(points: Sequence[ArchPoint], *,
              seeds: Sequence[int] = (0,),
              options: Optional[MapperOptions] = None,
              toolchain: Optional[Toolchain] = None,
              checkpoint: Optional[str] = None,
              jobs: Optional[int] = None,
              verify: bool = True,
              workers: Optional[int] = None,
              faults=None,
              fleet=None,
              static_check: Optional[bool] = None,
              log: Optional[Callable[[str], None]] = None,
              device=None
              ) -> List[VariantResult]:
    """Sweep the kernel library across ``points``; returns one
    :class:`VariantResult` per point, in input order.

    Deterministic by construction: mapper search is seeded and
    wall-clock-free (the default options carry no time budget), scores
    come from the analytic cost model, and re-runs hit the toolchain's
    content-addressed cache — so two runs of the same sweep produce
    byte-identical reports, the second one warm.

    ``workers=N`` shards each variant's compile units across N
    supervised worker groups (:mod:`repro_torch.dist.fleet`): per-task
    deadlines, deterministic retry, killed-worker pool rebuilds,
    heartbeat eviction with work stealing.  ``faults`` injects a
    :class:`~repro_torch.dist.faults.FaultPlan` into those workers; because
    units are idempotent (content-addressed cache) and every finished
    variant checkpoints, a sweep with injected worker loss emits
    byte-identical artifacts to an undisturbed run — that is the
    robustness contract, pinned by tests and the dist-smoke CI job.
    ``fleet`` passes a full :class:`~repro_torch.dist.fleet.FleetConfig`
    instead (overrides ``workers``/``faults``).  Fleet recovery events
    are logged and recorded in the checkpoint's ``events`` section —
    timed-out and retried units are visible, never silently dropped.

    ``options`` configures the sweep's own Toolchain; when a ``toolchain``
    is passed its options govern (they feed every compile and the
    checkpoint fingerprint), so passing a *different* ``options`` too is
    a contradiction and raises.

    Verification simulates on ``device`` (``None``: the CUDA card); the
    compiles and their fleet workers never touch it.
    """
    if toolchain is not None and options is not None \
            and options != toolchain.options:
        raise ValueError("run_sweep: options conflicts with "
                         "toolchain.options; pass one or the other")
    if verify and not len(seeds):
        raise ValueError("run_sweep: verify=True needs at least one seed "
                         "(verify_batch over zero seeds checks nothing); "
                         "pass verify=False to skip verification "
                         "explicitly")
    options = options or MapperOptions(ii_max=20)
    tc = toolchain or Toolchain(options=options)
    say = log or (lambda s: None)

    if fleet is None and (workers is not None or faults is not None):
        from ..dist.fleet import FleetConfig
        fleet = FleetConfig(groups=workers or 2, faults=faults)

    fp = _fingerprint(tc.options, seeds, verify)
    done = _load_checkpoint(checkpoint, fp)
    if done:
        say(f"# checkpoint: {len(done)} variant(s) already swept")

    events: List[Dict] = []
    results: List[VariantResult] = []
    for i, point in enumerate(points):
        if point.name in done:
            results.append(done[point.name])
            continue
        t0 = time.time()
        try:
            arch = point.build()
        except ValueError as e:
            vr = VariantResult(name=point.name, point=point, n_pes=0,
                               clusters=0, area=0)
            vr.kernels = {k: KernelOutcome(kernel=k, status="layout_error",
                                           error=str(e))
                          for k in SUITE_KERNELS}
            done[point.name] = vr
            results.append(vr)
            _store_checkpoint(checkpoint, fp, done, events)
            say(f"[{i + 1}/{len(points)}] {point.name}: invalid ({e})")
            continue
        vr = _score_variant(point, arch, tc, seeds, jobs, verify,
                            fleet=fleet, static_check=static_check,
                            device=device)
        done[point.name] = vr
        results.append(vr)
        report = tc.last_fleet_report
        if report is not None and not report.quiet():
            # a disturbed fan-out: keep the recovery ledger with the
            # checkpoint (timed-out units are recorded, not dropped)
            events.append({"variant": point.name,
                           **report.events_json_dict()})
            say(f"# fleet[{point.name}]: "
                f"{len(report.timeouts)} timeout(s), "
                f"{report.retries} retrie(s), "
                f"{report.pool_rebuilds} pool rebuild(s), "
                f"evicted={report.evicted_groups}, "
                f"stolen={report.stolen_units}")
        _store_checkpoint(checkpoint, fp, done, events)
        say(f"[{i + 1}/{len(points)}] {point.name}: "
            f"{vr.mapped}/{len(SUITE_KERNELS)} kernels ok, "
            f"area={vr.area}, latency={vr.total_ms:.3f}ms "
            f"({time.time() - t0:.1f}s)")
    return results
