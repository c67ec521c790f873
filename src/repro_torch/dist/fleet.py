"""Supervised, elastic work-queue execution over the shared process pool.

``run_fleet(fn, payloads)`` is the fleet-scale counterpart of
``core.pool.process_map``: same contract (``[fn(p) for p in payloads]``,
order preserved), but each work unit is *supervised* —

  * per-task deadline (``MORPHER_TASK_TIMEOUT_S``): a straggler is timed
    out, recorded, and re-queued; its late result is harvested if it
    lands before the retry does;
  * bounded retry with a deterministic exponential backoff schedule
    (``MORPHER_FLEET_RETRIES``; see :func:`backoff_schedule`);
  * killed workers: ``BrokenProcessPool`` triggers a pool rebuild and
    re-queues every in-flight unit (not charged against their retry
    budget — the infrastructure died, not the unit);
  * worker groups with heartbeat-based elastic membership: units shard
    across ``groups`` logical groups, each with its own in-flight
    window; a group silent past the heartbeat timeout is evicted and
    its queued units are stolen by the survivors, exactly once;
  * graceful degradation: no pool (nested worker, REPL main, sandbox,
    or rebuild budget exhausted) -> sequential inline execution.

Work units MUST be idempotent (the toolchain's content-addressed cache
already makes compiles so): recovery re-executes units, and only
idempotence makes recovery exact — the robustness contract is that a
run with injected worker loss returns results identical to an
undisturbed sequential run.  Fault injection (:mod:`repro_torch.dist.faults`)
rides inside each unit's payload, so the failure paths above are
first-class tested code.
"""
from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import wait as _futures_wait
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import pool
from .elastic import HeartbeatMonitor
from .faults import FaultPlan

TIMEOUT_ENV = "MORPHER_TASK_TIMEOUT_S"
RETRIES_ENV = "MORPHER_FLEET_RETRIES"
DEFAULT_TIMEOUT_S = 300.0
DEFAULT_RETRIES = 2


class FleetError(RuntimeError):
    """A work unit failed beyond its retry budget.  Callers with a
    bit-identical sequential fallback (the toolchain) catch this and
    degrade; others propagate it."""


def backoff_schedule(retries: int, base_s: float = 0.05,
                     cap_s: float = 1.0) -> Tuple[float, ...]:
    """The deterministic re-queue delays: ``base * 2**attempt`` capped.
    A pure function of its arguments, so two runs retry on the same
    schedule — no jitter, by design (determinism beats thundering-herd
    avoidance at this scale)."""
    return tuple(min(cap_s, base_s * (2 ** k)) for k in range(retries))


@dataclass
class FleetConfig:
    """Knobs for one fleet run.  ``timeout_s``/``retries`` default to the
    ``MORPHER_TASK_TIMEOUT_S``/``MORPHER_FLEET_RETRIES`` env vars."""
    groups: int = 1                 # worker groups to shard units across
    timeout_s: Optional[float] = None      # per-task deadline
    retries: Optional[int] = None          # retry budget per unit
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    heartbeat_timeout_s: Optional[float] = None   # default: 2 * timeout_s
    poll_s: float = 0.02            # supervisor wakeup period
    max_inflight: Optional[int] = None     # default: pool width
    faults: Optional[FaultPlan] = None

    def resolved_timeout_s(self) -> float:
        if self.timeout_s is not None:
            return float(self.timeout_s)
        return float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))

    def resolved_retries(self) -> int:
        if self.retries is not None:
            return int(self.retries)
        return int(os.environ.get(RETRIES_ENV, DEFAULT_RETRIES))

    def resolved_heartbeat_s(self, timeout_s: float) -> float:
        if self.heartbeat_timeout_s is not None:
            return float(self.heartbeat_timeout_s)
        return 2.0 * timeout_s


@dataclass
class FleetReport:
    """Results plus the recovery ledger of one run.  ``results`` is in
    payload order; the ledger (timings-dependent) is observability data
    and deliberately kept out of every byte-deterministic artifact."""
    results: Optional[List] = None
    sequential: bool = False        # ran on the inline fallback path
    retries: int = 0
    timeouts: List[Dict] = field(default_factory=list)  # {unit, attempt}
    pool_rebuilds: int = 0
    evicted_groups: List[int] = field(default_factory=list)
    stolen_units: List[int] = field(default_factory=list)

    def quiet(self) -> bool:
        """True when the run saw no faults, timeouts or degradation."""
        return not (self.retries or self.timeouts or self.pool_rebuilds
                    or self.evicted_groups or self.stolen_units
                    or self.sequential)

    def events_json_dict(self) -> Dict:
        return {"retries": self.retries,
                "timeouts": list(self.timeouts),
                "pool_rebuilds": self.pool_rebuilds,
                "evicted_groups": list(self.evicted_groups),
                "stolen_units": list(self.stolen_units),
                "sequential": self.sequential}


def _run_unit(blob):
    """Pool-worker entry: fire any scripted fault for this unit, then run
    the real work function."""
    unit, plan_dict, fn, payload = blob
    if plan_dict is not None:
        FaultPlan.from_json_dict(plan_dict).fire_unit(unit)
    return fn(payload)


def run_fleet(fn: Callable, payloads: Sequence,
              config: Optional[FleetConfig] = None, *,
              inline_fallback: bool = True,
              log: Optional[Callable[[str], None]] = None) -> FleetReport:
    """``[fn(p) for p in payloads]`` across supervised worker groups.

    ``fn`` must be a picklable module-level function over picklable
    payloads, and idempotent (units may re-execute during recovery).
    With ``inline_fallback=False``, an unavailable pool returns
    ``results=None`` instead of computing inline — for callers that own
    a cheaper sequential path (``Toolchain.compile_many``).

    Raises :class:`FleetError` when a unit keeps failing (exception or
    deadline) past its retry budget.  Worker loss, stragglers and
    evictions are recovered transparently and recorded in the report.
    """
    cfg = config or FleetConfig()
    say = log or (lambda s: None)
    rep = FleetReport()
    n = len(payloads)
    if n == 0:
        rep.results = []
        return rep
    ex = pool.shared_pool() if n >= 2 else None
    if ex is None:
        rep.sequential = True
        if inline_fallback:
            rep.results = [fn(p) for p in payloads]
        return rep

    faults = cfg.faults.armed() if cfg.faults is not None else None
    plan_dict = faults.to_json_dict() if faults is not None else None
    timeout_s = cfg.resolved_timeout_s()
    retries = cfg.resolved_retries()
    backoff = backoff_schedule(retries, cfg.backoff_base_s,
                               cfg.backoff_cap_s)
    groups = max(1, min(cfg.groups, n))
    hb = HeartbeatMonitor(timeout_s=cfg.resolved_heartbeat_s(timeout_s))
    workers = getattr(ex, "_max_workers", None) or (os.cpu_count() or 2)
    total_cap = max(1, cfg.max_inflight if cfg.max_inflight else workers)
    per_group = max(1, total_cap // groups)

    group_of = [i % groups for i in range(n)]
    queue = deque((i, 0, 0.0) for i in range(n))  # (unit, attempt, ready_at)
    results: List = [None] * n
    done = [False] * n
    n_done = 0
    inflight: Dict = {}     # future -> (unit, attempt, deadline, group)
    orphans: Dict = {}      # timed-out future -> unit (late results count)
    stolen: set = set()     # units re-queued by eviction (exactly once)
    evicted: set = set()
    rebuilds_left = retries + 1
    start = time.monotonic()
    for g in range(groups):
        hb.beat(g, now=start)

    def requeue(unit: int, attempt: int, charge: bool, why: str = "") -> None:
        # charge=True: the failure is attributable to the unit (raised /
        # deadline) and spends its retry budget; charge=False: the
        # infrastructure died under it (pool rebuild) — retried free.
        if charge:
            if attempt >= retries:
                raise FleetError(f"unit {unit} failed after "
                                 f"{attempt + 1} attempt(s): {why}")
            rep.retries += 1
            delay = backoff[attempt] if attempt < len(backoff) else 0.0
            queue.append((unit, attempt + 1, time.monotonic() + delay))
        else:
            queue.append((unit, attempt, 0.0))

    def drain_inline() -> FleetReport:
        # pool gone for good: finish the remaining units in-process (no
        # fault injection inline — the plan scripts *worker* failures)
        rep.sequential = True
        say(f"# fleet: pool unavailable, draining "
            f"{n - n_done} unit(s) sequentially")
        for i in range(n):
            if not done[i]:
                results[i] = fn(payloads[i])
                done[i] = True
        rep.results = results
        return rep

    try:
        while n_done < n:
            now = time.monotonic()
            # ------------------------------------------------- submission
            cap = {g: per_group for g in range(groups)}
            for (_u, _a, _dl, g) in inflight.values():
                cap[g] = cap.get(g, per_group) - 1
            broken = False
            skipped: List[Tuple[int, int, float]] = []
            for _ in range(len(queue)):
                if len(inflight) >= total_cap:
                    break
                unit, attempt, ready_at = queue.popleft()
                if done[unit]:
                    continue
                g = group_of[unit]
                if g in evicted:      # retries of an evicted group's
                    g = min(x for x in range(groups)   # units run on the
                            if x not in evicted)       # survivors
                    group_of[unit] = g
                if ready_at > now or cap.get(g, 0) <= 0:
                    skipped.append((unit, attempt, ready_at))
                    continue
                try:
                    fut = ex.submit(_run_unit,
                                    (unit, plan_dict, fn, payloads[unit]))
                except (BrokenProcessPool, RuntimeError):
                    skipped.append((unit, attempt, ready_at))
                    broken = True
                    break
                cap[g] -= 1
                inflight[fut] = (unit, attempt, now + timeout_s, g)
            queue.extendleft(reversed(skipped))

            # ------------------------------------------------ completions
            if not broken:
                watch = list(inflight) + list(orphans)
                if not watch:
                    if not queue:
                        break
                    wake = min(r for (_u, _a, r) in queue)
                    time.sleep(max(0.001, min(cfg.poll_s,
                                              wake - time.monotonic())))
                    continue
                done_futs, _ = _futures_wait(watch, timeout=cfg.poll_s,
                                             return_when=FIRST_COMPLETED)
            else:
                done_futs = {f for f in list(inflight) + list(orphans)
                             if f.done()}
            now = time.monotonic()
            for fut in done_futs:
                if fut in orphans:
                    unit = orphans.pop(fut)
                    try:
                        val = fut.result()
                    except BaseException:
                        continue      # its timeout already re-queued it
                    if not done[unit]:   # straggler's late result counts
                        results[unit] = val
                        done[unit] = True
                        n_done += 1
                    continue
                if fut not in inflight:
                    continue
                unit, attempt, _deadline, g = inflight.pop(fut)
                try:
                    val = fut.result()
                except BrokenProcessPool:
                    broken = True
                    requeue(unit, attempt, charge=False)
                except Exception as e:
                    requeue(unit, attempt, charge=True,
                            why=f"{type(e).__name__}: {e}")
                else:
                    if not done[unit]:
                        results[unit] = val
                        done[unit] = True
                        n_done += 1
                    if faults is None or not faults.muted(g):
                        hb.beat(g, now=now)

            # ----------------------------------------------- pool rebuild
            if broken:
                rep.pool_rebuilds += 1
                say(f"# fleet: worker pool broke "
                    f"(rebuild {rep.pool_rebuilds}); re-queueing "
                    f"{len(inflight)} in-flight unit(s)")
                pool.reset_pool(kill=True)
                for _fut, (unit, attempt, _dl, _g) in inflight.items():
                    requeue(unit, attempt, charge=False)
                inflight.clear()
                orphans.clear()   # their processes died with the pool
                if rebuilds_left <= 0:
                    return drain_inline()
                rebuilds_left -= 1
                ex = pool.shared_pool()
                if ex is None:
                    return drain_inline()
                continue

            # -------------------------------------------------- deadlines
            for fut in list(inflight):
                unit, attempt, deadline, g = inflight[fut]
                if now >= deadline and not fut.done():
                    del inflight[fut]
                    fut.cancel()           # running tasks won't cancel:
                    orphans[fut] = unit    # orphaned, result harvested
                    rep.timeouts.append({"unit": unit, "attempt": attempt})
                    say(f"# fleet: unit {unit} missed its {timeout_s:g}s "
                        f"deadline (attempt {attempt + 1}); re-queueing")
                    requeue(unit, attempt, charge=True,
                            why=f"deadline {timeout_s:g}s expired")

            # ------------------------------- heartbeats / work stealing
            if groups > 1:
                alive = [g for g in range(groups) if g not in evicted]
                for g in hb.dead_hosts(now=now):
                    if g not in alive or len(alive) <= 1:
                        continue   # never evict the last group standing
                    outstanding = (
                        any(group_of[u] == g for u, _a, _r in queue)
                        or any(m[3] == g for m in inflight.values()))
                    if not outstanding:
                        hb.beat(g, now=now)   # idle, not dead
                        continue
                    hb.evict(g)
                    alive.remove(g)
                    evicted.add(g)
                    rep.evicted_groups.append(g)
                    for unit, _a, _r in queue:   # steal its queued units
                        if (group_of[unit] == g and unit not in stolen
                                and not done[unit]):
                            stolen.add(unit)
                            group_of[unit] = alive[
                                len(rep.stolen_units) % len(alive)]
                            rep.stolen_units.append(unit)
                    say(f"# fleet: evicted silent group {g}; stole "
                        f"{len(rep.stolen_units)} queued unit(s)")
    except FleetError:
        if orphans:
            pool.reset_pool(kill=True)
        raise
    if orphans:
        # stragglers still executing would stall interpreter exit and
        # waste workers; kill the pool — the next fan-out rebuilds it
        say(f"# fleet: discarding {len(orphans)} orphaned straggler(s)")
        pool.reset_pool(kill=True)
    rep.results = results
    return rep
