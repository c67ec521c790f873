"""Synthetic serving traffic: seeded Poisson workload over the engine
(PyTorch port of ``repro.serve.traffic``; the harness itself is numpy).

The harness drives :class:`repro_torch.serve.engine.Engine` with a reproducible
open-loop workload — exponential (Poisson-process) interarrival times,
mixed prompt lengths and decode budgets — and measures the episode
against the engine's *modeled* clock (the execution model's per-step CGRA
latency, see ``repro_torch.serve.plan.CGRAExecutionModel``).  Requests that
arrive while every slot is busy wait in an admission queue; slots recycle
as requests finish, so the episode exercises continuous batching under
slot pressure.

Everything is deterministic given the seed: arrivals come from one
``numpy`` Generator, request completion depends only on lengths (never on
token *values*), and the modeled clock is analytic — so the report, and
its JSON rendering, are byte-identical across runs and machines, and
identical to the reference's for the same seed and execution model.

Report schema (all floats rounded before serialization):
  tokens_per_s           decoded tokens / modeled episode seconds
  latency_ms.p50/p95/p99 per-request latency percentiles (finish - arrival)
  queue_wait_ms          admission-queue wait percentiles
  slot_occupancy         mean/max active-slot fraction per decode step
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .engine import Engine, Request

REPORT_SCHEMA = 1


@dataclass(frozen=True)
class TrafficConfig:
    seed: int = 0
    n_requests: int = 16
    arrival_rate: float = 50.0          # requests / modeled second
    prompt_len: Tuple[int, int] = (4, 12)    # inclusive range
    max_new: Tuple[int, int] = (4, 12)       # inclusive range
    truncate: bool = True               # overlong prompts: truncate vs drop


class FixedLatencyModel:
    """Constant-rate execution model — the no-CGRA baseline (and the
    model tests use to exercise the harness without compiling)."""

    def __init__(self, decode_step_us: float = 1000.0,
                 prefill_us_per_token: float = 250.0):
        self.decode_step_us = decode_step_us
        self.prefill_us_per_token = prefill_us_per_token

    def decode_step_s(self, active: int) -> float:
        return self.decode_step_us * 1e-6

    def prefill_s(self, prompt_len: int) -> float:
        return self.prefill_us_per_token * prompt_len * 1e-6


def generate_requests(traffic: TrafficConfig, vocab: int
                      ) -> List[Tuple[float, Request]]:
    """The seeded workload: [(arrival time, request)] in arrival order."""
    rng = np.random.default_rng(traffic.seed)
    out: List[Tuple[float, Request]] = []
    t = 0.0
    lo_p, hi_p = traffic.prompt_len
    lo_n, hi_n = traffic.max_new
    for rid in range(traffic.n_requests):
        t += float(rng.exponential(1.0 / traffic.arrival_rate))
        plen = int(rng.integers(lo_p, hi_p + 1))
        max_new = int(rng.integers(lo_n, hi_n + 1))
        prompt = np.asarray(rng.integers(0, vocab, size=plen), np.int32)
        out.append((t, Request(rid=rid, prompt=prompt, max_new=max_new)))
    return out


def _pct(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def _ms_stats(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    return {"p50": round(_pct(values, 50) * 1e3, 6),
            "p95": round(_pct(values, 95) * 1e3, 6),
            "p99": round(_pct(values, 99) * 1e3, 6),
            "mean": round(float(np.mean(values)) * 1e3, 6),
            "max": round(float(np.max(values)) * 1e3, 6)}


def run_traffic(engine: Engine, traffic: TrafficConfig,
                vocab: int) -> Dict[str, Any]:
    """One traffic episode; returns the deterministic report dict.

    The engine must carry an execution model — the episode is measured in
    modeled seconds, and a zero-latency clock would make every rate
    statistic degenerate."""
    if engine.exec_model is None:
        raise ValueError("run_traffic needs an engine with an exec_model "
                         "(CGRAExecutionModel or FixedLatencyModel)")
    arrivals = generate_requests(traffic, vocab)
    pending = deque(arrivals)
    tracked: Dict[int, Request] = {}
    arrival_t: Dict[int, float] = {r.rid: t for t, r in arrivals}
    admit_t: Dict[int, float] = {}
    finish_t: Dict[int, float] = {}
    rejected: List[int] = []
    truncated: List[int] = []
    occupancy: List[float] = []
    steps = 0

    while pending or tracked:
        # admit every arrived request that finds a free slot; the rest
        # wait in the queue (continuous batching under slot pressure)
        while (pending and pending[0][0] <= engine.clock_s
               and engine.has_free_slot()):
            t_arr, req = pending.popleft()
            try:
                ok = engine.admit(req, truncate=traffic.truncate)
            except ValueError:        # overlong prompt, truncate=False
                rejected.append(req.rid)
                continue
            if not ok:                # lost the slot race; retry next round
                pending.appendleft((t_arr, req))
                break
            admit_t[req.rid] = engine.clock_s
            tracked[req.rid] = req
            if req.truncated:
                truncated.append(req.rid)
        if not tracked:
            if not pending:
                break
            engine.advance_clock(pending[0][0])   # idle until next arrival
            continue
        occupancy.append(engine.n_active / engine.batch)
        engine.step()
        steps += 1
        for rid in [rid for rid, r in tracked.items() if r.done]:
            finish_t[rid] = engine.clock_s
            del tracked[rid]

    served = sorted(finish_t)
    latency = [finish_t[r] - arrival_t[r] for r in served]
    qwait = [admit_t[r] - arrival_t[r] for r in served]
    decoded = sum(len(r.out) for _t, r in arrivals if r.rid in finish_t)
    episode_s = engine.clock_s
    return {
        "schema": REPORT_SCHEMA,
        "seed": traffic.seed,
        "requests": traffic.n_requests,
        "served": len(served),
        "rejected": len(rejected),
        "truncated": len(truncated),
        "decode_steps": steps,
        "decoded_tokens": decoded,
        "episode_s": round(episode_s, 9),
        "tokens_per_s": round(decoded / episode_s, 6) if episode_s else 0.0,
        "latency_ms": _ms_stats(latency),
        "queue_wait_ms": _ms_stats(qwait),
        "slot_occupancy": {
            "mean": round(float(np.mean(occupancy)), 6) if occupancy else 0.0,
            "max": round(float(np.max(occupancy)), 6) if occupancy else 0.0,
            "slots": engine.batch,
        },
    }


def report_json(report: Dict[str, Any]) -> str:
    """Canonical byte-deterministic rendering of a traffic report."""
    return json.dumps(report, sort_keys=True, indent=1) + "\n"


def report_bench_rows(report: Dict[str, Any],
                      name: str = "serve_decode",
                      **extra_derived: Any) -> List[Dict[str, Any]]:
    """One ``benchmarks.run``-schema row per episode: ``us`` is the
    modeled episode duration (analytic, so the regression comparator
    gates plan/cost-model quality, not host wall clock)."""
    derived = {
        "tokens_per_s": report["tokens_per_s"],
        "p50_ms": report["latency_ms"]["p50"],
        "p95_ms": report["latency_ms"]["p95"],
        "p99_ms": report["latency_ms"]["p99"],
        "queue_p95_ms": report["queue_wait_ms"]["p95"],
        "occupancy": report["slot_occupancy"]["mean"],
        "served": report["served"],
        "decode_steps": report["decode_steps"],
    }
    derived.update(extra_derived)
    return [{"name": name, "us": round(report["episode_s"] * 1e6, 1),
             "derived": derived}]
