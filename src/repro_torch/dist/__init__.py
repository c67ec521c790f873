"""Elastic, fault-tolerant fleets.

Four modules, one robustness contract — a fleet-scale operation with
injected worker loss emits byte-identical artifacts to an undisturbed
single-process run:

  * ``elastic``  — heartbeat liveness, surviving-mesh planning, resume
    planning (the API the JAX package's ``tests/test_substrate.py`` pins);
  * ``sharding`` — shape -> partition spec rules the launch specs import;
  * ``fleet``    — supervised work-queue runner over the shared process
    pool: deadlines, deterministic retry/backoff, pool rebuilds,
    heartbeat eviction with work stealing, sequential degradation;
  * ``faults``   — deterministic fault injection (seeded worker kills,
    stragglers, muted heartbeats, checkpoint corruption) so the failure
    paths are first-class tested code.

``sharding`` resolves lazily (PEP 562): its placements need torch, and
fleet *worker processes* import this package -- it must stay cheap and
torch-free.
"""
from __future__ import annotations

import importlib

from . import elastic, faults, fleet  # noqa: F401  (light, torch-free)


def __getattr__(name: str):
    if name == "sharding":
        return importlib.import_module(".sharding", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | {"sharding"})
