"""Elastic, fault-tolerant fleets.

Three modules, one robustness contract — a fleet-scale operation with
injected worker loss emits byte-identical artifacts to an undisturbed
single-process run:

  * ``elastic``  — heartbeat liveness, surviving-mesh planning, resume
    planning (the API the JAX package's ``tests/test_substrate.py`` pins);
  * ``fleet``    — supervised work-queue runner over the shared process
    pool: deadlines, deterministic retry/backoff, pool rebuilds,
    heartbeat eviction with work stealing, sequential degradation;
  * ``faults``   — deterministic fault injection (seeded worker kills,
    stragglers, muted heartbeats, checkpoint corruption) so the failure
    paths are first-class tested code.

All three are torch-free: fleet *worker processes* import this package
and must stay cheap.  The JAX package's fourth module, ``sharding``
(shape -> PartitionSpec rules), is not ported (ROADMAP A7); asking for it
raises ``AttributeError``.
"""
from __future__ import annotations

from . import elastic, faults, fleet  # noqa: F401  (light, torch-free)


def __getattr__(name: str):
    if name == "sharding":
        raise AttributeError(
            f"module {__name__!r} has no attribute 'sharding': it is not "
            "ported to repro_torch yet (ROADMAP A7)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
