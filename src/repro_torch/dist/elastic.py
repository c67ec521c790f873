"""Elastic membership primitives for sweep and verification fleets.

Fleet-scale operations — DSE sweeps sharded across worker groups,
multi-seed verification fleets, multi-host training — survive member
loss through three small, deterministic mechanisms:

  * :class:`HeartbeatMonitor` — liveness tracking with an injectable
    clock.  Members ``beat`` on progress; anything silent for longer
    than ``timeout_s`` is reported by ``dead_hosts`` and can be evicted,
    with its outstanding work re-queued ("stolen") by the survivors.
  * :func:`best_mesh_shape` — after losing hosts, the largest (data,
    model) mesh the surviving device count supports: keep the requested
    model-parallel degree when it still divides, otherwise shrink it
    through its divisors (model-parallel groups must be whole).
  * :func:`resume_plan` — which checkpoint step to restart from given
    what survived on disk.

Everything here is pure bookkeeping: no sockets, no threads, no torch —
the fleet runner (:mod:`repro_torch.dist.fleet`) and the training launcher
both drive it with whatever clock and transport they own.
"""
from __future__ import annotations

import time
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


class HeartbeatMonitor:
    """Tracks the last heartbeat per member against a staleness timeout.

    All methods accept ``now`` so callers (and tests) can inject a
    clock; when omitted, ``time.monotonic()`` is used.  Members are any
    hashable id — host ranks, fleet worker-group indices.
    """

    def __init__(self, timeout_s: float = 30.0):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self._last: Dict[Hashable, float] = {}
        self._evicted: set = set()

    def _now(self, now: Optional[float]) -> float:
        return time.monotonic() if now is None else now

    def beat(self, member: Hashable, now: Optional[float] = None) -> None:
        """Record a liveness signal from ``member``."""
        self._last[member] = self._now(now)

    def members(self) -> List[Hashable]:
        return sorted(self._last)

    def alive(self, member: Hashable, now: Optional[float] = None) -> bool:
        last = self._last.get(member)
        return (last is not None and member not in self._evicted
                and self._now(now) - last <= self.timeout_s)

    def all_alive(self, n: int, now: Optional[float] = None) -> bool:
        """True when members ``0..n-1`` have all beaten within the
        timeout (the launcher's "is the whole fleet up" check)."""
        now = self._now(now)
        return all(self.alive(m, now) for m in range(n))

    def dead_hosts(self, now: Optional[float] = None) -> List[Hashable]:
        """Members whose last beat is older than the timeout, sorted.
        Already-evicted members are not re-reported."""
        now = self._now(now)
        return sorted(m for m, last in self._last.items()
                      if m not in self._evicted
                      and now - last > self.timeout_s)

    def evict(self, member: Hashable) -> None:
        """Mark ``member`` as evicted: it stops appearing in
        ``dead_hosts`` and stays dead until it beats again."""
        self._evicted.add(member)

    def evicted(self) -> List[Hashable]:
        return sorted(self._evicted)

    def readmit(self, member: Hashable, now: Optional[float] = None) -> None:
        """An evicted member rejoined (elastic scale-up)."""
        self._evicted.discard(member)
        self.beat(member, now)


def best_mesh_shape(n_devices: int, model_parallel: int
                    ) -> Tuple[int, int]:
    """The (data, model) mesh for ``n_devices`` surviving devices.

    Keeps the requested model-parallel degree when it divides the device
    count; otherwise shrinks MP through its divisors (an MP group must be
    whole — a fractional group cannot hold a sharded layer).  Always
    succeeds: MP=1 divides anything.

    >>> best_mesh_shape(512, 16)
    (32, 16)
    >>> best_mesh_shape(500, 16)   # lost 12 hosts: shrink MP to 4
    (125, 4)
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    for mp in range(model_parallel, 0, -1):
        if model_parallel % mp == 0 and n_devices % mp == 0:
            return (n_devices // mp, mp)
    return (n_devices, 1)  # unreachable: mp=1 always matches


def resume_plan(available_steps: Sequence[int],
                requested_step: Optional[int] = None) -> Optional[int]:
    """Which checkpoint step to restart from.

    The newest step not past ``requested_step`` (a partially-written or
    known-bad newer step must not be restored), or the newest overall
    when no step is requested.  None when nothing survived — the caller
    starts from scratch.
    """
    steps = sorted(available_steps)
    if requested_step is not None:
        steps = [s for s in steps if s <= requested_step]
    return steps[-1] if steps else None
