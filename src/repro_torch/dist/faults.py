"""Deterministic fault injection for fleet runs.

The robustness contract of ``repro_torch.dist`` is that a sweep with injected
worker loss emits byte-identical artifacts to an undisturbed run — which
is only testable if the failure paths are first-class, reproducible
code.  A :class:`FaultPlan` scripts the failures:

  * ``kill_units``   — the worker executing that unit calls ``os._exit``
    (an OS-killed worker: the parent sees ``BrokenProcessPool``);
  * ``delay_units``  — the worker sleeps past the task deadline (a
    straggler: the parent times the unit out and re-queues it);
  * ``mute_groups``  — completions from that worker group never beat the
    heartbeat monitor (a silent host: the group is evicted and its
    queued units stolen by the survivors).

Kills and delays fire **exactly once** per unit, coordinated across
worker processes through ``O_EXCL`` marker files in ``state_dir`` — the
retried attempt runs clean, so an injected fault perturbs scheduling but
never the result.  Mutes are unconditional for the whole run (a dead
host stays dead).  Plans serialize to JSON so the parent can ship them
to workers inside each work-unit payload.

Fault injection only simulates *worker* failures: the fleet's inline
(sequential-fallback) path never consults the plan — killing the parent
would be testing the OS, not the runner.

``corrupt_file`` rounds out the harness: deterministic byte corruption
for checkpoint-recovery tests.
"""
from __future__ import annotations

import json
import os
import random
import tempfile
import time
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

KILL_EXIT_CODE = 86


@dataclass(frozen=True)
class FaultPlan:
    """A scripted, seeded set of failures for one fleet run."""
    kill_units: Tuple[int, ...] = ()
    delay_units: Tuple[Tuple[int, float], ...] = ()   # (unit, sleep_s)
    mute_groups: Tuple[int, ...] = ()
    state_dir: str = ""          # fire-once marker dir; "" = not armed

    # ------------------------------------------------------------- build
    @staticmethod
    def seeded(seed: int = 0, units: int = 8, kills: int = 1,
               delays: int = 1, delay_s: float = 30.0,
               mutes: int = 0, groups: int = 2) -> "FaultPlan":
        """A deterministic plan: ``kills`` + ``delays`` distinct units
        drawn from ``range(units)`` by a seeded RNG (armed and ready)."""
        rng = random.Random(seed)
        picks = rng.sample(range(max(units, kills + delays)),
                           kills + delays)
        muted = tuple(sorted(rng.sample(range(groups), mutes))) \
            if mutes else ()
        return FaultPlan(
            kill_units=tuple(sorted(picks[:kills])),
            delay_units=tuple((u, float(delay_s))
                              for u in sorted(picks[kills:])),
            mute_groups=muted).armed()

    def armed(self) -> "FaultPlan":
        """Plan with a fire-once marker directory attached (idempotent)."""
        if self.state_dir:
            return self
        return replace(self,
                       state_dir=tempfile.mkdtemp(prefix="morpher-faults-"))

    # -------------------------------------------------------------- wire
    def to_json_dict(self) -> Dict:
        return {"kill_units": list(self.kill_units),
                "delay_units": [[u, s] for u, s in self.delay_units],
                "mute_groups": list(self.mute_groups),
                "state_dir": self.state_dir}

    @staticmethod
    def from_json_dict(d: Dict) -> "FaultPlan":
        return FaultPlan(
            kill_units=tuple(d.get("kill_units", ())),
            delay_units=tuple((int(u), float(s))
                              for u, s in d.get("delay_units", ())),
            mute_groups=tuple(d.get("mute_groups", ())),
            state_dir=d.get("state_dir", ""))

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "FaultPlan":
        return FaultPlan.from_json_dict(json.loads(s))

    # -------------------------------------------------------------- fire
    def _fire_once(self, tag: str) -> bool:
        """True exactly once per tag across every process sharing
        ``state_dir`` (O_EXCL marker); an unarmed plan never fires."""
        if not self.state_dir:
            return False
        try:
            os.makedirs(self.state_dir, exist_ok=True)
            fd = os.open(os.path.join(self.state_dir, tag),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        except OSError:
            return False
        os.close(fd)
        return True

    def fire_unit(self, unit: int) -> None:
        """Worker-side hook: inject this unit's scripted fault, if any
        and not already fired.  A kill does not return."""
        if unit in self.kill_units and self._fire_once(f"kill-{unit}"):
            os._exit(KILL_EXIT_CODE)
        for u, sleep_s in self.delay_units:
            if u == unit and self._fire_once(f"delay-{unit}"):
                time.sleep(sleep_s)

    def muted(self, group: int) -> bool:
        """Parent-side hook: is this worker group's heartbeat suppressed?"""
        return group in self.mute_groups


def corrupt_file(path: str, seed: int = 0, n_bytes: int = 8) -> None:
    """Deterministically flip ``n_bytes`` of ``path`` in place — the
    corrupted-checkpoint leg of the fault harness."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        data = bytearray(b"\x00")
    rng = random.Random(seed)
    for _ in range(n_bytes):
        data[rng.randrange(len(data))] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


# ----------------------------------------------------------- test doubles
# Module-level so they pickle by reference into pool workers; kept free of
# heavy imports (workers importing this module must stay cheap).
def double(payload):
    """Well-behaved work function for fleet/pool tests."""
    return payload * 2


def kill_worker(payload):  # pragma: no cover - exits the process
    """Work function that kills its worker process (pool-recovery tests)."""
    os._exit(KILL_EXIT_CODE)
