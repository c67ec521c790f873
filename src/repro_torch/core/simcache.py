"""Process-wide shape-bucketed cache of simulator runners.

The batched verification engine (``simulator.simulate_batch``) builds one
runner per *shape signature* — ``(II, P, RF, bits, n_iters, n_cycles,
batch)`` — not per call.  A runner is the cycle loop bound to that
signature's static values; it takes the configuration planes, the memory
images, the live-in stack and the exact cycle count, with tensors on any
device.  Verifying the six
Table-I kernels plus the four DSL kernels across N seeds therefore builds
a handful of runners instead of one per ``verify`` call, and the
signatures, buckets and counters are the same as the JAX package's, so
``stats()`` reads alike in both.

Three bucketing knobs cap distinct signatures from near-miss shapes:

  * ``bucket_batch`` rounds the batch (seed count) up to the next power of
    two — padded rows are simulated and discarded by the caller;
  * ``bucket_cycles`` rounds the cycle count up, keeping 4 significant
    bits (<= 12.5% padded cycles) — cycles past the schedule are dead by
    construction: every STORE is gated by the control module's
    iteration-validity window, so final memory is untouched.  The JAX
    package's executables run the bucketed count; the eager runners here
    run the exact one, so in the port the bucket only groups signatures;
  * ``bucket_rf`` (multi-architecture stacking only) rounds the
    register-file width up so fabrics differing only in RF provisioning
    share one runner — padded registers are dead lanes (write ports
    KIND_NONE, reads clipped to the config's real RF).

All paddings preserve the bit-exactness contract of ``verify_batch`` and
``simulate_multi``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict


@dataclass(frozen=True)
class SimSignature:
    """Everything static that determines a batched-simulator runner.

    ``multi=True`` marks the multi-architecture variant of the body, where
    configuration planes carry a leading batch axis (one config per memory
    row) so one runner scores many candidate fabrics sharing this
    shape bucket; its state-vector layout depends on the live-in register
    count, so ``LI`` joins the key there (the single-config body infers LI
    from the traced live-in stack and keeps the historical key).
    """
    II: int
    P: int
    RF: int
    bits: int
    n_iters: int
    n_cycles: int
    batch: int
    LI: int = 0
    multi: bool = False


def bucket_batch(batch: int) -> int:
    """Round a batch size up to the next power of two (>= 1)."""
    if batch <= 1:
        return 1
    return 1 << (batch - 1).bit_length()


def bucket_cycles(n_cycles: int) -> int:
    """Round a cycle count up to its 4-significant-bit bucket boundary.

    Keeps at most 8 buckets per octave, so the padding overhead is bounded
    by 12.5% of simulated cycles while distinct ``n_cycles`` values (and
    therefore traces) stay capped.
    """
    if n_cycles <= 8:
        return max(1, n_cycles)
    quantum = 1 << (n_cycles.bit_length() - 4)
    return -(-n_cycles // quantum) * quantum


def bucket_rows(rows: int) -> int:
    """Batch-row bucket of the *multi-architecture* stacked body: same
    4-significant-bit rounding as ``bucket_cycles`` (<= 12.5% padded
    rows), instead of ``bucket_batch``'s power of two (up to 100%).
    Stacked batches are sums of per-config seed batches — pow-of-two
    rounding of e.g. 40 rows to 64 wastes more simulated rows than the
    launch it shares, and on a compute-bound backend padded rows are
    pure loss.  Single-config batches keep pow-of-two: they are seed
    counts, small and already round."""
    return bucket_cycles(rows)


def bucket_rf(rf: int) -> int:
    """Register-file width bucket of the *multi-architecture* stacked
    body: every RF provisioning up to 16 pads to 16 registers (wider ones
    round up to the next power of two), so fabrics that differ only in
    routing-register provisioning — the axis a DSE search explores
    hardest — share one runner.  Padded registers are dead lanes
    (never written: their write ports are KIND_NONE; never read: gather
    indices clip to the config's own RF), so stacking stays bit-exact.
    The single-config path keeps exact RF — padding there would buy
    nothing and cost state width."""
    if rf <= 16:
        return 16
    return 1 << (rf - 1).bit_length()


class _Entry:
    __slots__ = ("fn", "hits")

    def __init__(self, fn: Callable):
        self.fn = fn
        self.hits = 0


_lock = threading.Lock()
_entries: Dict[SimSignature, _Entry] = {}
_misses = 0


def get(sig: SimSignature, build: Callable[[], Callable]) -> Callable:
    """Return the cached runner for ``sig``, building it on first use.

    ``build`` must return a callable closed over ``sig``'s static values;
    it is invoked at most once per signature per process.
    """
    global _misses
    with _lock:
        entry = _entries.get(sig)
        if entry is None:
            entry = _Entry(build())
            _entries[sig] = entry
            _misses += 1
        else:
            entry.hits += 1
        return entry.fn


def stats() -> Dict[str, int]:
    """Executable-cache counters: ``entries`` live signatures, ``hits``
    calls served by an existing runner, ``misses`` builds."""
    with _lock:
        return {"entries": len(_entries),
                "hits": sum(e.hits for e in _entries.values()),
                "misses": _misses}


def clear() -> None:
    """Drop every cached runner (tests / memory pressure)."""
    global _misses
    with _lock:
        _entries.clear()
        _misses = 0
