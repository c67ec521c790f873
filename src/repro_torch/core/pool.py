"""Shared process fan-out machinery for CPU-bound compile work.

The mapper is pure Python and therefore GIL-bound, so both fan-outs in the
compile loop — ``Toolchain.compile_many`` (independent kernels) and the
mapper's portfolio (II, seed) search — run on worker *processes*.  This
module owns the one process pool they share:

  * start method: ``forkserver`` when available (the parent often has torch's
    thread pools loaded, and forking a threaded process can deadlock;
    ``spawn`` re-imports the caller's ``__main__`` per worker, which breaks
    REPL/stdin drivers) — else ``spawn``;
  * the pool is created lazily and kept for the life of the process, so the
    per-worker interpreter/numpy import cost is paid once, not once per
    compile;
  * workers run with ``MORPHER_POOL_WORKER=1`` so nested fan-out attempts
    (a portfolio search inside a ``compile_many`` worker) degrade to the
    sequential path instead of oversubscribing the machine;
  * every entry point degrades to ``None`` — callers always keep a
    bit-identical sequential fallback.
"""
from __future__ import annotations

import multiprocessing
import os
import sys
import threading
from concurrent.futures import Future, ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Callable, List, Optional, Sequence

WORKER_ENV = "MORPHER_POOL_WORKER"

_lock = threading.Lock()
_shared: Optional[ProcessPoolExecutor] = None


def in_worker() -> bool:
    """True inside a pool worker process (nested fan-out must stay
    sequential)."""
    return os.environ.get(WORKER_ENV) == "1"


def _init_worker() -> None:
    os.environ[WORKER_ENV] = "1"


def _spawnable_main() -> bool:
    # worker processes re-import the caller's __main__; if it is not a real
    # file (REPL/stdin scripts have __file__='<stdin>'), they would crash
    # on startup — report the pool as unavailable instead
    main_file = getattr(sys.modules.get("__main__"), "__file__", None)
    return main_file is None or os.path.exists(main_file)


def shared_pool() -> Optional[ProcessPoolExecutor]:
    """The process-wide worker pool, or None when process fan-out is
    unavailable in this context (nested worker, REPL main, sandbox).

    A pool whose worker died (OS kill, OOM) marks itself broken and
    would poison every later call with ``BrokenProcessPool`` — it is
    detected here and replaced, so one lost worker costs one rebuild,
    not the rest of the process lifetime.
    """
    global _shared
    if in_worker() or not _spawnable_main():
        return None
    with _lock:
        if _shared is not None and getattr(_shared, "_broken", False):
            ex, _shared = _shared, None
            ex.shutdown(wait=False, cancel_futures=True)
        if _shared is None:
            methods = multiprocessing.get_all_start_methods()
            method = "forkserver" if "forkserver" in methods else "spawn"
            try:
                _shared = ProcessPoolExecutor(
                    max_workers=max(2, os.cpu_count() or 2),
                    mp_context=multiprocessing.get_context(method),
                    initializer=_init_worker)
            except (OSError, PermissionError):
                return None
        return _shared


def reset_pool(kill: bool = False) -> None:
    """Drop a broken pool; the next ``shared_pool()`` builds a fresh one.

    ``kill=True`` also terminates the worker processes — needed when a
    straggler is still executing an orphaned task (a sleeping worker
    would otherwise stall interpreter exit on the executor's atexit
    join).  Tasks are idempotent by contract, so a terminated worker
    loses nothing that a retry cannot recompute.
    """
    global _shared
    with _lock:
        ex, _shared = _shared, None
    if ex is None:
        return
    if kill:
        try:
            for proc in list(getattr(ex, "_processes", {}).values()):
                proc.terminate()
        except Exception:
            pass  # best effort: shutdown below still detaches the pool
    ex.shutdown(wait=False, cancel_futures=True)


def process_map(fn: Callable, payloads: Sequence, jobs: Optional[int] = None
                ) -> Optional[list]:
    """``[fn(p) for p in payloads]`` across the shared pool, or None when
    fan-out is unavailable/broken (callers fall back to sequential).

    ``jobs < 2`` forces the sequential path; a smaller ``jobs`` than the
    pool size caps *in-flight* tasks at ``jobs`` (the pool itself is sized
    to the machine, but a caller-requested concurrency limit is honored by
    windowed submission).

    A killed worker (``BrokenProcessPool``) gets one recovery attempt:
    the pool is rebuilt and the whole batch retried — payloads must be
    idempotent, which compile units are by content-addressing.  If the
    fresh pool breaks too, the fault is the workload's, not transient:
    reset and return None so the caller's sequential path decides.
    """
    if len(payloads) < 2 or (jobs is not None and jobs < 2):
        return None
    ex = shared_pool()
    if ex is None:
        return None
    for attempt in (0, 1):
        try:
            if jobs is None or jobs >= len(payloads):
                return list(ex.map(fn, payloads))
            results: list = []
            window = [ex.submit(fn, p) for p in payloads[:jobs]]
            nxt = jobs
            while window:
                results.append(window.pop(0).result())
                if nxt < len(payloads):
                    window.append(ex.submit(fn, payloads[nxt]))
                    nxt += 1
            return results
        except BrokenProcessPool:
            reset_pool(kill=True)
            if attempt == 1:
                return None
            ex = shared_pool()   # one retry on a fresh pool
            if ex is None:
                return None
    return None


def submit_all(fn: Callable, payloads: Sequence) -> Optional[List[Future]]:
    """Submit every payload to the shared pool; None when unavailable.
    Callers consume futures in submission order for deterministic
    selection and must handle ``BrokenProcessPool`` from ``.result()``."""
    ex = shared_pool()
    if ex is None:
        return None
    try:
        return [ex.submit(fn, p) for p in payloads]
    except (BrokenProcessPool, RuntimeError):
        reset_pool()
        return None
