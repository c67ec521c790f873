"""Unified compile API: the paper's integrated flow as one staged object.

Morpher's core claim (paper Fig. 3) is that ADL, DFG generation, mapping,
configuration generation, simulation and verification form *one* pipeline.
This module is that pipeline's front door:

    tc = Toolchain(options=MapperOptions())        # or default_toolchain()
    ck = tc.compile(spec)                          # KernelSpec -> artifact
    ck.run(init_banks)                             # cycle-accurate simulate
    ck.verify()                                    # paper IV-C flow
    text = ck.to_json()                            # serializable artifact
    ck2 = CompiledKernel.from_json(text)           # ... reload anywhere
    ck2.verify()                                   # still bit-exact

``CompiledKernel`` bundles everything the downstream stages need — the DFG,
data layout, the :class:`Mapping`, and the generated :class:`SimConfig` —
and is fully JSON-serializable (CGRA4ML-style artifact-oriented HW/SW
handoff).  A deserialized artifact carries no Python closures, so its
``verify`` falls back to the DFG's sequential reference execution as the
oracle; both paths are bit-exact comparisons of final memory images.

Compiles are memoized through a content-addressed on-disk cache keyed by a
stable SHA-256 of (DFG canonical form, arch ADL JSON, mapper options, data
layout, invocation schedule).  Re-mapping the same tile — which the edge-
deployment analyzer does for every GEMM site of every model — is a cache
hit across processes and sessions.  *Negative* results are memoized too:
the mapper is deterministic, so a MapError for a given content address is
as reproducible as a mapping, and a design-space sweep re-run must not
re-pay the II escalation of every infeasible (arch, kernel) point — a
``<key>.err.json`` marker short-circuits it.  Cache location:
``$MORPHER_CACHE_DIR`` (default ``~/.cache/morpher-toolchain``; set it to
the empty string, or pass ``cache_dir=""``, to disable the on-disk cache).

This is the PyTorch port of ``repro.core.toolchain``: mapping and
configuration generation are the same host code, artifacts serialize byte
for byte alike (so either package loads the other's), and the cache
directory and keys are shared.  Simulation and the batched DFG oracle run
in torch on ``device`` (``None``: the CUDA card; tests pass ``"cpu"``);
the module imports no torch itself, so mapper and fleet worker processes
stay light and never touch the card: a worker receives JSON and returns
JSON, and only the calling process simulates.  The opt-in gates
(``MORPHER_CHECK=1``: the static checker before any simulation;
``MORPHER_XVAL=1``: the instruction-stream interpreter after it, its
simulations on the same ``device``) behave as in the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .adl import CGRAArch
from .config_gen import ConfigConflict, SimConfig, generate_config
from .dfg import DFG
from .kernels_lib import KernelSpec
from .layout import DataLayout
from .mapper import MapError, Mapping, MapperOptions, map_kernel_opts

# v2: SimConfig.bank_offsets became an id-keyed mapping (banks are
# identified by MemBank.id, not list position) — v1 artifacts are
# incompatible and recompile on load
# v3: SimConfig.to_json is canonical (sorted keys, compact separators) —
# the instruction-stream exporter's byte-determinism contract rests on
# it; v2 artifacts parse fine but recompile so cached bytes are canonical
ARTIFACT_VERSION = 3
CACHE_ENV = "MORPHER_CACHE_DIR"


def default_cache_dir() -> str:
    """Resolve the on-disk artifact cache directory.

    ``$MORPHER_CACHE_DIR`` overrides; an empty value disables caching.
    """
    env = os.environ.get(CACHE_ENV)
    if env is not None:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "morpher-toolchain")


def spec_cache_key(spec: KernelSpec, options: MapperOptions) -> str:
    """Content address of a compile: everything that determines the
    artifact, nothing that doesn't (golden-model closures are derived from
    the same structural inputs and deliberately excluded; the DFG enters
    in canonical form, so cosmetic node names — which differ between the
    hand-built builders and the ``repro_torch.frontend`` tracer — cannot change
    the address)."""
    ident = {
        "v": ARTIFACT_VERSION,
        "dfg": spec.dfg.canonical_dict(),
        "arch": json.loads(spec.arch.to_json()),
        "options": options.to_json_dict(),
        "layout": spec.layout.to_json_dict(),
        "mapped_iters": spec.mapped_iters,
        "invocations": spec.invocations,
        "meta": spec.meta,
        "name": spec.name,
    }
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _compile_worker(payload: str) -> str:
    """Process-pool worker: map + generate config from the JSON form of the
    compile inputs (specs carry unpicklable closures; their structural parts
    round-trip losslessly).  Pure Python/numpy — no torch in the child.

    An infeasible mapping is a *result*, not a crash: MapError comes back
    as an error marker so one unmappable (arch, kernel) pair — routine in
    a design-space sweep — cannot kill the whole fan-out."""
    d = json.loads(payload)
    arch = CGRAArch.from_json(json.dumps(d["arch"]))
    dfg = DFG.from_json_dict(d["dfg"])
    layout = DataLayout.from_json_dict(d["layout"], arch)
    opt = MapperOptions.from_json_dict(d["options"])
    try:
        mapping = map_kernel_opts(dfg, arch, layout, opt)
        cfg = generate_config(mapping, layout)
    except (MapError, ConfigConflict) as e:
        return json.dumps({"map_error": _compile_error_str(e)})
    return json.dumps({"mapping": mapping.to_json_dict(),
                       "cfg": json.loads(cfg.to_json())})


def _compile_error_str(e: Exception) -> str:
    """One canonical error string per compile failure mode.  A
    ConfigConflict (the mapper accepted a schedule the crossbar fabric
    cannot realize — possible on heavily heterogeneous variants) is an
    infeasibility *result* exactly like MapError: same message in the
    fleet worker and the sequential path, so the memoized failure is
    bit-identical either way."""
    if isinstance(e, ConfigConflict):
        return f"configuration conflict: {e}"
    return str(e)


# --------------------------------------------------------------------------
@dataclass
class CompiledKernel:
    """The serializable product of one compile: spec metadata + mapping +
    configuration + layout, with run/verify attached."""
    name: str
    arch: CGRAArch
    dfg: DFG
    layout: DataLayout
    mapping: Mapping
    cfg: SimConfig
    mapped_iters: int
    invocations: List[Dict[str, int]]
    meta: Dict[str, int]
    options: MapperOptions
    cache_key: str
    # transient: the builder spec (golden model + bank init closures); not
    # serialized, absent on artifacts reloaded from JSON.
    spec: Optional[KernelSpec] = None
    from_cache: bool = False

    # ------------------------------------------------------------ metadata
    @property
    def II(self) -> int:
        return self.mapping.II

    @property
    def mii(self) -> int:
        return self.mapping.mii

    @property
    def utilization(self) -> float:
        return self.mapping.utilization

    @property
    def depth(self) -> int:
        return self.mapping.depth

    def schedule_cycles(self) -> int:
        """Cycles per invocation (fill + steady state + drain)."""
        return self.mapping.schedule_len(self.mapped_iters)

    def liveout_banks(self) -> List[str]:
        """The bank arrays any STORE node writes — the only memory the
        simulation can change, hence the only words verification compares."""
        from .dfg import Op
        return sorted({n.array for n in self.dfg.nodes.values()
                       if n.op == Op.STORE})

    # ------------------------------------------------------------ execution
    def run(self, init_banks: Dict[str, np.ndarray],
            device=None) -> Dict[str, np.ndarray]:
        """Cycle-accurately simulate all invocations on ``device`` (``None``:
        the CUDA card); returns final banks."""
        from .simulator import simulate
        return simulate(self.cfg, init_banks, self.invocations,
                        self.mapped_iters, device=device)

    def run_batch(self, init_banks_batch: List[Dict[str, np.ndarray]],
                  device=None) -> List[Dict[str, np.ndarray]]:
        """Simulate a batch of initial images (seeds / test vectors) in one
        batched cycle loop; element i is bit-identical to ``run`` on it."""
        from .simulator import simulate_batch
        return simulate_batch(self.cfg, init_banks_batch, self.invocations,
                              self.mapped_iters, device=device)

    def random_banks(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """Deterministic random bank images over the target's banks — the
        self-contained test-data generator for deserialized artifacts."""
        rng = np.random.default_rng(seed)
        return {f"bank{bid}": rng.integers(-8, 8, size=w).astype(np.int64)
                for bid, w in self.layout.bank_image_size().items()}

    def verify(self, seed: int = 0, check_dfg: bool = True,
               device=None) -> "CompiledKernel":
        """Paper IV-C functional verification; raises AssertionError on any
        final-memory mismatch, returns self on success.

        With the builder spec attached (fresh compiles), the oracle is the
        kernel's golden numpy model on spec-generated test data.  Without it
        (artifacts reloaded from JSON), the oracle is sequential DFG
        reference execution on deterministic random bank images — the same
        bit-exact contract, self-contained in the artifact.  The simulation
        runs on ``device`` (``None``: the CUDA card); the per-seed oracles
        are the scalar host interpreters, as in the JAX package.
        """
        from .verify import check_enabled
        if check_enabled():
            # opt-in static gate (MORPHER_CHECK=1): a clean artifact must
            # be diagnostic-free before any simulation runs
            from ..check import assert_clean
            assert_clean(self)
        if self.spec is not None:
            from .verify import check_dfg_semantics, generate_test_data
            data = generate_test_data(self.spec, seed)
            if check_dfg:
                check_dfg_semantics(self.spec, data)
            init, expected = data.init_banks, data.expected_banks
        else:
            from .verify import reference_banks
            init = self.random_banks(seed)
            banks = reference_banks(self.dfg, init, self.invocations,
                                    self.mapped_iters,
                                    self.arch.datapath_bits)
            expected = {k: np.asarray(v) for k, v in banks.items()}
        final = self.run(init, device=device)
        for bank, exp in expected.items():
            got = np.asarray(final[bank])
            exp = np.asarray(exp)
            if not np.array_equal(got, exp):
                bad = np.nonzero(got != exp)[0][:8]
                raise AssertionError(
                    f"{self.name} (II={self.II}): simulation mismatch in "
                    f"{bank} at words {bad.tolist()}: got {got[bad]}, "
                    f"want {exp[bad]}")
        from .verify import xval_enabled
        if xval_enabled():
            # opt-in second oracle (MORPHER_XVAL=1): the exported
            # instruction stream through the standalone interpreter must
            # also match the simulator bit-for-bit
            from ..isa.xval import cross_validate
            cross_validate(self, seeds=(seed,), device=device)
        return self

    def verify_batch(self, seeds: Sequence[int] = (0,),
                     check_dfg: bool = True,
                     device=None) -> "CompiledKernel":
        """Paper IV-C verification over many seeds in one batched pass.

        All test vectors are generated up front, the DFG oracle runs once
        vectorized over the seed axis, and the cycle-accurate simulation is
        one batched cycle loop through the process-wide runner cache — with
        results bit-identical to per-seed ``verify``.  Both the oracle and
        the simulation run on ``device`` (``None``: the CUDA card).
        Live-out banks (the ones STORE nodes target) are compared
        word-for-word against the oracle;
        every other bank is pinned to its initial image, so a miscompiled
        store straying into an input-only bank still fails.  Raises
        AssertionError naming the first offending (seed, bank, words);
        returns self on success.
        """
        seeds = list(seeds)
        if not seeds:
            return self
        from .verify import check_enabled
        if check_enabled():
            from ..check import assert_clean
            assert_clean(self)
        init_batch, expected = _batch_oracle(self, seeds, check_dfg, device)
        finals = self.run_batch(init_batch, device=device)
        _check_batch(self, seeds, init_batch, expected, finals)
        from .verify import xval_enabled
        if xval_enabled():
            from ..isa.xval import cross_validate
            cross_validate(self, seeds=seeds, device=device)
        return self

    # --------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps({
            "version": ARTIFACT_VERSION,
            "name": self.name,
            "cache_key": self.cache_key,
            "mapped_iters": self.mapped_iters,
            "invocations": self.invocations,
            "meta": self.meta,
            "arch": json.loads(self.arch.to_json()),
            "dfg": self.dfg.to_json_dict(),
            "layout": self.layout.to_json_dict(),
            "options": self.options.to_json_dict(),
            "mapping": self.mapping.to_json_dict(),
            "cfg": json.loads(self.cfg.to_json()),
        })

    @staticmethod
    def from_json(s: str) -> "CompiledKernel":
        d = json.loads(s)
        if d.get("version") != ARTIFACT_VERSION:
            raise ValueError(f"artifact version {d.get('version')} != "
                             f"{ARTIFACT_VERSION}")
        arch = CGRAArch.from_json(json.dumps(d["arch"]))
        dfg = DFG.from_json_dict(d["dfg"])
        return CompiledKernel(
            name=d["name"], arch=arch, dfg=dfg,
            layout=DataLayout.from_json_dict(d["layout"], arch),
            mapping=Mapping.from_json_dict(d["mapping"], dfg, arch),
            cfg=SimConfig.from_json(json.dumps(d["cfg"])),
            mapped_iters=d["mapped_iters"],
            invocations=d["invocations"], meta=d["meta"],
            options=MapperOptions.from_json_dict(d["options"]),
            cache_key=d["cache_key"])


# --------------------------------------------------------------------------
def _batch_oracle(ck: CompiledKernel, seeds: Sequence[int],
                  check_dfg: bool, device=None):
    """Test vectors + expected final banks for one kernel over a seed
    batch — the ``verify_batch`` oracle, shared verbatim by the stacked
    multi-architecture path so both report identical results.  With the
    builder spec attached the oracle is the golden numpy model on
    spec-generated data; reloaded artifacts fall back to sequential DFG
    reference execution on deterministic random bank images."""
    if ck.spec is not None:
        from .verify import (check_dfg_semantics_batch,
                             generate_test_data_batch)
        data = generate_test_data_batch(ck.spec, seeds)
        if check_dfg:
            check_dfg_semantics_batch(ck.spec, data, device=device)
        init_batch = [data.init_row(i) for i in range(len(seeds))]
        expected = data.expected_banks
    else:
        from .verify import reference_banks_batch
        init_batch = [ck.random_banks(s) for s in seeds]
        expected = reference_banks_batch(
            ck.dfg,
            {k: np.stack([ib[k] for ib in init_batch])
             for k in init_batch[0]},
            ck.invocations, ck.mapped_iters,
            ck.arch.datapath_bits, device=device)
    return init_batch, expected


def _check_batch(ck: CompiledKernel, seeds: Sequence[int],
                 init_batch, expected, finals) -> None:
    """Word-for-word comparison of simulated final banks against the
    oracle: live-out banks match ``expected``, every other bank comes back
    untouched.  Raises AssertionError naming the first offending
    (seed, bank, words)."""
    live = set(ck.liveout_banks())
    for i, (seed, final) in enumerate(zip(seeds, finals)):
        for bank in sorted(final):
            got = np.asarray(final[bank])
            # non-liveout banks have no oracle data to compare; they
            # must simply come back untouched
            exp = np.asarray(expected[bank][i] if bank in live
                             else init_batch[i][bank])
            if not np.array_equal(got, exp):
                bad = np.nonzero(got != exp)[0][:8]
                raise AssertionError(
                    f"{ck.name} (II={ck.II}, seed={seed}): batched "
                    f"simulation mismatch in {bank} at words "
                    f"{bad.tolist()}: got {got[bad]}, want {exp[bad]}")


def verify_stacked(kernels: Sequence[CompiledKernel],
                   seeds: Sequence[int] = (0,),
                   check_dfg: bool = True,
                   device=None) -> List[CompiledKernel]:
    """Verify many compiled kernels over one seed batch, stacking every
    group of configs that shares a shape bucket
    (:func:`~repro_torch.core.simulator.stack_signature`) into a single
    multi-architecture cycle loop (:func:`simulate_multi`) on ``device``
    (``None``: the CUDA card).

    The oracles, the comparison and the error messages are exactly
    ``verify_batch``'s — only the launch count changes, which is what
    makes this the throughput path of design-space search evaluation
    (``BENCH_dse_search``'s evaluated-points-per-second headline).
    Raises AssertionError on the first mismatch; returns the kernels in
    input order.
    """
    from .simulator import simulate_multi, stack_signature
    kernels = list(kernels)
    seeds = list(seeds)
    if not seeds or not kernels:
        return kernels
    from .verify import check_enabled
    if check_enabled():
        from ..check import assert_clean
        for ck in kernels:
            assert_clean(ck)
    groups: Dict[tuple, List[int]] = {}
    for idx, ck in enumerate(kernels):
        sig = stack_signature(ck.cfg, ck.mapped_iters,
                              len(ck.invocations))
        groups.setdefault(sig, []).append(idx)
    for sig in sorted(groups):
        idxs = groups[sig]
        prep = [(kernels[i],) + _batch_oracle(kernels[i], seeds, check_dfg,
                                              device)
                for i in idxs]
        finals = simulate_multi(
            [(ck.cfg, init_batch, ck.invocations)
             for ck, init_batch, _exp in prep],
            n_iters=kernels[idxs[0]].mapped_iters, device=device)
        for (ck, init_batch, expected), f in zip(prep, finals):
            _check_batch(ck, seeds, init_batch, expected, f)
    from .verify import xval_enabled
    if xval_enabled():
        from ..isa.xval import cross_validate
        for ck in kernels:
            cross_validate(ck, seeds=seeds, device=device)
    return kernels


# --------------------------------------------------------------------------
class Toolchain:
    """The staged compile pipeline with artifact caching.

    arch:      default target for helpers; ``compile`` always maps a spec
               onto the architecture the spec was built against.
    options:   MapperOptions shared by every compile from this toolchain.
    cache_dir: on-disk artifact cache; None -> $MORPHER_CACHE_DIR or
               ~/.cache/morpher-toolchain, "" -> disk cache disabled.
    """

    def __init__(self, arch: Optional[CGRAArch] = None,
                 options: Optional[MapperOptions] = None,
                 cache_dir: Optional[str] = None):
        self.arch = arch
        self.options = options or MapperOptions()
        self.cache_dir = (default_cache_dir() if cache_dir is None
                          else cache_dir)
        self._memo: Dict[str, CompiledKernel] = {}
        self._memo_err: Dict[str, str] = {}
        self._lock = threading.Lock()
        # recovery ledger of the most recent compile_many fan-out (a
        # dist.fleet.FleetReport), None before the first one / after a
        # FleetError degradation — sweeps surface it in their logs
        self.last_fleet_report = None

    # ----------------------------------------------------------- cache I/O
    def _cache_path(self, key: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f"{key}.json")

    def _error_path(self, key: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f"{key}.err.json")

    def _cache_load(self, key: str) -> Optional[CompiledKernel]:
        path = self._cache_path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                ck = CompiledKernel.from_json(f.read())
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            return None  # corrupt/stale artifact: fall through to recompile
        ck.from_cache = True
        return ck

    def _cache_store(self, key: str, ck: CompiledKernel) -> None:
        path = self._cache_path(key)
        if path is None:
            return
        tmp = None
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(ck.to_json())
            os.replace(tmp, path)  # atomic: concurrent compilers race safely
            tmp = None
        except OSError:
            pass  # cache is an optimization; never fail the compile
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def _cache_load_error(self, key: str) -> Optional[str]:
        """A memoized MapError message for this content address, if any
        (the mapper is deterministic: same inputs, same failure)."""
        with self._lock:
            if key in self._memo_err:
                return self._memo_err[key]
        path = self._error_path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                d = json.load(f)
            if d.get("version") != ARTIFACT_VERSION:
                return None
            err = str(d["map_error"])
        except (OSError, ValueError, KeyError, TypeError,
                json.JSONDecodeError):
            return None
        with self._lock:
            self._memo_err[key] = err
        return err

    def _cache_store_error(self, key: str, msg: str,
                           opt: MapperOptions) -> None:
        if opt.time_budget_s is not None:
            # a budget-limited failure is wall-clock-dependent, not a
            # property of the content address: a retry on an idle machine
            # may map fine, so it must never become a sticky verdict
            return
        with self._lock:
            self._memo_err[key] = msg
        path = self._error_path(key)
        if path is None:
            return
        tmp = None
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(json.dumps({"version": ARTIFACT_VERSION,
                                    "map_error": msg}))
            os.replace(tmp, path)
            tmp = None
        except OSError:
            pass  # cache is an optimization; never fail the compile
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def cached_map_error(self, spec,
                         options: Optional[MapperOptions] = None
                         ) -> Optional[str]:
        """The memoized MapError message for this compile, if one is on
        record — how a sweep reports *why* a point was infeasible (op
        support, bank reachability, II escalation) instead of a generic
        "unmappable"."""
        spec = self._bind(spec)
        return self._cache_load_error(
            spec_cache_key(spec, options or self.options))

    def clear_cache(self) -> None:
        self._memo.clear()
        self._memo_err.clear()
        if self.cache_dir and os.path.isdir(self.cache_dir):
            for fn in os.listdir(self.cache_dir):
                if fn.endswith((".json", ".tmp")):
                    try:
                        os.unlink(os.path.join(self.cache_dir, fn))
                    except OSError:
                        pass

    # ------------------------------------------------------------- compile
    def _lookup(self, key: str, spec: KernelSpec
                ) -> Optional[CompiledKernel]:
        with self._lock:
            hit = self._memo.get(key)
        if hit is not None:
            return hit
        hit = self._cache_load(key)
        if hit is not None:
            hit.spec = spec
            with self._lock:
                self._memo[key] = hit
        return hit

    def load_artifact(self, cache_key: str) -> Optional[CompiledKernel]:
        """Resolve a compiled artifact by its content address: in-process
        memo first, then the on-disk cache.  Returns None when the key is
        unknown — how serve plans serialized with kernel *refs* instead of
        embedded artifacts (``ServePlan.to_json(embed_kernels=False)``)
        re-resolve their kernels on load."""
        with self._lock:
            hit = self._memo.get(cache_key)
        if hit is not None:
            return hit
        return self._cache_load(cache_key)

    def _finish(self, spec: KernelSpec, opt: MapperOptions, key: str,
                mapping: Mapping, cfg: SimConfig,
                use_cache: bool) -> CompiledKernel:
        ck = CompiledKernel(
            name=spec.name, arch=spec.arch, dfg=spec.dfg, layout=spec.layout,
            mapping=mapping, cfg=cfg, mapped_iters=spec.mapped_iters,
            invocations=spec.invocations, meta=dict(spec.meta),
            options=opt, cache_key=key, spec=spec)
        if use_cache:
            self._cache_store(key, ck)
            with self._lock:
                self._memo[key] = ck
        return ck

    def _bind(self, spec) -> KernelSpec:
        """Accept traced front-end kernels: an arch-deferred DSL program
        (anything exposing ``bind(arch)``, e.g.
        ``repro_torch.frontend.KernelProgram``) is traced against this
        toolchain's architecture here."""
        if not isinstance(spec, KernelSpec) and hasattr(spec, "bind"):
            return spec.bind(self.arch)
        return spec

    def compile(self, spec: KernelSpec,
                options: Optional[MapperOptions] = None,
                use_cache: bool = True) -> CompiledKernel:
        """KernelSpec (or frontend KernelProgram) -> CompiledKernel
        (map + generate configuration).

        Memoized in-process and through the content-addressed disk cache;
        a hit returns without re-running placement/routing.
        """
        spec = self._bind(spec)
        opt = options or self.options
        key = spec_cache_key(spec, opt)
        if use_cache:
            hit = self._lookup(key, spec)
            if hit is not None:
                return hit
            err = self._cache_load_error(key)
            if err is not None:
                # err already carries the kernel name (mapper formatting)
                raise MapError(f"{err} [cached result]")
        try:
            mapping = map_kernel_opts(spec.dfg, spec.arch, spec.layout, opt)
            cfg = generate_config(mapping, spec.layout)
        except (MapError, ConfigConflict) as e:
            if use_cache:
                self._cache_store_error(key, _compile_error_str(e), opt)
            raise MapError(_compile_error_str(e)) from e
        return self._finish(spec, opt, key, mapping, cfg, use_cache)

    def compile_many(self, specs: Iterable[KernelSpec],
                     options: Optional[MapperOptions] = None,
                     jobs: Optional[int] = None,
                     use_cache: bool = True,
                     allow_unmapped: bool = False,
                     fleet=None
                     ) -> List[Optional[CompiledKernel]]:
        """Fan independent kernel compiles out across worker processes.

        Cache hits resolve immediately; misses (deduplicated by content
        address) run concurrently.  The mapper is pure Python and therefore
        GIL-bound, so the fan-out uses processes, bridging each compile
        through its JSON form (specs carry unpicklable closures; their
        structural parts round-trip losslessly).  Falls back to sequential
        in-process compiles if no process pool is available.  Workers
        import no torch and never touch the card.

        The fan-out runs through the supervised fleet runner
        (:func:`repro_torch.dist.fleet.run_fleet`): every compile unit gets
        a deadline (``MORPHER_TASK_TIMEOUT_S``), bounded deterministic
        retry, and transparent recovery from killed workers — a lost
        worker re-queues its units on a rebuilt pool instead of crashing
        the sweep.  Content-addressing makes units idempotent, so
        recovery is exact.  Pass a ``fleet``
        :class:`~repro_torch.dist.fleet.FleetConfig` to shard units across
        worker groups (elastic membership, work stealing) or to inject
        faults; the last run's recovery ledger is on
        ``self.last_fleet_report``.

        Specs may target heterogeneous architectures — each compile carries
        its own arch — which is how design-space sweeps fan one kernel
        suite across many CGRA variants.  With ``allow_unmapped=True`` an
        infeasible (arch, kernel) pair yields ``None`` at its index instead
        of raising MapError, so one impossible variant cannot abort a
        sweep; the default remains raise-on-failure.  Failures are
        memoized like successes (deterministic mapper, deterministic
        failure), so a sweep re-run does not re-pay the II escalation of
        its infeasible points.
        """
        specs = [self._bind(s) for s in specs]
        opt = options or self.options
        self.last_fleet_report = None   # set again iff a fan-out runs
        keys = [spec_cache_key(s, opt) for s in specs]
        results: List[Optional[CompiledKernel]] = [None] * len(specs)
        todo: Dict[str, List[int]] = {}      # cache_key -> spec indices

        def unmapped(idxs: List[int], err: str) -> None:
            if not allow_unmapped:
                # err already carries the kernel name (mapper formatting)
                raise MapError(err)

        for i, (spec, key) in enumerate(zip(specs, keys)):
            hit = self._lookup(key, spec) if use_cache else None
            if hit is not None:
                results[i] = hit
                continue
            err = self._cache_load_error(key) if use_cache else None
            if err is not None:
                unmapped([i], f"{err} [cached result]")
                continue    # allow_unmapped: stays None
            todo.setdefault(key, []).append(i)

        def finish(key: str, idxs: List[int], mapping: Mapping,
                   cfg: SimConfig) -> None:
            ck = self._finish(specs[idxs[0]], opt, key, mapping, cfg,
                              use_cache)
            for i in idxs:
                results[i] = ck

        if jobs is None:
            jobs = min(len(todo), os.cpu_count() or 1) or 1
        if fleet is not None:
            # an explicit fleet config is a request to shard: even a
            # 1-CPU host runs the supervised fan-out so fault injection
            # and the recovery paths behave identically everywhere
            jobs = max(jobs, fleet.groups)
        order = list(todo.items())
        if len(order) > 1 and jobs > 1:
            payloads = [json.dumps({
                "dfg": specs[idxs[0]].dfg.to_json_dict(),
                "arch": json.loads(specs[idxs[0]].arch.to_json()),
                "layout": specs[idxs[0]].layout.to_json_dict(),
                "options": opt.to_json_dict(),
            }) for _key, idxs in order]
            # the supervised fleet runner sits on the shared pool (which
            # handles start-method selection, REPL-driver detection and
            # nested-worker suppression) and adds deadlines, retry and
            # killed-worker recovery; results=None means no fan-out is
            # available here — go sequential.  A unit failing past its
            # retry budget (FleetError) degrades the same way: the
            # sequential path is bit-identical by contract.
            from ..dist.fleet import FleetConfig, FleetError, run_fleet
            fcfg = fleet if fleet is not None else FleetConfig()
            if fcfg.max_inflight is None:
                import dataclasses
                fcfg = dataclasses.replace(fcfg, max_inflight=jobs)
            try:
                report = run_fleet(_compile_worker, payloads, fcfg,
                                   inline_fallback=False)
                outs = report.results
            except FleetError:
                report, outs = None, None
            self.last_fleet_report = report
            if outs is not None:
                for (key, idxs), out in zip(order, outs):
                    d = json.loads(out)
                    if "map_error" in d:
                        if use_cache:
                            self._cache_store_error(key, d["map_error"],
                                                    opt)
                        unmapped(idxs, d["map_error"])
                        continue
                    spec = specs[idxs[0]]
                    finish(key, idxs,
                           Mapping.from_json_dict(d["mapping"], spec.dfg,
                                                  spec.arch),
                           SimConfig.from_json(json.dumps(d["cfg"])))
                order = []
        for key, idxs in order:              # sequential path / fallback
            spec = specs[idxs[0]]
            try:
                mapping = map_kernel_opts(spec.dfg, spec.arch, spec.layout,
                                          opt)
                cfg = generate_config(mapping, spec.layout)
            except (MapError, ConfigConflict) as e:
                if use_cache:
                    self._cache_store_error(key, _compile_error_str(e), opt)
                unmapped(idxs, _compile_error_str(e))
                continue
            finish(key, idxs, mapping, cfg)
        return results

    # --------------------------------------------- instruction-stream export
    def export_streams(self, kernel, out_dir: str,
                       options: Optional[MapperOptions] = None
                       ) -> Dict[str, str]:
        """Lower a kernel to the per-PE instruction-stream artifact family
        (``repro_torch.isa``): ``instructions.csv`` + ``kernel.asm`` +
        ``stream_manifest.json`` written under ``out_dir``.

        ``kernel`` may be a :class:`CompiledKernel`, a spec, or an
        arch-deferred frontend program (compiled here first; compiles are
        cache hits after the first).  The artifacts are byte-deterministic
        — two cold exports of the same kernel are ``cmp``-identical —
        which is what makes them a deployment format rather than a debug
        dump.  Returns filename -> written path.
        """
        ck = (kernel if isinstance(kernel, CompiledKernel)
              else self.compile(kernel, options))
        from ..isa.encode import export_streams
        return export_streams(ck, out_dir)

    def cross_validate(self, kernel, seeds: Sequence[int] = (0,),
                       options: Optional[MapperOptions] = None,
                       device=None) -> CompiledKernel:
        """Run the exporter -> standalone-interpreter loop and assert the
        final memory image is bit-identical to ``simulate()`` (on
        ``device``; ``None``: the CUDA card) for every seed — the flow's
        independent second oracle (the interpreter shares no code with
        the torch simulator).  Raises AssertionError on the first
        diverging (seed, bank, word); returns the compiled kernel."""
        ck = (kernel if isinstance(kernel, CompiledKernel)
              else self.compile(kernel, options))
        from ..isa.xval import cross_validate
        cross_validate(ck, seeds=seeds, device=device)
        return ck

    def check(self, kernel, options: Optional[MapperOptions] = None):
        """Static legality audit (``repro_torch.check``): run the mapping,
        config and instruction-stream checkers over one kernel without
        simulating it.  ``kernel`` may be a :class:`CompiledKernel`, a
        spec, or an arch-deferred frontend program (compiled here first).
        Returns the list of :class:`~repro_torch.check.Diagnostic` records
        — empty for a clean artifact (the ``MORPHER_CHECK=1`` contract)."""
        ck = (kernel if isinstance(kernel, CompiledKernel)
              else self.compile(kernel, options))
        from ..check import check_kernel
        return check_kernel(ck)

    def verify_many(self, kernels: Iterable, seeds: Sequence[int] = (0,),
                    check_dfg: bool = True,
                    jobs: Optional[int] = None,
                    fleet=None,
                    stacked: bool = False,
                    device=None) -> List[CompiledKernel]:
        """Batch-verify many kernels over many seeds — the verification-
        fleet entry point.

        ``kernels`` may mix :class:`CompiledKernel` artifacts, specs and
        arch-deferred frontend programs; anything uncompiled goes through
        ``compile_many`` first — that process fan-out is the fleet-
        supervised stage (pass a ``fleet``
        :class:`~repro_torch.dist.fleet.FleetConfig` to shard it across
        worker groups / inject faults; a lost worker re-queues its compile
        units instead of crashing the fleet).  Each kernel then verifies
        every seed in one ``verify_batch`` pass *in this process*, on
        ``device`` (``None``: the CUDA card): fleet workers never
        simulate, and the bit-exactness contract pins this path, so it
        must not silently swap oracles under distribution.
        Raises AssertionError on the first mismatch; returns the compiled
        kernels in input order.

        ``stacked=True`` routes the simulations through
        :func:`verify_stacked`: kernels sharing a shape bucket batch
        their *config planes* into one multi-architecture cycle loop —
        same oracles, same word-for-word comparison, fewer launches.
        """
        items = list(kernels)
        compiled: List[Optional[CompiledKernel]] = [
            k if isinstance(k, CompiledKernel) else None for k in items]
        todo = [k for k, ck in zip(items, compiled) if ck is None]
        if todo:
            done = iter(self.compile_many(todo, jobs=jobs, fleet=fleet))
            compiled = [ck if ck is not None else next(done)
                        for ck in compiled]
        if stacked:
            verify_stacked(compiled, seeds, check_dfg=check_dfg,
                           device=device)
        else:
            for ck in compiled:
                ck.verify_batch(seeds, check_dfg=check_dfg, device=device)
        return compiled


_default: Optional[Toolchain] = None
_default_lock = threading.Lock()


def default_toolchain() -> Toolchain:
    """Process-wide shared Toolchain with default MapperOptions and the
    standard cache location — the one-liner entry into the whole flow."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Toolchain()
        return _default
