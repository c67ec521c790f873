"""The port's design-space explorer (``repro_torch.dse``) against the JAX
package's (``repro.dse``): every space enumerates and builds the same
architectures, the first two ``tiny`` variants sweep (cold, warm and
resumed from the checkpoint, verifying on the CPU) into a
``dse_frontier.json`` byte-equal to the reference's, the batched
evaluator with the static pre-screen scores as the reference's, and
NSGA-II and successive-halving searches run identical to the reference's
at the JAX package's own test size."""
import json

import pytest

from repro_torch.core import MapperOptions, Toolchain
from repro_torch.dse import (SPACE_NAMES, SUITE_KERNELS, SearchConfig,
                             area_units, evaluate_points, get_space,
                             kernel_suite, run_search, run_sweep,
                             write_artifacts)

SUITE = ["requant-int8"]
CFG = SearchConfig(algo="nsga2", seed=3, generations=2, population=3)


def _snapshot(sr):
    return {"evaluated": [r.to_json_dict() for r in sr.evaluated],
            "population": sr.population, "history": sr.history}


@pytest.mark.parametrize("name", SPACE_NAMES)
def test_get_space_equals_the_reference(name):
    from repro.dse import get_space as ref_get_space
    from repro.dse.pareto import area_units as ref_area_units
    got, want = get_space(name), ref_get_space(name)
    assert [p.to_json_dict() for p in got] == \
        [p.to_json_dict() for p in want]
    assert [p.name for p in got] == [p.name for p in want]
    for p, r in zip(got[::7], want[::7]):
        try:
            ref_arch = r.build()
        except ValueError as e:
            with pytest.raises(ValueError, match="."):
                p.build()
            assert str(e)
            continue
        arch = p.build()
        assert arch.to_json() == ref_arch.to_json()
        assert area_units(arch) == ref_area_units(ref_arch)


def test_kernel_suite_is_the_ten_kernel_library():
    from repro.dse import ArchPoint as RefArchPoint
    from repro.dse import kernel_suite as ref_kernel_suite
    from repro_torch.dse import ArchPoint
    suite = kernel_suite(ArchPoint(4, 4).build())
    ref = ref_kernel_suite(RefArchPoint(4, 4).build())
    assert tuple(suite) == SUITE_KERNELS == tuple(ref)
    for k in suite:
        assert suite[k].dfg.canonical_dict() == ref[k].dfg.canonical_dict()


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """tiny[:2] swept by the port from a cold cache, then by the JAX
    package on the same cache (the keys and artifacts are shared)."""
    from repro.core.mapper import MapperOptions as RefMapperOptions
    from repro.core.toolchain import Toolchain as RefToolchain
    from repro.dse import get_space as ref_get_space
    from repro.dse import run_sweep as ref_run_sweep
    from repro.dse import write_artifacts as ref_write_artifacts
    root = tmp_path_factory.mktemp("dse")
    cache = str(root / "cache")
    points = get_space("tiny")[:2]
    tc = Toolchain(options=MapperOptions(ii_max=20), cache_dir=cache)
    cold = run_sweep(points, toolchain=tc, checkpoint=str(root / "ck.json"),
                     device="cpu")
    write_artifacts(cold, str(root / "cold"), space="tiny")
    ref = ref_run_sweep(ref_get_space("tiny")[:2], toolchain=RefToolchain(
        options=RefMapperOptions(ii_max=20), cache_dir=cache))
    ref_write_artifacts(ref, str(root / "ref"), space="tiny")
    return root, points, cache, cold


def _frontier_bytes(out):
    return (out / "dse_frontier.json").read_bytes()


def test_cold_sweep_frontier_equals_the_reference(swept):
    root, points, _cache, cold = swept
    assert [r.name for r in cold] == [p.name for p in points]
    assert all(r.ok for r in cold)
    assert _frontier_bytes(root / "cold") == _frontier_bytes(root / "ref")
    rows = json.loads((root / "cold" / "BENCH_dse_sweep.json").read_text())
    ref_rows = json.loads((root / "ref" / "BENCH_dse_sweep.json").read_text())
    assert rows == ref_rows


def test_warm_and_resumed_sweeps_equal_the_reference(swept):
    root, points, cache, _cold = swept
    want = _frontier_bytes(root / "ref")
    warm = run_sweep(points, toolchain=Toolchain(
        options=MapperOptions(ii_max=20), cache_dir=cache), device="cpu")
    write_artifacts(warm, str(root / "warm"), space="tiny")
    assert _frontier_bytes(root / "warm") == want

    ckpt = root / "ck.json"
    for kept in (2, 1):             # the whole checkpoint, then half of it
        logs = []
        resumed = run_sweep(points, toolchain=Toolchain(
            options=MapperOptions(ii_max=20), cache_dir=cache),
            checkpoint=str(ckpt), log=logs.append, device="cpu")
        assert any(f"checkpoint: {kept} variant" in s for s in logs)
        write_artifacts(resumed, str(root / f"resumed{kept}"), space="tiny")
        assert _frontier_bytes(root / f"resumed{kept}") == want
        d = json.loads(ckpt.read_text())
        del d["variants"][points[1].name]
        ckpt.write_text(json.dumps(d))


def test_evaluate_points_with_prescreen_equals_the_reference(swept):
    from repro.core.mapper import MapperOptions as RefMapperOptions
    from repro.core.toolchain import Toolchain as RefToolchain
    from repro.dse import get_space as ref_get_space
    from repro.dse.explore import evaluate_points as ref_evaluate
    _root, points, cache, _cold = swept
    kw = dict(seeds=(0, 1), suite_names=("GEMM", "dwconv"),
              static_check=True)
    got = evaluate_points(points, toolchain=Toolchain(
        options=MapperOptions(ii_max=20), cache_dir=cache),
        device="cpu", **kw)
    want = ref_evaluate(ref_get_space("tiny")[:2], toolchain=RefToolchain(
        options=RefMapperOptions(ii_max=20), cache_dir=cache), **kw)
    assert [r.to_json_dict() for r in got] == \
        [r.to_json_dict() for r in want]
    assert all(o.status == "ok" for r in got for o in r.kernels.values())


@pytest.fixture(scope="module")
def toolchains():
    from repro.core.mapper import MapperOptions as RefMapperOptions
    from repro.core.toolchain import Toolchain as RefToolchain
    return (Toolchain(options=MapperOptions(ii_max=20), cache_dir=""),
            RefToolchain(options=RefMapperOptions(ii_max=20), cache_dir=""))


@pytest.mark.parametrize("cfg, suite", [
    (CFG, SUITE),
    (SearchConfig(algo="halving", seed=1, generations=2, population=2,
                  eta=2), ["requant-int8", "dwconv"])],
    ids=["nsga2", "halving"])
def test_search_runs_identical_to_the_reference(cfg, suite, toolchains):
    from repro.dse import SearchConfig as RefSearchConfig
    from repro.dse import get_space as ref_get_space
    from repro.dse import run_search as ref_run_search
    tc, ref_tc = toolchains
    a = run_search(get_space("tiny"), cfg, toolchain=tc, suite=suite,
                   device="cpu")
    b = run_search(get_space("tiny"), cfg, toolchain=tc, suite=suite,
                   device="cpu")
    want = ref_run_search(ref_get_space("tiny"),
                          RefSearchConfig(**cfg.to_json_dict()),
                          toolchain=ref_tc, suite=suite)
    assert _snapshot(a) == _snapshot(b) == _snapshot(want)
    assert (a.n_requested, a.n_partial) == (want.n_requested,
                                            want.n_partial)
    assert len(a.history) == cfg.generations


def test_resumed_search_equals_cold_run(tmp_path, toolchains):
    tc, _ref_tc = toolchains
    ckpt = str(tmp_path / "search_ckpt.json")
    short = SearchConfig(algo="nsga2", seed=3, generations=1, population=3)
    run_search(get_space("tiny"), short, toolchain=tc, suite=SUITE,
               checkpoint=ckpt, device="cpu")
    cold = run_search(get_space("tiny"), CFG, toolchain=tc, suite=SUITE,
                      device="cpu")
    resumed = run_search(get_space("tiny"), CFG, toolchain=tc, suite=SUITE,
                         checkpoint=ckpt, device="cpu")
    assert _snapshot(resumed) == _snapshot(cold)
