"""The port's static legality checker (``repro_torch.check``) against the
JAX package's (``repro.check``): clean libraries diagnostic-free,
``check_report.json`` byte-equal to the reference's (in memory and from
both CLIs), every mutation class caught by its intended rule, the
mutation gate's score >= 0.95 with a ``CorpusReport`` equal to the
reference's, the dead-mutant probe's verdicts equal to the reference's
(simulating on the CPU), and the DSE pre-screen."""
import dataclasses
import json

import pytest

from repro_torch.check import (RULES, assert_clean, check_kernel, errors,
                               report_json)
from repro_torch.check.mutate import (CLASSES, MIN_SCORE, _check_mutant,
                                      _probe_dead, mutate_one, mutation_gate)
from repro_torch.core import Toolchain, cluster_4x4, table1_kernels
from repro_torch.frontend.library import dsl_kernels


@pytest.fixture(scope="module")
def compiled_all():
    """The ten-kernel library, compiled through the shared artifact cache
    (its keys and bytes are the JAX package's)."""
    specs = {**table1_kernels(small=True), **dsl_kernels()}
    return dict(zip(specs, Toolchain().compile_many(list(specs.values()))))


def _reference(ck):
    from repro.core.toolchain import CompiledKernel as RefCompiledKernel
    return RefCompiledKernel.from_json(ck.to_json())


def _report(check, cks):
    return {name: {"II": ck.II, "cache_key": ck.cache_key,
                   "diagnostics": check(ck)} for name, ck in cks.items()}


@pytest.mark.parametrize("torus", [False, True], ids=["mesh", "torus"])
def test_clean_library_has_no_diagnostics(torus):
    from repro_torch.dse.explore import kernel_suite
    arch = dataclasses.replace(cluster_4x4(), torus=True,
                               name="morpher-cluster-4x4-torus") \
        if torus else cluster_4x4()
    suite = kernel_suite(arch)
    assert len(suite) == 10
    for ck in Toolchain().compile_many(list(suite.values())):
        assert check_kernel(ck) == [], ck.name
        assert_clean(ck)


def test_check_report_equals_the_reference(compiled_all):
    from repro.check import check_kernel as ref_check
    from repro.check import report_json as ref_report_json
    got = report_json(_report(check_kernel, compiled_all))
    want = ref_report_json(_report(
        ref_check, {n: _reference(ck) for n, ck in compiled_all.items()}))
    assert got == want
    payload = json.loads(got)
    assert payload["clean"] is True and payload["n_errors"] == 0
    assert set(payload["rules"]) == set(RULES)


def test_cli_report_is_byte_equal_to_the_references(tmp_path, capsys):
    from repro.check.__main__ import main as ref_main
    from repro_torch.check.__main__ import main
    assert main(["--out", str(tmp_path / "port")]) == 0
    assert ref_main(["--out", str(tmp_path / "ref")]) == 0
    capsys.readouterr()
    name = "check_report.json"
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "ref" / name).read_bytes()


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_mutation_class_caught_by_intended_rule(cls, compiled_all):
    layer, intended = CLASSES[cls]
    assert intended in RULES
    sites = 0
    for ck in compiled_all.values():
        made = mutate_one(ck, cls, seed=0, index=0)
        if made is None:
            continue
        sites += 1
        artifact, desc = made
        fired = {d.rule for d in _check_mutant(ck, layer, artifact)}
        assert intended in fired, (ck.name, cls, desc, sorted(fired))
    assert sites > 0, f"no kernel offered a site for class {cls!r}"


def test_mutation_gate_equals_the_reference(compiled_all):
    from repro.check.mutate import mutation_gate as ref_gate
    cks = list(compiled_all.values())
    got = mutation_gate(cks, seed=0, per_class=2, device="cpu")
    want = ref_gate([_reference(ck) for ck in cks], seed=0, per_class=2)
    assert got.score >= MIN_SCORE and got.live_misses == []
    assert got.to_json_dict() == want.to_json_dict()


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_probe_verdict_equals_the_reference(cls, compiled_all):
    """The dead-mutant probe on a mutant of every class (the gate probes
    only the misses, and the library has none): the port's verdict,
    simulating on the CPU, is the reference's."""
    from repro.check.mutate import _probe_dead as ref_probe
    from repro.check.mutate import mutate_one as ref_mutate_one
    layer, _rule = CLASSES[cls]
    for name in ("requant-int8", "dwconv"):
        ck = compiled_all[name]
        made = mutate_one(ck, cls, seed=0, index=0)
        if made is None:
            continue
        ref = _reference(ck)
        ref_made = ref_mutate_one(ref, cls, seed=0, index=0)
        assert made[1] == ref_made[1]
        assert _probe_dead(ck, layer, made[0], device="cpu") == \
            ref_probe(ref, layer, ref_made[0]), (name, made[1])


def test_dse_prescreen_flags_a_corrupt_point(compiled_all):
    from repro_torch.dse.explore import _prescreen
    ck = compiled_all["GEMM"]
    assert _prescreen(ck) == ""
    cfg, _desc = mutate_one(ck, "opcode_clobber", seed=0, index=0)
    assert "CFG-OPC-RANGE" in _prescreen(dataclasses.replace(ck, cfg=cfg))
    with pytest.raises(AssertionError, match="CFG-OPC-RANGE"):
        assert_clean(dataclasses.replace(ck, cfg=cfg))
    assert errors(Toolchain().check(ck)) == []
