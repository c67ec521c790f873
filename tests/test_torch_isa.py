"""The port's instruction-stream backend (``repro_torch.isa``) against the
JAX package's (``repro.isa``): the pinned GEMM-small stream, exports
byte-deterministic and byte-equal to the reference's, the port's
interpreter word-equal to the reference's on the ten-kernel library, the
interpreter equal to the port's simulator on the CPU
(``cross_validate(device="cpu")``), a tampered stream failing, and the
``python -m repro_torch.isa`` CLI."""
import json
import os
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro_torch.core import Toolchain, build_gemm, table1_kernels
from repro_torch.frontend.library import dsl_kernels
from repro_torch.isa import (ASM_NAME, CSV_NAME, MANIFEST_NAME, STREAM_FORMAT,
                             StreamError, cross_validate, cross_validate_dir,
                             encode_kernel, export_streams, interpret,
                             load_stream, parse_stream, stream_for)
from repro_torch.isa.xval import _init_banks

GOLDEN_CSV = os.path.join(os.path.dirname(__file__),
                          "golden_gemm_small_instructions.csv")
NAMES = [*table1_kernels(small=True), *dsl_kernels()]


@pytest.fixture(scope="module")
def compiled_all():
    """The ten-kernel library, compiled through the shared artifact cache
    (its keys and bytes are the JAX package's)."""
    specs = {**table1_kernels(small=True), **dsl_kernels()}
    return dict(zip(specs, Toolchain().compile_many(list(specs.values()))))


@pytest.fixture(scope="module")
def gemm_ck(compiled_all):
    return compiled_all["GEMM"]


def _reference(ck):
    from repro.core.toolchain import CompiledKernel as RefCompiledKernel
    return RefCompiledKernel.from_json(ck.to_json())


def test_golden_gemm_small_stream_is_pinned(gemm_ck):
    with open(GOLDEN_CSV, encoding="utf-8") as f:
        assert encode_kernel(gemm_ck)[CSV_NAME] == f.read()


@pytest.mark.parametrize("name", NAMES)
def test_export_is_deterministic_and_equals_the_reference(name, compiled_all,
                                                           tmp_path):
    from repro.isa.encode import encode_kernel as ref_encode
    ck = compiled_all[name]
    p1 = export_streams(ck, str(tmp_path / "one"))
    p2 = export_streams(ck, str(tmp_path / "two"))
    assert sorted(p1) == sorted(p2) == sorted(
        (CSV_NAME, ASM_NAME, MANIFEST_NAME))
    want = ref_encode(_reference(ck))
    for fn in p1:
        with open(p1[fn], "rb") as f1, open(p2[fn], "rb") as f2:
            one = f1.read()
            assert one == f2.read(), fn
        assert one.decode() == want[fn], fn


@pytest.mark.parametrize("name", NAMES)
def test_interpreter_matches_the_reference_word_for_word(name, compiled_all):
    """The port's interpreter and the JAX package's (pure numpy both) on
    the same stream and banks: every final word equal, two seeds."""
    from repro.isa.xval import stream_for as ref_stream_for
    from repro.isa.interp import interpret as ref_interpret
    ck = compiled_all[name]
    ref = _reference(ck)
    assert asdict(stream_for(ck)) == asdict(ref_stream_for(ref))
    for seed in (0, 1):
        init = _init_banks(ck, seed)
        got = interpret(stream_for(ck), init, ck.invocations,
                        ck.mapped_iters)
        want = ref_interpret(ref_stream_for(ref), init, ref.invocations,
                             ref.mapped_iters)
        assert sorted(got) == sorted(want)
        for bank in want:
            np.testing.assert_array_equal(got[bank], want[bank])


@pytest.mark.parametrize("name", NAMES)
def test_cross_validate_on_cpu(name, compiled_all):
    """Interpreter ≡ the port's simulator (on the CPU), two seeds."""
    assert cross_validate(compiled_all[name], seeds=(0, 1),
                          device="cpu") == 2


def test_tampered_stream_fails_cross_validation(gemm_ck):
    art = encode_kernel(gemm_ck)
    man = json.loads(art[MANIFEST_NAME])
    lines = art[CSV_NAME].split("\n")
    col = {c: i for i, c in enumerate(lines[0].split(","))}
    out = [lines[0]]
    for ln in lines[1:-1]:
        v = ln.split(",")
        if v[col["opcode"]] == "store":
            v[col["tstart"]] = "1000000"
        out.append(",".join(v))
    stream = parse_stream("\n".join(out) + "\n", man)
    with pytest.raises(AssertionError, match="diverges"):
        cross_validate(gemm_ck, seeds=(0,), stream=stream, device="cpu")


def test_parse_rejects_malformed_streams(gemm_ck):
    art = encode_kernel(gemm_ck)
    man = json.loads(art[MANIFEST_NAME])
    csv_text = art[CSV_NAME]
    with pytest.raises(StreamError, match="stream_format"):
        parse_stream(csv_text, {**man, "stream_format": STREAM_FORMAT + 1})
    with pytest.raises(StreamError, match="header"):
        parse_stream(csv_text, {**man, "columns": man["columns"][::-1]})
    lines = csv_text.split("\n")
    with pytest.raises(StreamError, match="records"):
        parse_stream("\n".join(lines[:-2]) + "\n", man)
    with pytest.raises(StreamError, match="duplicate"):
        parse_stream("\n".join(lines[:-2] + [lines[1], ""]), man)


def test_roundtrip_through_disk(gemm_ck, tmp_path):
    export_streams(gemm_ck, str(tmp_path))
    assert cross_validate_dir(gemm_ck, str(tmp_path), seeds=(0,),
                              device="cpu") == 1
    assert load_stream(str(tmp_path)) == stream_for(gemm_ck)


def test_toolchain_level_wrappers(tmp_path):
    tc = Toolchain(cache_dir=str(tmp_path / "cache"))
    spec = build_gemm(TI=4, TK=4, TJ=4, unroll=1)
    paths = tc.export_streams(spec, str(tmp_path / "streams"))
    assert all(os.path.exists(p) for p in paths.values())
    assert tc.cross_validate(spec, seeds=(0, 1), device="cpu").name == \
        spec.name


def test_cross_validate_needs_a_card_unless_told(gemm_ck, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cross_validate(gemm_ck, seeds=(0,))


def test_cli_exports_the_golden_stream(tmp_path, capsys):
    from repro_torch.isa.__main__ import main
    out = tmp_path / "streams"
    assert main(["--out", str(out), "--kernels", "GEMM", "--xval",
                 "--seeds", "0,1", "--device", "cpu"]) == 0
    assert "xval OK (2 seed(s)" in capsys.readouterr().out
    with open(GOLDEN_CSV, "rb") as f:
        assert (out / "GEMM" / CSV_NAME).read_bytes() == f.read()
