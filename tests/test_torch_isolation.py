"""The port stands alone: no module of repro_torch, not chip_smoke.py, no
examples/*_torch.py and no benchmarks/*_torch.py imports JAX or the JAX
package; importing the
serving engine or the kernel path (the Table-I kernels' ops and the
micro-benchmark) loads neither; and the flow's tools (isa, check, dse,
dist), which fleet worker processes import, load not even torch."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py")) \
    + sorted((ROOT / "benchmarks").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_engine_import_loads_neither_jax_nor_reference():
    code = ("import sys; import repro_torch.serve.engine, "
            "repro_torch.serve.traffic, repro_torch.convert, "
            "repro_torch.kernels.gemm_os.ops, "
            "repro_torch.kernels.conv2d_os.ops, "
            "repro_torch.kernels.qgemm_int8.ops, repro_torch.bench; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_tool_packages_load_neither_torch_nor_jax():
    code = ("import sys; import repro_torch.isa, repro_torch.check, "
            "repro_torch.dse, repro_torch.dist, repro_torch.isa.__main__, "
            "repro_torch.check.__main__, repro_torch.check.mutate; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
