"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so``
(the hash covers the sources, the headers beside them and the flags), by
``nvcc`` straight into a shared library with a plain C interface: no
PyTorch headers, so a build takes seconds.  All missing libraries are
built by parallel ``nvcc`` processes started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA "
                           "kernels are built on the machine with the card")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_all() -> Dict[str, str]:
    """Build every source whose library is missing, one ``nvcc`` each, all
    started together.  Returns the compiler's output (with ``-Xptxas -v``:
    registers, shared memory, spills) for each source it built."""
    todo = {n: s for n, s in sources().items() if not _target(s).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name, src in todo.items():
            tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        logs = {}
        for name, (proc, tmp) in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {todo[name]}:\n"
                                   f"{logs[name]}")
            os.replace(tmp, _target(todo[name]))
        return logs
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    if name not in _loaded:
        target = _target(sources()[name])
        if not target.exists():
            build_all()
        _loaded[name] = ctypes.CDLL(str(target))
    return _loaded[name]
