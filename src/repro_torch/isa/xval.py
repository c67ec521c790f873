"""Cross-validation: exported streams vs the cycle-accurate simulator.

The harness closes the loop export -> parse -> interpret and asserts the
standalone interpreter's final memory image is **bit-identical** to
``simulate()`` on the same initial banks — for every requested seed.  Both
executables claim to implement the same machine; agreeing word-for-word
across the kernel library means (a) the exported artifact really carries
the full configuration (nothing simulator-private leaked into behaviour)
and (b) each implementation is an independent oracle for the other.

Entry points:

  ``cross_validate(ck, seeds)``             in-memory round trip
  ``cross_validate_dir(ck, stream_dir)``    against on-disk artifacts
  ``Toolchain.cross_validate(kernel, ...)`` the toolchain-level wrapper
  ``MORPHER_XVAL=1``                        opt-in second oracle inside
                                            the verify flow (see
                                            ``core.verify.xval_enabled``)
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

from .encode import CSV_NAME, MANIFEST_NAME, encode_kernel
from .interp import InstructionStream, interpret, load_stream, parse_stream


def _init_banks(ck, seed: int) -> Dict[str, np.ndarray]:
    """Test images for one seed: the spec's own generator when the builder
    spec is attached (fresh compiles — realistic data distributions), the
    artifact's deterministic random banks otherwise."""
    if ck.spec is not None:
        rng = np.random.default_rng(seed)
        return ck.spec.init_banks(rng)
    return ck.random_banks(seed)


def stream_for(ck) -> InstructionStream:
    """Export in memory and parse back — the decoded form every
    cross-validation executes."""
    artifacts = encode_kernel(ck)
    return parse_stream(artifacts[CSV_NAME],
                        json.loads(artifacts[MANIFEST_NAME]))


def _compare(ck, seed: int, sim: Dict[str, np.ndarray],
             got: Dict[str, np.ndarray]) -> None:
    if sorted(sim) != sorted(got):
        raise AssertionError(
            f"{ck.name}: interpreter banks {sorted(got)} != simulator "
            f"banks {sorted(sim)}")
    for bank in sorted(sim):
        s, g = np.asarray(sim[bank]), np.asarray(got[bank])
        if not np.array_equal(s, g):
            bad = np.nonzero(s != g)[0][:8]
            raise AssertionError(
                f"{ck.name} (II={ck.II}, seed={seed}): instruction-stream "
                f"interpreter diverges from simulate() in {bank} at words "
                f"{bad.tolist()}: interpreter {g[bad]}, simulator {s[bad]}")


def cross_validate(ck, seeds: Sequence[int] = (0,),
                   stream: Optional[InstructionStream] = None,
                   device=None) -> int:
    """Assert interpreter ≡ simulator on ``ck`` for every seed; returns
    the number of seeds checked.  The simulator runs on ``device``
    (``None``: the CUDA card); the interpreter stays on the host.  Raises
    AssertionError naming the first diverging (seed, bank, words)."""
    if stream is None:
        stream = stream_for(ck)
    for seed in seeds:
        init = _init_banks(ck, seed)
        sim = ck.run(init, device=device)
        got = interpret(stream, init, ck.invocations, ck.mapped_iters)
        _compare(ck, seed, sim, got)
    return len(list(seeds))


def cross_validate_dir(ck, stream_dir: str,
                       seeds: Sequence[int] = (0,), device=None) -> int:
    """Same check, but parsing the artifacts back off disk — the form the
    CI smoke job uses after an ``export_streams``."""
    return cross_validate(ck, seeds, stream=load_stream(stream_dir),
                          device=device)
