"""Quickstart of the PyTorch port: the complete Morpher flow through the
unified compile API, with the kernel authored in the traced Pallas-style
DSL.

The paper's pipeline (Fig. 3) — ADL architecture, DFG generation, modulo-
scheduling mapper, configuration generation, cycle-accurate simulation
(torch, on ``--device``), functional verification — is exposed as one
staged object:

    Toolchain(arch, options).compile(spec) -> CompiledKernel

Kernels are no longer hand-wired DFGs: ``repro_torch.frontend`` traces a
restricted-Python loop body (array-ref loads/stores, traced arithmetic,
counter primitives) into the DFG + data layout + invocation schedule the
toolchain consumes.  `CompiledKernel` is the serializable compiled
artifact (DFG, layout, mapping, configuration) with `run(init_banks)` /
`verify(seed)` / `to_json()`.  Compiles are memoized through a
content-addressed on-disk cache keyed by the *canonical* DFG form + arch
ADL JSON + MapperOptions ($MORPHER_CACHE_DIR, default
~/.cache/morpher-toolchain; "" disables).

Mapping runs on the host; every simulation runs on ``--device``: by
default the CUDA card (with no card the script raises), ``--device cpu``
for the host.

Run:  python examples/quickstart_torch.py
      add --device cpu to simulate on the host
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (CompiledKernel, KernelSpec,  # noqa: E402
                              MapperOptions, Toolchain, assign_layout,
                              build_gemm, cluster_4x4)
from repro_torch.core.layout import ArrayDecl  # noqa: E402
from repro_torch.core.verify import generate_test_data  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.frontend import KernelContext  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device the simulations run on (default: "
                         "the CUDA card; 'cpu' for the host)")
    dev = resolve_device(ap.parse_args().device)

    # 1. architecture (ADL): 4x4 PEs, two 8 kB banks, 16-bit datapath
    arch = cluster_4x4()
    print(f"target: {arch.name}, {arch.rows}x{arch.cols} PEs, "
          f"{len(arch.banks)} banks, {arch.datapath_bits}-bit datapath")

    # 2. write a kernel in the DSL: Y[n] = 3 * X[n] over one mapped loop.
    #    The tracer lowers the Python body to the DFG IR; layout declares
    #    where each array lives in the banked memories.
    N = 32
    layout = assign_layout(arch, [ArrayDecl("Y", N, bank_pref=0),
                                  ArrayDecl("X", N, bank_pref=1)])
    ctx = KernelContext("triple", layout)
    X, Y = ctx.arrays("X", "Y")
    n = ctx.counter(stop=N - 1, name="n")     # the mapped loop variable
    Y[n] = X[n] * 3
    dfg = ctx.build()
    print(f"DSL kernel 'triple': {dfg.n_nodes} DFG nodes "
          f"(mem={dfg.n_mem_nodes}) traced from 3 lines of Python")

    px, py = layout.placements["X"], layout.placements["Y"]

    def init_banks(rng):
        banks = {f"bank{bid}": np.zeros(w, dtype=np.int64)
                 for bid, w in layout.bank_image_size().items()}
        banks[px.bank_array][px.base:px.base + N] = rng.integers(-99, 99, N)
        return banks

    def golden(banks):
        out = {k: v.copy() for k, v in banks.items()}
        out[py.bank_array][py.base:py.base + N] = \
            3 * banks[px.bank_array][px.base:px.base + N]
        return out

    spec = KernelSpec(name=dfg.name, dfg=dfg, arch=arch, layout=layout,
                      mapped_iters=N, invocations=[{}],
                      golden=golden, init_banks=init_banks)

    # 3. compile: map (II escalation from MII) + configuration generation,
    #    memoized through the content-addressed artifact cache
    tc = Toolchain(arch, MapperOptions())
    t0 = time.time()
    ck = tc.compile(spec)
    print(f"compiled in {(time.time()-t0)*1e3:.0f} ms "
          f"({'cache hit' if ck.from_cache else 'cold'}): II={ck.II} "
          f"(MII={ck.mii}), utilization={ck.utilization:.1%}")

    # 4. test data -> simulate -> verify (paper section IV-C, one call)
    ck.verify(device=dev)
    print("verification: post-simulation memory == golden model: True")

    # 5. the library kernels go through the same front end: base GEMM
    #    (Listing 1) is itself a traced DSL kernel now
    spec_g = build_gemm(TI=6, TK=8, TJ=6, unroll=1, arch=arch)
    ck_g = tc.compile(spec_g)
    print(f"library kernel {spec_g.name}: nodes={spec_g.dfg.n_nodes}, "
          f"II={ck_g.II} (MII={ck_g.mii}, {ck_g.mapping.mii_parts}), "
          f"depth={ck_g.depth}")
    ck_g.verify(device=dev)

    # ... run() alone for custom inputs:
    data = generate_test_data(spec_g)
    final = ck_g.run(data.init_banks, device=dev)
    assert all((final[k] == data.expected_banks[k]).all() for k in final)

    # 6. batched verification: all seeds' test vectors up front, one
    #    batched cycle loop through the process-wide runner cache —
    #    bit-identical to per-seed verify()
    t0 = time.time()
    ck_g.verify_batch(seeds=range(8), device=dev)
    print(f"batched verify: 8 seeds in one batched pass "
          f"({(time.time()-t0)*1e3:.0f} ms), bit-identical to sequential")

    # 7. the artifact round-trips through JSON and still verifies
    #    bit-exactly — no Python closures needed on the consuming side
    art = ck_g.to_json()
    ck2 = CompiledKernel.from_json(art)
    ck2.verify(device=dev)
    print(f"artifact: {len(art)} bytes JSON; reloaded copy verifies "
          f"bit-exactly")

    # 8. a second compile of the same traced kernel is a cache hit
    t0 = time.time()
    again = Toolchain(arch).compile(build_gemm(TI=6, TK=8, TJ=6, unroll=1,
                                               arch=arch))
    print(f"recompile: {(time.time()-t0)*1e3:.0f} ms, "
          f"from_cache={again.from_cache}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
