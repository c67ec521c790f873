"""DSL-only kernel library: workloads beyond the paper's Table I.

These kernels exist only as traced front-end programs — there is no
hand-built ``DFGBuilder`` counterpart, which is the point: each is a
handful of lines over a :class:`KernelContext` where the equivalent manual
node wiring would be another ~60-line builder.

  dwconv          depthwise 3x3 conv, C channels (MobileNet-style stage)
  avgpool2x2      2x2 average pooling (stride 2, power-of-two divide)
  gemm-bias-relu  fused bias + ReLU GEMM epilogue (output tile post-pass)
  requant-int8    int8 requantization (multiplier/shift + saturation),
                  the CGRA-side model of ``repro_torch.kernels.qgemm_int8``'s
                  output stage — its golden is the same ``requantize_ref``

:class:`KernelProgram` wraps a builder so kernels can be handed to
``Toolchain.compile`` before an architecture is chosen (the toolchain
binds its own default target).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.adl import CGRAArch, cluster_4x4
from ..core.kernels_lib import KernelSpec, _bank_arrays, _wrap16
from ..core.layout import ArrayDecl, DataLayout, assign_layout
from .tracer import KernelContext, unroll


@dataclass(frozen=True)
class KernelProgram:
    """An arch-deferred DSL kernel: ``bind(arch)`` traces it into the
    :class:`KernelSpec` that ``Toolchain.compile`` consumes (and
    ``Toolchain.compile`` accepts a ``KernelProgram`` directly, binding
    its own default architecture)."""
    name: str
    build: Callable[[Optional[CGRAArch]], KernelSpec]

    def bind(self, arch: Optional[CGRAArch] = None) -> KernelSpec:
        return self.build(arch)


def _placed(layout: DataLayout, *names: str):
    return tuple(layout.placements[n] for n in names)


# ======================================================================
# Depthwise 3x3 convolution: O[c,i,j] += I[c,i+k1,j+k2] * W[c,k1,k2]
# ======================================================================
def build_dwconv(C: int = 2, OH: int = 5, OW: int = 5, K: int = 3,
                 arch: Optional[CGRAArch] = None) -> KernelSpec:
    """Depthwise conv: per-channel KxK filters, fully unrolled MACs, the
    innermost spatial j loop mapped, (c, i) live-ins per invocation."""
    arch = arch or cluster_4x4()
    IH, IW = OH + K - 1, OW + K - 1
    layout = assign_layout(arch, [
        ArrayDecl("O", C * OH * OW, bank_pref=0),
        ArrayDecl("W", C * K * K, bank_pref=0),
        ArrayDecl("I", C * IH * IW, bank_pref=1),
    ])

    ctx = KernelContext("dwconv", layout)
    W, I, O = ctx.arrays("W", "I", "O")
    c, i = ctx.livein("c"), ctx.livein("i")
    j = ctx.counter(stop=OW - 1, name="j")

    ibase = c * (IH * IW)                 # channel planes
    wbase = c * (K * K)
    oa = O.addr(c * (OH * OW) + i * OW + j)
    oval = O.at(oa, name="oval")
    prods = []
    for k1 in unroll(K):
        row = ibase + (i + k1) * IW
        for k2 in unroll(K):
            prods.append(I[row + (j + k2)] * W[wbase + k1 * K + k2])
    st = O.store_at(oa, oval + ctx.treesum(prods), name="ost")
    ctx.loop_carried(st, oval)
    dfg = ctx.build()

    pw, pi, po = _placed(layout, "W", "I", "O")

    def init(rng: np.random.Generator) -> Dict[str, np.ndarray]:
        banks = _bank_arrays(layout)
        banks[pi.bank_array][pi.base:pi.base + pi.words] = \
            rng.integers(-8, 8, size=C * IH * IW)
        banks[pw.bank_array][pw.base:pw.base + pw.words] = \
            rng.integers(-4, 4, size=C * K * K)
        return banks

    def golden(banks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: v.copy() for k, v in banks.items()}
        Iv = banks[pi.bank_array][pi.base:pi.base + pi.words].reshape(C, IH, IW)
        Wv = banks[pw.bank_array][pw.base:pw.base + pw.words].reshape(C, K, K)
        Ov = banks[po.bank_array][po.base:po.base + po.words] \
            .reshape(C, OH, OW).astype(np.int64)
        for k1 in range(K):
            for k2 in range(K):
                Ov = Ov + Iv[:, k1:k1 + OH, k2:k2 + OW] * Wv[:, k1:k1 + 1,
                                                             k2:k2 + 1]
        out[po.bank_array][po.base:po.base + po.words] = \
            _wrap16(Ov).reshape(-1)
        return out

    return KernelSpec(
        name=dfg.name, dfg=dfg, arch=arch, layout=layout,
        mapped_iters=OW,
        invocations=[{"c": cc, "i": ii} for cc in range(C)
                     for ii in range(OH)],
        golden=golden, init_banks=init,
        meta=dict(C=C, OH=OH, OW=OW, K=K, liveins_per_inv=2))


# ======================================================================
# 2x2 average pooling (stride 2): O[i,j] = mean of the 2x2 input window
# ======================================================================
def build_avgpool2x2(OH: int = 6, OW: int = 6,
                     arch: Optional[CGRAArch] = None) -> KernelSpec:
    """Average pooling with the power-of-two divide as an arithmetic
    shift — a pure streaming kernel (no accumulator recurrence)."""
    arch = arch or cluster_4x4()
    IH, IW = 2 * OH, 2 * OW
    layout = assign_layout(arch, [
        ArrayDecl("O", OH * OW, bank_pref=0),
        ArrayDecl("I", IH * IW, bank_pref=1),
    ])

    ctx = KernelContext("avgpool2x2", layout)
    I, O = ctx.arrays("I", "O")
    i = ctx.livein("i")
    j = ctx.counter(stop=OW - 1, name="j")

    r0 = (i + i) * IW                      # top row of the window
    j2 = j + j
    s = (I[r0 + j2] + I[r0 + (j2 + 1)]
         + I[(r0 + IW) + j2] + I[(r0 + IW) + (j2 + 1)])
    O[i * OW + j] = s >> 2
    dfg = ctx.build()

    pi, po = _placed(layout, "I", "O")

    def init(rng: np.random.Generator) -> Dict[str, np.ndarray]:
        banks = _bank_arrays(layout)
        banks[pi.bank_array][pi.base:pi.base + pi.words] = \
            rng.integers(0, 64, size=IH * IW)
        return banks

    def golden(banks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: v.copy() for k, v in banks.items()}
        Iv = banks[pi.bank_array][pi.base:pi.base + pi.words].reshape(IH, IW)
        Ov = (Iv[0::2, 0::2] + Iv[0::2, 1::2]
              + Iv[1::2, 0::2] + Iv[1::2, 1::2]) >> 2
        out[po.bank_array][po.base:po.base + po.words] = \
            _wrap16(Ov).reshape(-1)
        return out

    return KernelSpec(
        name=dfg.name, dfg=dfg, arch=arch, layout=layout,
        mapped_iters=OW,
        invocations=[{"i": ii} for ii in range(OH)],
        golden=golden, init_banks=init,
        meta=dict(OH=OH, OW=OW, liveins_per_inv=1))


# ======================================================================
# Fused bias + ReLU GEMM epilogue: O[i,j] = relu(ACC[i,j] + B[j])
# ======================================================================
def build_gemm_bias_relu(TI: int = 6, TJ: int = 6,
                         arch: Optional[CGRAArch] = None) -> KernelSpec:
    """The GEMM output-tile epilogue fused on the fabric: per-column bias
    add plus ReLU saturation over the accumulator tile."""
    arch = arch or cluster_4x4()
    layout = assign_layout(arch, [
        ArrayDecl("ACC", TI * TJ, bank_pref=0),
        ArrayDecl("O", TI * TJ, bank_pref=0),
        ArrayDecl("B", TJ, bank_pref=1),
    ])

    ctx = KernelContext("gemm-bias-relu", layout)
    ACC, B, O = ctx.arrays("ACC", "B", "O")
    i = ctx.livein("i")
    j = ctx.counter(stop=TJ - 1, name="j")

    row = i * TJ + j
    O[row] = ctx.relu(ACC[row] + B[j])
    dfg = ctx.build()

    pa, pb, po = _placed(layout, "ACC", "B", "O")

    def init(rng: np.random.Generator) -> Dict[str, np.ndarray]:
        banks = _bank_arrays(layout)
        banks[pa.bank_array][pa.base:pa.base + pa.words] = \
            rng.integers(-512, 512, size=TI * TJ)
        banks[pb.bank_array][pb.base:pb.base + pb.words] = \
            rng.integers(-64, 64, size=TJ)
        return banks

    def golden(banks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: v.copy() for k, v in banks.items()}
        A = banks[pa.bank_array][pa.base:pa.base + pa.words].reshape(TI, TJ)
        Bv = banks[pb.bank_array][pb.base:pb.base + pb.words]
        Ov = np.maximum(_wrap16(A + Bv[None, :]), 0)
        out[po.bank_array][po.base:po.base + po.words] = Ov.reshape(-1)
        return out

    return KernelSpec(
        name=dfg.name, dfg=dfg, arch=arch, layout=layout,
        mapped_iters=TJ,
        invocations=[{"i": ii} for ii in range(TI)],
        golden=golden, init_banks=init,
        meta=dict(TI=TI, TJ=TJ, liveins_per_inv=1))


# ======================================================================
# int8 requantization: R[n] = clamp((X[n] * mult) >> shift, -127, 127)
# ======================================================================
def build_requant_int8(N: int = 48, mult: int = 3, shift: int = 5,
                       arch: Optional[CGRAArch] = None) -> KernelSpec:
    """The output stage of ``repro_torch.kernels.qgemm_int8`` on the fabric:
    fixed-point multiplier/shift requantization with int8 saturation.

    The golden model *is* ``repro_torch.kernels.qgemm_int8.ref.requantize_ref``
    — the CGRA kernel and the int8 GEMM datapath share one oracle, so the
    two implementations of the edge-inference int8 path are pinned to the
    same rounding and saturation semantics.
    """
    arch = arch or cluster_4x4()
    assert 0 < mult < 16 and 0 <= shift < 15
    layout = assign_layout(arch, [
        ArrayDecl("R", N, bank_pref=0),
        ArrayDecl("X", N, bank_pref=1),
    ])

    ctx = KernelContext("requant-int8", layout)
    X, R = ctx.arrays("X", "R")
    n = ctx.counter(stop=N - 1, name="n")
    R[n] = ctx.clamp((X[n] * mult) >> shift, -127, 127)
    dfg = ctx.build()

    px, pr = _placed(layout, "X", "R")

    def init(rng: np.random.Generator) -> Dict[str, np.ndarray]:
        banks = _bank_arrays(layout)
        # int16-safe accumulator range: |x * mult| < 2**15
        banks[px.bank_array][px.base:px.base + px.words] = \
            rng.integers(-2048, 2048, size=N)
        return banks

    def golden(banks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        from ..kernels.qgemm_int8.ref import requantize_ref  # lazy: numpy path
        out = {k: v.copy() for k, v in banks.items()}
        x = banks[px.bank_array][px.base:px.base + px.words]
        out[pr.bank_array][pr.base:pr.base + pr.words] = \
            requantize_ref(x.astype(np.int64), mult, shift)
        return out

    return KernelSpec(
        name=dfg.name, dfg=dfg, arch=arch, layout=layout,
        mapped_iters=N, invocations=[{}],
        golden=golden, init_banks=init,
        meta=dict(N=N, mult=mult, shift=shift, liveins_per_inv=0))


# ----------------------------------------------------------------- registry
DSL_PROGRAMS: List[KernelProgram] = [
    KernelProgram("dwconv", lambda arch=None: build_dwconv(arch=arch)),
    KernelProgram("avgpool2x2",
                  lambda arch=None: build_avgpool2x2(arch=arch)),
    KernelProgram("gemm-bias-relu",
                  lambda arch=None: build_gemm_bias_relu(arch=arch)),
    KernelProgram("requant-int8",
                  lambda arch=None: build_requant_int8(arch=arch)),
]


def dsl_kernels(arch: Optional[CGRAArch] = None) -> Dict[str, KernelSpec]:
    """The four DSL-only kernels, traced against ``arch`` (default:
    the paper's 4x4 cluster)."""
    return {p.name: p.bind(arch) for p in DSL_PROGRAMS}
