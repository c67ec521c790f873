"""ML micro-kernel library: the paper's Listings 1-5 as traced DSL kernels.

Each builder returns a :class:`KernelSpec` — the DFG of the mapped loop
level, the bank data layout, the host-side invocation schedule (outer
sequential loops that stay on the host processor, exactly as in the paper's
tiled dataflow), and a numpy golden model.

The DFGs are produced by the ``repro_torch.frontend`` tracer: the mapped loop
body is written as restricted Python over a :class:`KernelContext`
(array-ref loads/stores, traced arithmetic, counter primitives for the
induction chains) instead of ~60 lines of hand-wired ``DFGBuilder`` nodes
per kernel.  The traced DFGs are canonical-form-identical to the historic
hand-built ones (``tests/handbuilt_kernels.py`` pins this via
``spec_cache_key`` equality), so mappings, verify oracles and compile
cache keys are unchanged by the front-end redesign.

Variants (paper Table I):
  GEMM        base: innermost k loop mapped, (i, j) live-ins per invocation
  GEMM-U      k-loop unrolled by 4 (Listing 3)
  GEMM-U-C    all three loops coalesced into one (Listing 4)
  CONV        base: innermost k2 loop mapped, (c, i, j, k1) live-ins
  CONV-U-C-1  k1/k2 fully unrolled (K=3), innermost spatial loop mapped
  CONV-U-C-2  all loops coalesced (Listing 5)

Four further kernels — depthwise conv, average pooling, a bias+ReLU-fused
GEMM epilogue and an int8 requantize stage — live in
``repro_torch.frontend.library``; they exist only as DSL kernels (no hand-built
counterparts).

Addressing is bank-local: LOAD/STORE nodes target ``bank<N>`` pseudo-arrays
and the data layout's base offsets are folded into the address arithmetic,
mirroring Morpher's co-generated data layout.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..frontend.tracer import KernelContext, unroll as _unroll_range
from .adl import CGRAArch, cluster_4x4
from .dfg import DFG
from .layout import ArrayDecl, DataLayout, assign_layout


# --------------------------------------------------------------------------
@dataclass
class KernelSpec:
    name: str
    dfg: DFG
    arch: CGRAArch
    layout: DataLayout
    mapped_iters: int                     # iterations of the mapped loop per invocation
    invocations: List[Dict[str, int]]     # live-in values per invocation
    golden: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]
    init_banks: Callable[[np.random.Generator], Dict[str, np.ndarray]]
    # cost-model metadata (full-problem dims; see costmodel.py)
    meta: Dict[str, int] = field(default_factory=dict)

    def bank_images(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        return self.init_banks(rng)


def _bank_arrays(layout: DataLayout) -> Dict[str, np.ndarray]:
    return {f"bank{bid}": np.zeros(w, dtype=np.int64)
            for bid, w in layout.bank_image_size().items()}


def _wrap16(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    x = ((x + (1 << 15)) & 0xFFFF) - (1 << 15)
    return x


# ======================================================================
# GEMM  (Listings 1, 3, 4): O[TI,TJ] += W[TI,TK] @ I[TK,TJ]
# ======================================================================
def _gemm_layout(arch: CGRAArch, TI: int, TK: int, TJ: int) -> DataLayout:
    """Output-stationary layout.  Preferred: W+O on bank0, I on bank1 (the
    accumulator recurrence and the weight stream share a port budget).
    When the O tile fills a whole bank (the paper's 64x16x64 tile has an
    8 kB O == one full bank), O gets bank0 alone and W streams with I."""
    try:
        return assign_layout(arch, [
            ArrayDecl("W", TI * TK, bank_pref=0),
            ArrayDecl("O", TI * TJ, bank_pref=0),
            ArrayDecl("I", TK * TJ, bank_pref=1),
        ])
    except ValueError:
        return assign_layout(arch, [
            ArrayDecl("O", TI * TJ, bank_pref=0),
            ArrayDecl("W", TI * TK, bank_pref=1),
            ArrayDecl("I", TK * TJ, bank_pref=1),
        ])


def _gemm_init(layout: DataLayout, TI: int, TK: int, TJ: int, lo=-8, hi=8):
    def init(rng: np.random.Generator) -> Dict[str, np.ndarray]:
        banks = _bank_arrays(layout)
        W = rng.integers(lo, hi, size=TI * TK)
        I = rng.integers(lo, hi, size=TK * TJ)
        pw, pi, po = (layout.placements[k] for k in ("W", "I", "O"))
        banks[pw.bank_array][pw.base:pw.base + pw.words] = W
        banks[pi.bank_array][pi.base:pi.base + pi.words] = I
        banks[po.bank_array][po.base:po.base + po.words] = 0
        return banks
    return init


def _gemm_golden(layout: DataLayout, TI: int, TK: int, TJ: int):
    def golden(banks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: v.copy() for k, v in banks.items()}
        pw, pi, po = (layout.placements[k] for k in ("W", "I", "O"))
        W = banks[pw.bank_array][pw.base:pw.base + pw.words].reshape(TI, TK)
        I = banks[pi.bank_array][pi.base:pi.base + pi.words].reshape(TK, TJ)
        O = banks[po.bank_array][po.base:po.base + po.words].reshape(TI, TJ)
        O = _wrap16(O + W @ I)
        out[po.bank_array][po.base:po.base + po.words] = O.reshape(-1)
        return out
    return golden


def build_gemm(TI: int = 64, TK: int = 16, TJ: int = 64,
               arch: Optional[CGRAArch] = None,
               unroll: int = 1, coalesced: bool = False) -> KernelSpec:
    """GEMM micro-kernel on one CGRA cluster (output-stationary).

    unroll=1, coalesced=False  -> base GEMM (map the k loop)
    unroll=4, coalesced=False  -> GEMM-U   (Listing 3)
    unroll=4, coalesced=True   -> GEMM-U-C (Listing 4)
    """
    arch = arch or cluster_4x4()
    assert TK % unroll == 0
    layout = _gemm_layout(arch, TI, TK, TJ)
    U = unroll

    ctx = KernelContext(
        f"gemm{'-u' if U > 1 else ''}{'-c' if coalesced else ''}", layout)
    W, I, O = ctx.arrays("W", "I", "O")
    if not coalesced:
        cU = ctx.const(U)
        i, j = ctx.livein("i"), ctx.livein("j")
        k = ctx.counter(step=cU, init=-U, stop=TK - U, name="k")
    else:
        # Listing 4: single coalesced loop; i/j/k are register-carried.
        i, j, k = ctx.coalesce(TI, TJ, (TK, U))

    # ---- body: O[i][j] += sum_u W[i][k+u] * I[k+u][j]
    wa = W.addr(i * TK + k)
    wl = [W.at(a) for a in [wa + u for u in _unroll_range(U)]]
    ia = I.addr(k * TJ + j)
    il = [I.at(a) for a in [ia + u * TJ for u in _unroll_range(U)]]
    psum = ctx.treesum(w * x for w, x in zip(wl, il))
    ctx.accumulate(O, O.addr(i * TJ + j), psum)
    dfg = ctx.build()

    if coalesced:
        mapped_iters = TI * TJ * (TK // U)
        invocations: List[Dict[str, int]] = [{}]
    else:
        mapped_iters = TK // U
        invocations = [{"i": ii, "j": jj} for ii in range(TI) for jj in range(TJ)]

    return KernelSpec(
        name=dfg.name, dfg=dfg, arch=arch, layout=layout,
        mapped_iters=mapped_iters, invocations=invocations,
        golden=_gemm_golden(layout, TI, TK, TJ),
        init_banks=_gemm_init(layout, TI, TK, TJ),
        meta=dict(TI=TI, TK=TK, TJ=TJ, unroll=U, coalesced=int(coalesced),
                  macs_per_iter=U, liveins_per_inv=0 if coalesced else 2),
    )


# ======================================================================
# CONV (Listing 2, 5): O[c,i,j] += I[i+k1, j+k2] * W[c,k1,k2]   (valid)
#   tile: one output channel resident at a time (TCo = 1 in Table I).
# ======================================================================
def _conv_layout(arch: CGRAArch, IH: int, IW: int, OH: int, OW: int,
                 K: int) -> DataLayout:
    return assign_layout(arch, [
        ArrayDecl("O", OH * OW, bank_pref=0),
        ArrayDecl("W", K * K, bank_pref=0),
        ArrayDecl("I", IH * IW, bank_pref=1),
    ])


def _conv_init(layout: DataLayout, IH: int, IW: int, OH: int, OW: int,
               K: int):
    pw, pi, po = (layout.placements[k] for k in ("W", "I", "O"))

    def init(rng: np.random.Generator) -> Dict[str, np.ndarray]:
        banks = _bank_arrays(layout)
        banks[pi.bank_array][pi.base:pi.base + pi.words] = \
            rng.integers(-8, 8, size=IH * IW)
        banks[pw.bank_array][pw.base:pw.base + pw.words] = \
            rng.integers(-4, 4, size=K * K)
        banks[po.bank_array][po.base:po.base + po.words] = 0
        return banks
    return init


def _conv_golden(layout: DataLayout, IH: int, IW: int, OH: int, OW: int,
                 K: int):
    pw, pi, po = (layout.placements[k] for k in ("W", "I", "O"))

    def golden(banks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: v.copy() for k, v in banks.items()}
        I = banks[pi.bank_array][pi.base:pi.base + pi.words].reshape(IH, IW)
        W = banks[pw.bank_array][pw.base:pw.base + pw.words].reshape(K, K)
        O = banks[po.bank_array][po.base:po.base + po.words].reshape(OH, OW)
        O = O.astype(np.int64)
        for kk1 in range(K):
            for kk2 in range(K):
                O = O + I[kk1:kk1 + OH, kk2:kk2 + OW] * W[kk1, kk2]
        out[po.bank_array][po.base:po.base + po.words] = _wrap16(O).reshape(-1)
        return out
    return golden


def build_conv(OH: int = 62, OW: int = 62, K: int = 3,
               IH: Optional[int] = None, IW: Optional[int] = None,
               arch: Optional[CGRAArch] = None,
               variant: str = "base") -> KernelSpec:
    """CONV micro-kernel (single input channel -> one output channel tile).

    variant: "base"  -- map the innermost k2 loop (live-ins i, j, k1)
             "uc1"   -- k1/k2 fully unrolled, map the j loop (live-in i)
             "uc2"   -- all spatial loops coalesced (Listing 5)
    """
    arch = arch or cluster_4x4()
    IH = IH if IH is not None else OH + K - 1
    IW = IW if IW is not None else OW + K - 1
    layout = _conv_layout(arch, IH, IW, OH, OW, K)

    ctx = KernelContext(f"conv-{variant}", layout)
    W, I, O = ctx.arrays("W", "I", "O")

    if variant == "base":
        i, j, k1 = ctx.livein("i"), ctx.livein("j"), ctx.livein("k1")
        k2 = ctx.counter(stop=K - 1, name="k2")

        ival = I[(i + k1) * IW + (j + k2)]
        prod = ival * W[k1 * K + k2]
        ctx.accumulate(O, O.addr(i * OW + j), prod)

        mapped_iters = K
        invocations = [{"i": ii, "j": jj, "k1": kk}
                       for ii in range(OH) for jj in range(OW)
                       for kk in range(K)]
        liveins_per_inv = 3

    elif variant in ("uc1", "uc2"):
        c1, c0 = ctx.const(1), ctx.const(0)
        if variant == "uc1":
            i = ctx.livein("i")
            j = ctx.counter(step=c1, init=-1, stop=OW - 1, name="j")
        else:
            # Listing 5: coalesce (i, j) into one induction chain.
            j, jwrap = ctx.wrapping_counter(c1, OW, init=-1, name="j")
            i = ctx.gated_counter(c1, jwrap, name="i")

        # fully unrolled K x K MACs against the resident accumulator word
        oa = O.addr(i * OW + j)
        oval = O.at(oa, name="oval")
        prods = []
        for kk1 in _unroll_range(K):
            rm = (i + kk1) * IW
            for kk2 in _unroll_range(K):
                iv = I.at(I.addr(rm + (j + kk2)), name=f"iv{kk1}{kk2}")
                prods.append(iv * W[kk1 * K + kk2])
        st = O.store_at(oa, oval + ctx.treesum(prods), name="ost")
        ctx.loop_carried(st, oval)

        if variant == "uc1":
            mapped_iters = OW
            invocations = [{"i": ii} for ii in range(OH)]
            liveins_per_inv = 1
        else:
            mapped_iters = OH * OW
            invocations = [{}]
            liveins_per_inv = 0
    else:
        raise ValueError(variant)

    dfg = ctx.build()

    return KernelSpec(
        name=dfg.name, dfg=dfg, arch=arch, layout=layout,
        mapped_iters=mapped_iters, invocations=invocations,
        golden=_conv_golden(layout, IH, IW, OH, OW, K),
        init_banks=_conv_init(layout, IH, IW, OH, OW, K),
        meta=dict(OH=OH, OW=OW, K=K, IH=IH, IW=IW,
                  liveins_per_inv=liveins_per_inv),
    )


# ----------------------------------------------------------------- registry
def table1_kernels(small: bool = False,
                   arch: Optional[CGRAArch] = None) -> Dict[str, KernelSpec]:
    """The six Table-I kernels.  ``small=True`` returns reduced dims for
    fast simulation-based verification (DFG structure identical);
    ``arch`` retargets the whole set (default: the paper's 4x4 cluster),
    the entry point design-space sweeps build their suites from."""
    if small:
        g = dict(TI=6, TK=8, TJ=6)
        c = dict(OH=5, OW=5, K=3)
    else:
        g = dict(TI=64, TK=16, TJ=64)
        c = dict(OH=62, OW=62, K=3)
    g["arch"] = c["arch"] = arch
    return {
        "GEMM": build_gemm(**g, unroll=1, coalesced=False),
        "GEMM-U": build_gemm(**g, unroll=4, coalesced=False),
        "GEMM-U-C": build_gemm(**g, unroll=4, coalesced=True),
        "CONV": build_conv(**c, variant="base"),
        "CONV-U-C-1": build_conv(**c, variant="uc1"),
        "CONV-U-C-2": build_conv(**c, variant="uc2"),
    }
