"""Performance/cost model for Table I of the paper.

Fully-specified first-principles model (the paper's own constants):
  * CGRA clock: 100 MHz,
  * host->CGRA link: 50 MB/s,
  * per-invocation host handshake latency `handshake_us` — the kernel
    invocation overhead the paper highlights for CONV ("transferring outer
    loop iteration variables from the host processor", pipeline drain);
    0 by default, calibrated in benchmarks/table1.py,
  * 16-bit words.

Formulas (documented in EXPERIMENTS.md - Table I):
  cycles/invocation = (n_iters - 1) * II + depth         (fill + steady + drain)
  compute_time      = ceil(invocations / clusters) * cycles/inv / f_clk
  transfer_time     = (array_bytes + livein_bytes) / BW + handshake * invocations
  total             = compute + transfer  (sequential host<->CGRA, worst case)

``clusters`` models data-parallel execution across the target's logical
clusters (the paper's 8x8 = 4 clusters of 4x4): invocations are divided
round-robin across clusters, so compute time shrinks by ~clusters while
transfer and handshake stay whole-problem (the host link is shared).

Utilization follows the paper's definition: DFG nodes per II across the
PE array = nodes / (n_pes * II).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .kernels_lib import KernelSpec
from .mapper import Mapping

F_CLK_HZ = 100e6
LINK_BYTES_PER_S = 50e6
WORD_BYTES = 2


@dataclass
class KernelCost:
    name: str
    nodes: int
    II: int
    mii: int
    fu_only_mii: int
    utilization: float
    invocations: int
    iters_per_inv: int
    cycles_per_inv: int
    compute_ms: float
    transfer_ms: float
    total_ms: float
    speedup: float = 1.0
    mii_parts: Dict[str, int] = field(default_factory=dict)
    clusters: int = 1

    def row(self) -> str:
        return (f"{self.name:<12} {self.nodes:>5} {self.II:>3} ({self.mii})"
                f" {self.utilization*100:7.2f}% {self.compute_ms:10.3f}"
                f" {self.transfer_ms:10.3f} {self.total_ms:10.3f}"
                f" {self.speedup:7.2f}x")


def kernel_cost(spec: KernelSpec, mapping: Mapping, *,
                problem_scale: int = 1,
                array_bytes_moved: float = 0.0,
                handshake_us: float = 0.0,
                clusters: int = 1) -> KernelCost:
    """Cost of executing the full problem on `clusters` data-parallel
    copies of this kernel's mapping (one per logical cluster).

    ``invocations = len(spec.invocations) * problem_scale`` is the
    whole-problem invocation count; compute time is divided across
    clusters — the slowest cluster runs ``ceil(invocations / clusters)``
    of them — while array transfer and per-invocation handshakes stay
    whole-problem (the host<->CGRA link and the invoking host loop are
    shared by all clusters).

    Do not divide twice: callers that pre-scale ``problem_scale`` to
    per-cluster tile steps (the Table-I harness, whose PROBLEM_SCALE is
    ``Co / clusters``) must keep ``clusters=1``.  Likewise a mapping that
    already spans the whole multi-cluster fabric is one configured
    instance — score it with ``clusters=1`` (as the DSE sweep does).

    array_bytes_moved: total off-chip<->on-chip array traffic for the
    whole problem (already accounting for reuse).
    """
    if clusters < 1:
        raise ValueError(f"clusters must be >= 1, got {clusters}")
    II, depth = mapping.II, mapping.depth
    n_inv = len(spec.invocations) * problem_scale
    iters = spec.mapped_iters
    cyc_inv = (iters - 1) * II + depth
    inv_slowest_cluster = -(-n_inv // clusters)
    compute_s = inv_slowest_cluster * cyc_inv / F_CLK_HZ

    livein_bytes = (spec.meta.get("liveins_per_inv", 0) * WORD_BYTES * n_inv)
    transfer_s = ((array_bytes_moved + livein_bytes) / LINK_BYTES_PER_S
                  + handshake_us * 1e-6 * n_inv)

    return KernelCost(
        name=spec.name, nodes=spec.dfg.n_nodes, II=II, mii=mapping.mii,
        fu_only_mii=mapping.mii_parts.get("fu_only_mii", mapping.mii),
        utilization=mapping.utilization,
        invocations=n_inv, iters_per_inv=iters, cycles_per_inv=cyc_inv,
        compute_ms=compute_s * 1e3, transfer_ms=transfer_s * 1e3,
        total_ms=(compute_s + transfer_s) * 1e3,
        mii_parts=dict(mapping.mii_parts),
        clusters=clusters,
    )


# ------------------------------------------------------- Table I problems
def gemm_traffic_bytes(M: int = 64, N: int = 64, K: int = 64,
                       TI: int = 64, TK: int = 16, TJ: int = 64) -> float:
    """Output-stationary schedule (Listing 1): O resident on chip across
    the k-chunks; W and I chunks streamed per step; O in+out once."""
    k_steps = K // TK
    w = TI * TK * WORD_BYTES * k_steps            # one W chunk per k step
    i = TK * TJ * WORD_BYTES * k_steps
    o = TI * TJ * WORD_BYTES * 2                  # load once, store once
    return float(w + i + o)


def conv_traffic_bytes(O1: int = 64, O2: int = 64, Co: int = 64, K: int = 3,
                       per_channel_input: bool = False) -> float:
    """Single-input-channel CONV (Listing 2): I resident (streamed once
    unless per_channel_input), W once, O streamed out per output channel."""
    i1 = (O1 + K - 1) * (O2 + K - 1) * WORD_BYTES
    i = i1 * (Co if per_channel_input else 1)
    w = K * K * Co * WORD_BYTES
    o = O1 * O2 * Co * WORD_BYTES
    return float(i + w + o)
