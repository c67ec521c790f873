"""Serve plans: the complete model -> CGRA offload artifact.

``build_serve_plan`` closes the loop between the model zoo and the
toolchain (ROADMAP open item 1, the whole-network-on-CGRA direction of
CGRA4ML): it enumerates every GEMM micro-kernel site of a model
(attention projections, MLA low-rank factors, MoE expert FFNs, RWKV and
Mamba projections — ``offload.model_gemm_sites``), chooses a
bank-capacity-feasible tile per site (``offload.choose_gemm_tile``),
compiles every distinct tile through ``Toolchain.compile_many`` (the
content-addressed cache makes this warm across sites, models and
sessions), and bundles the result as a :class:`ServePlan`:

    site -> {compiled-kernel ref, tile, tile counts, modeled latency}

The plan is a serializable artifact like :class:`CompiledKernel` —
``to_json``/``from_json`` round-trip losslessly, with the compiled tiles
embedded (default) or carried as content-address refs re-resolved through
``Toolchain.load_artifact``.  ``spot_check`` pushes at least one site's
compiled tile through the real cycle-accurate simulator against the
bit-exact verification oracle (paper IV-C), so a plan's modeled numbers
are anchored to simulated hardware, not just the cost model.  The
simulation runs on ``device`` (``None``: the CUDA card; with no card it
raises, as ``CompiledKernel.verify_batch`` does; tests pass ``"cpu"``).

:class:`CGRAExecutionModel` turns a plan into the per-step latency
provider the serving engine consumes: a decode step for B active slots is
the plan's site sum at M = B; a prefill of P prompt tokens is the site
sum at M = P.

This is the PyTorch port of ``repro.serve.plan``: the same plans, with
``to_json`` byte-equal to the reference's, so either package loads the
other's.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.adl import CGRAArch, cluster_4x4
from ..core.costmodel import F_CLK_HZ
from ..core.kernels_lib import build_gemm
from ..core.offload import (GemmSite, choose_gemm_tile, model_gemm_sites,
                            tile_unroll)
from ..core.toolchain import CompiledKernel, Toolchain, default_toolchain
from ..models.common import ModelConfig

PLAN_VERSION = 1


@dataclass(frozen=True)
class PlanSite:
    """One GEMM site of the plan, bound to a compiled tile.

    ``kernel_ref`` is the tile's content address (``CompiledKernel
    .cache_key``); ``tile_cycles`` is the cycle-accurate cost of ONE full
    tile (every host invocation of the mapped loop: fill + steady state +
    drain per invocation).  Latency for an arbitrary token count M scales
    the tile by the site's tile counts — ``ceil(M/TI) * ceil(K/TK) *
    ceil(N/TJ)`` per GEMM instance, ``count_per_layer * layers``
    instances."""
    name: str
    M: int
    K: int
    N: int
    count_per_layer: int
    layers: int
    tile: Tuple[int, int, int]
    kernel_ref: str
    II: int
    mii: int
    tile_cycles: int
    utilization: float

    def tiles(self, M: Optional[int] = None) -> int:
        TI, TK, TJ = self.tile
        m = self.M if M is None else M
        return (math.ceil(m / TI) * math.ceil(self.K / TK)
                * math.ceil(self.N / TJ))

    def instances(self) -> int:
        return self.count_per_layer * self.layers

    def latency_s(self, M: Optional[int] = None) -> float:
        """Modeled full-site latency at M tokens (whole model: every
        instance in every layer the site appears in)."""
        return (self.tiles(M) * self.instances() * self.tile_cycles
                / F_CLK_HZ)

    def to_json_dict(self) -> dict:
        return {"name": self.name, "M": self.M, "K": self.K, "N": self.N,
                "count_per_layer": self.count_per_layer,
                "layers": self.layers, "tile": list(self.tile),
                "kernel_ref": self.kernel_ref, "II": self.II,
                "mii": self.mii, "tile_cycles": self.tile_cycles,
                "utilization": self.utilization}

    @staticmethod
    def from_json_dict(d: dict) -> "PlanSite":
        return PlanSite(
            name=d["name"], M=d["M"], K=d["K"], N=d["N"],
            count_per_layer=d["count_per_layer"], layers=d["layers"],
            tile=tuple(d["tile"]), kernel_ref=d["kernel_ref"],
            II=d["II"], mii=d["mii"], tile_cycles=d["tile_cycles"],
            utilization=d["utilization"])


@dataclass
class ServePlan:
    """The model's complete CGRA offload plan: every GEMM site bound to a
    compiled tile, with the compiled artifacts bundled (deduplicated by
    content address — most sites share a tile)."""
    model: str
    arch_name: str
    tokens: int
    sites: List[PlanSite]
    kernels: Dict[str, CompiledKernel] = field(default_factory=dict)

    # ------------------------------------------------------------- model
    def site(self, name: str) -> PlanSite:
        for s in self.sites:
            if s.name == name:
                return s
        raise KeyError(f"plan for {self.model}: no site {name!r}")

    def kernel_for(self, site: PlanSite) -> CompiledKernel:
        try:
            return self.kernels[site.kernel_ref]
        except KeyError:
            raise KeyError(
                f"plan for {self.model}: kernel {site.kernel_ref[:12]}… "
                f"for site {site.name} not bundled (ref-only plan; reload "
                f"with a toolchain whose cache holds it)") from None

    def step_latency_s(self, tokens: int) -> float:
        """Modeled whole-model latency of one forward step at ``tokens``
        tokens per sequence position batch (decode: tokens = active
        slots; prefill: tokens = prompt length)."""
        return sum(s.latency_s(M=tokens) for s in self.sites)

    def decode_step_s(self, active: int) -> float:
        return self.step_latency_s(max(1, active))

    def prefill_s(self, prompt_len: int) -> float:
        return self.step_latency_s(max(1, prompt_len))

    def summary(self) -> str:
        lines = [f"serve plan: {self.model} on {self.arch_name} "
                 f"({len(self.sites)} sites, "
                 f"{len(self.kernels)} compiled tiles, "
                 f"plan tokens {self.tokens})",
                 f"{'site':<16} {'MxKxN':>18} {'xinst':>6} "
                 f"{'tile':>10} {'II':>3} {'tiles':>7} {'site_ms':>9}"]
        for s in self.sites:
            dims = f"{s.M}x{s.K}x{s.N}"
            tile = "x".join(str(t) for t in s.tile)
            lines.append(
                f"{s.name:<16} {dims:>18} {s.instances():>6} {tile:>10} "
                f"{s.II:>3} {s.tiles():>7} {s.latency_s() * 1e3:9.3f}")
        lines.append(f"{'decode step (B=8)':<16}  "
                     f"{self.decode_step_s(8) * 1e3:.3f} ms modeled")
        return "\n".join(lines)

    # ------------------------------------------------------ verification
    def spot_check(self, seeds: Sequence[int] = (0,),
                   n_sites: int = 1, device=None) -> List[str]:
        """Verify >= ``n_sites`` of the plan's compiled tiles bit-exactly
        against the cycle-accurate simulator (paper IV-C oracle), one
        site per distinct kernel first, simulating on ``device`` (``None``:
        the CUDA card).  Returns the verified site names; raises
        AssertionError on any mismatch."""
        checked: List[str] = []
        seen: set = set()
        for s in self.sites:
            if s.kernel_ref in seen:
                continue
            self.kernel_for(s).verify_batch(seeds, device=device)
            seen.add(s.kernel_ref)
            checked.append(s.name)
            if len(checked) >= n_sites:
                break
        if not checked:
            raise AssertionError(
                f"plan for {self.model}: no site available to spot-check")
        return checked

    # ----------------------------------------------------- serialization
    def to_json(self, embed_kernels: bool = True) -> str:
        """Lossless JSON artifact (byte-deterministic: sorted keys).  With
        ``embed_kernels=False`` only content-address refs are written —
        smaller, but loading needs a toolchain cache holding the tiles."""
        d = {
            "version": PLAN_VERSION,
            "model": self.model,
            "arch_name": self.arch_name,
            "tokens": self.tokens,
            "sites": [s.to_json_dict() for s in self.sites],
            "kernels": ({k: json.loads(ck.to_json())
                         for k, ck in sorted(self.kernels.items())}
                        if embed_kernels else {}),
        }
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    @staticmethod
    def from_json(s: str,
                  toolchain: Optional[Toolchain] = None) -> "ServePlan":
        d = json.loads(s)
        if d.get("version") != PLAN_VERSION:
            raise ValueError(
                f"serve plan version {d.get('version')} != {PLAN_VERSION}")
        kernels = {k: CompiledKernel.from_json(json.dumps(v))
                   for k, v in d["kernels"].items()}
        sites = [PlanSite.from_json_dict(sd) for sd in d["sites"]]
        if toolchain is not None:
            for st in sites:                 # resolve ref-only plans
                if st.kernel_ref not in kernels:
                    ck = toolchain.load_artifact(st.kernel_ref)
                    if ck is not None:
                        kernels[st.kernel_ref] = ck
        return ServePlan(model=d["model"], arch_name=d["arch_name"],
                         tokens=d["tokens"], sites=sites, kernels=kernels)


# --------------------------------------------------------------------------
def build_serve_plan(model_cfg: ModelConfig,
                     arch: Optional[CGRAArch] = None,
                     toolchain: Optional[Toolchain] = None,
                     tokens: int = 64,
                     sites: Optional[List[GemmSite]] = None,
                     spot_check: bool = True,
                     spot_check_seeds: Sequence[int] = (0,),
                     device=None) -> ServePlan:
    """Model config -> :class:`ServePlan`.

    Enumerates the model's GEMM sites, chooses a feasible tile per site,
    compiles the distinct tiles in one ``compile_many`` fan-out, and
    (by default) spot-checks one compiled tile through the cycle-accurate
    verification oracle on ``device`` (``None``: the CUDA card) before
    returning."""
    tc = toolchain or default_toolchain()
    arch = arch or tc.arch or cluster_4x4()
    sites = model_gemm_sites(model_cfg, tokens) if sites is None else sites

    chosen = [choose_gemm_tile(arch, s) for s in sites]
    tiles = sorted(set(chosen))
    specs = [build_gemm(TI=TI, TK=TK, TJ=TJ, arch=arch,
                        unroll=tile_unroll(TK), coalesced=False)
             for TI, TK, TJ in tiles]
    compiled = dict(zip(tiles, tc.compile_many(specs)))

    plan_sites: List[PlanSite] = []
    kernels: Dict[str, CompiledKernel] = {}
    for s, tile in zip(sites, chosen):
        ck = compiled[tile]
        kernels[ck.cache_key] = ck
        plan_sites.append(PlanSite(
            name=s.name, M=s.M, K=s.K, N=s.N,
            count_per_layer=s.count_per_layer,
            layers=s.n_layers(model_cfg), tile=tile,
            kernel_ref=ck.cache_key, II=ck.II, mii=ck.mii,
            tile_cycles=len(ck.invocations) * ck.schedule_cycles(),
            utilization=round(ck.utilization, 6)))

    plan = ServePlan(model=model_cfg.name, arch_name=arch.name,
                     tokens=tokens, sites=plan_sites, kernels=kernels)
    if spot_check:
        plan.spot_check(seeds=spot_check_seeds, device=device)
    return plan


# --------------------------------------------------------------------------
class CGRAExecutionModel:
    """Plan-derived per-step latency provider for the serving engine.

    The engine's real forward pass produces the tokens; this model
    produces the modeled wall clock those steps would take on the plan's
    CGRA fabric — decode at M = active slots, prefill at M = prompt
    length.  ``overhead_s`` adds a fixed per-step host handshake."""

    def __init__(self, plan: ServePlan, overhead_s: float = 0.0):
        self.plan = plan
        self.overhead_s = overhead_s
        # decode steps hit a handful of distinct M values; memoize them
        self._memo: Dict[int, float] = {}

    def _step_s(self, tokens: int) -> float:
        t = max(1, tokens)
        hit = self._memo.get(t)
        if hit is None:
            hit = self._memo[t] = self.plan.step_latency_s(t)
        return hit + self.overhead_s

    def decode_step_s(self, active: int) -> float:
        return self._step_s(active)

    def prefill_s(self, prompt_len: int) -> float:
        return self._step_s(prompt_len)
