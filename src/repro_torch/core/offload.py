"""Edge-deployment analyzer: the paper's technique as a first-class
framework feature.

For any assigned LM architecture, enumerate the distinct GEMM micro-kernel
shapes its layers execute — q/k/v/o projections, MLA low-rank factors, MoE
expert FFNs and routers, RWKV time/channel-mix projections, Mamba
in/out projections — tile each one onto the Morpher CGRA model with the
paper's output-stationary dataflow (section IV-A), run the *actual* mapper
on the micro-kernel DFG, and report II / MII / utilization / estimated
latency — Table-I methodology applied to the model zoo
(`examples/edge_deploy_torch.py --arch <id>`).

Tiles are chosen per site from a fixed ladder, taking the largest
bank-capacity-feasible tile clamped to the site's (M, K, N); a full site
then costs ``ceil(M/TI) * ceil(K/TK) * ceil(N/TJ)`` tile executions per
GEMM instance, times ``count_per_layer`` instances per layer, times the
number of layers the site appears in.  ``repro_torch.serve.plan`` builds
on the same enumeration + tiling to hand the serving engine a complete
offload plan.

This is the PyTorch port's copy of ``repro.core.offload``: host code that
gives the same sites, tiles and reports, and imports no torch of its own
(the configs it reads carry a torch dtype)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..configs.registry import get_config
from ..models.common import ModelConfig
from .adl import CGRAArch, cluster_4x4
from .costmodel import F_CLK_HZ
from .kernels_lib import KernelSpec, _gemm_layout, build_gemm
from .mapper import MapError
from .toolchain import CompiledKernel, Toolchain, default_toolchain


@dataclass
class GemmSite:
    """One GEMM shape a model executes: ``M x K @ K x N``,
    ``count_per_layer`` instances per layer, present in ``layers`` layers
    (``None`` -> every layer of the model)."""
    name: str
    M: int
    K: int
    N: int
    count_per_layer: int = 1
    layers: Optional[int] = None

    def n_layers(self, cfg: ModelConfig) -> int:
        return cfg.n_layers if self.layers is None else self.layers


def model_gemm_sites(cfg: ModelConfig, tokens: int = 64) -> List[GemmSite]:
    """Every GEMM micro-kernel site of one forward pass at ``tokens``
    tokens, per architecture family (decode steps re-cost the same sites
    at M = active batch; see ``repro_torch.serve.plan``)."""
    t = tokens
    d = cfg.d_model

    if cfg.family == "ssm":                              # rwkv6
        r = cfg.decay_lora_rank
        return [GemmSite("tmix_rkvo", t, d, d, 4),
                GemmSite("decay_lora_a", t, d, r),
                GemmSite("decay_lora_b", t, r, d),
                GemmSite("cmix_in", t, d, cfg.d_ff),
                GemmSite("cmix_out", t, cfg.d_ff, d)]

    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    if cfg.family == "hybrid":                           # zamba2
        from ..models.mamba2 import mamba_dims
        d_inner, nh, _hp, ds = mamba_dims(cfg)
        sites = [GemmSite("mamba_in", t, d, 2 * d_inner + 2 * ds + nh),
                 GemmSite("mamba_out", t, d_inner, d)]
        if cfg.attn_every:
            # ONE shared attention block, applied every attn_every layers
            n_apps = cfg.n_layers // cfg.attn_every
            sites += [GemmSite("shared_q", t, d, H * hd, layers=n_apps),
                      GemmSite("shared_kv", t, d, Hkv * hd, 2,
                               layers=n_apps),
                      GemmSite("shared_o", t, H * hd, d, layers=n_apps),
                      GemmSite("shared_ffn_in", t, d, cfg.d_ff, 2,
                               layers=n_apps),
                      GemmSite("shared_ffn_out", t, cfg.d_ff, d,
                               layers=n_apps)]
        return sites

    # transformer families: dense / moe / audio / vlm
    sites = [GemmSite("q_proj", t, d, H * hd)]
    if cfg.mla:
        sites += [GemmSite("q_lora", t, d, cfg.q_lora_rank),
                  GemmSite("kv_lora", t, d,
                           cfg.kv_lora_rank + cfg.qk_rope_dim)]
    else:
        sites += [GemmSite("kv_proj", t, d, Hkv * hd, 2)]
    sites += [GemmSite("o_proj", t, H * hd, d)]
    if cfg.moe:
        n_moe = cfg.n_layers - cfg.first_k_dense
        active = cfg.top_k + cfg.n_shared_experts
        sites += [GemmSite("router", t, d, cfg.n_experts, layers=n_moe),
                  GemmSite("expert_ffn_in", t, d, cfg.moe_d_ff, 2 * active,
                           layers=n_moe),
                  GemmSite("expert_ffn_out", t, cfg.moe_d_ff, d, active,
                           layers=n_moe)]
        if cfg.first_k_dense:
            f = cfg.dense_d_ff or cfg.d_ff
            sites += [GemmSite("dense_ffn_in", t, d, f, 2,
                               layers=cfg.first_k_dense),
                      GemmSite("dense_ffn_out", t, f, d,
                               layers=cfg.first_k_dense)]
    else:
        sites += [GemmSite("ffn_in", t, d, cfg.d_ff, 2),
                  GemmSite("ffn_out", t, cfg.d_ff, d)]
    return sites


# ----------------------------------------------------------------- tiling
# Largest-first tile ladder; the head is the paper's IV-A on-chip tile.
TILE_LADDER: Tuple[Tuple[int, int, int], ...] = (
    (16, 8, 16), (8, 8, 8), (8, 4, 8), (4, 4, 4), (2, 2, 2))


def tile_unroll(TK: int) -> int:
    """Largest k-loop unroll factor in {4, 2, 1} dividing the tile's TK."""
    for u in (4, 2, 1):
        if TK % u == 0:
            return u
    return 1


def choose_gemm_tile(arch: CGRAArch, site: Optional[GemmSite] = None,
                     ladder: Sequence[Tuple[int, int, int]] = TILE_LADDER
                     ) -> Tuple[int, int, int]:
    """The largest bank-capacity-feasible (TI, TK, TJ) GEMM tile for
    ``arch``, clamped to the site's (M, K, N) so tiny sites (low-rank
    factors, routers, decode steps) don't pay for a mostly-empty tile.
    Deterministic: first feasible entry of the ladder wins."""
    last_err: Optional[Exception] = None
    for TI, TK, TJ in ladder:
        if site is not None:
            TI = max(1, min(TI, site.M))
            TK = max(1, min(TK, site.K))
            TJ = max(1, min(TJ, site.N))
        try:
            _gemm_layout(arch, TI, TK, TJ)   # capacity check only
        except ValueError as e:
            last_err = e
            continue
        return TI, TK, TJ
    raise MapError(f"no bank-capacity-feasible GEMM tile on {arch.name} "
                   f"(ladder {list(ladder)}): {last_err}")


def site_tile_count(site: GemmSite, tile: Tuple[int, int, int],
                    M: Optional[int] = None) -> int:
    """Tile executions covering one (M, K, N) GEMM instance of the site."""
    TI, TK, TJ = tile
    m = site.M if M is None else M
    return (math.ceil(m / TI) * math.ceil(site.K / TK)
            * math.ceil(site.N / TJ))


# ----------------------------------------------------------------- reports
@dataclass
class OffloadReport:
    site: str
    tile: Tuple[int, ...]
    nodes: int
    II: int
    mii: int
    utilization: float
    est_tile_us: float          # one full tile (all host invocations)
    tiles: int = 1              # tiles per GEMM instance of the site
    instances: int = 1          # count_per_layer * layers
    est_site_ms: float = 0.0    # tiles * instances * tile latency


def analyze_kernel(kernel, arch=None,
                   toolchain: Optional[Toolchain] = None) -> OffloadReport:
    """Table-I methodology for any kernel: compile a :class:`KernelSpec`
    — or a traced ``repro_torch.frontend`` ``KernelProgram``, bound here to
    the requested architecture — and report II / MII / utilization and the
    estimated full-kernel latency (all invocations of the mapped loop)."""
    tc = toolchain or default_toolchain()
    if hasattr(kernel, "bind") and not isinstance(kernel, KernelSpec):
        kernel = kernel.bind(arch or tc.arch)
    elif arch is not None and kernel.arch is not arch:
        raise ValueError(
            f"{kernel.name}: arch= applies only to arch-deferred kernel "
            f"programs; this KernelSpec is already bound to "
            f"{kernel.arch.name} (rebuild the spec against the target arch)")
    ck = tc.compile(kernel)
    cyc = ck.schedule_cycles()
    us = len(ck.invocations) * cyc / F_CLK_HZ * 1e6
    return OffloadReport(
        site=ck.name, tile=(), nodes=ck.dfg.n_nodes, II=ck.II, mii=ck.mii,
        utilization=ck.utilization, est_tile_us=us, est_site_ms=us / 1e3)


def analyze_gemm_tile(TI: int = 16, TK: int = 8, TJ: int = 16,
                      unroll: int = 4, arch=None,
                      toolchain: Optional[Toolchain] = None
                      ) -> CompiledKernel:
    tc = toolchain or default_toolchain()
    arch = arch or tc.arch or cluster_4x4()
    spec = build_gemm(TI=TI, TK=TK, TJ=TJ, arch=arch,
                      unroll=min(unroll, tile_unroll(TK)), coalesced=False)
    return tc.compile(spec)


def analyze_arch_gemms(arch_id: str, tokens: int = 64,
                       max_kernels: Optional[int] = None,
                       toolchain: Optional[Toolchain] = None
                       ) -> List[OffloadReport]:
    """Per-site offload reports for one model: each site gets a feasible
    tile (shared tiles dedup through the content-addressed compile cache
    across sites, models, processes and sessions), and its full-site
    latency scales the compiled tile by the site's actual tile counts —
    ``ceil(M/TI) * ceil(K/TK) * ceil(N/TJ) * count_per_layer * layers`` —
    not a fixed per-tile invocation count."""
    tc = toolchain or default_toolchain()
    cfg = get_config(arch_id)
    arch = tc.arch or cluster_4x4()
    sites = model_gemm_sites(cfg, tokens)
    if max_kernels:
        sites = sites[:max_kernels]
    out: List[OffloadReport] = []
    for s in sites:
        tile = choose_gemm_tile(arch, s)
        try:
            ck = analyze_gemm_tile(*tile, arch=arch, toolchain=tc)
        except MapError:
            continue
        tile_us = (len(ck.invocations) * ck.schedule_cycles()
                   / F_CLK_HZ * 1e6)
        tiles = site_tile_count(s, tile)
        instances = s.count_per_layer * s.n_layers(cfg)
        out.append(OffloadReport(
            site=s.name, tile=tile, nodes=ck.dfg.n_nodes, II=ck.II,
            mii=ck.mii, utilization=ck.utilization, est_tile_us=tile_us,
            tiles=tiles, instances=instances,
            est_site_ms=tiles * instances * tile_us / 1e3))
    return out
