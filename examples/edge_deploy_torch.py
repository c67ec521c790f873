"""Edge-deployment analyzer of the PyTorch port (``repro_torch.core.offload``):
apply the paper's CGRA compilation flow to the GEMM micro-kernels of any
assigned LM architecture.

For each projection/FFN GEMM site of the model, tile it onto the Morpher
4x4 cluster (output-stationary, paper section IV-A), compile the tile
through the unified Toolchain (real modulo-scheduling mapper + config
generation), and report II / MII / utilization / estimated tile latency —
Table-I methodology applied to the model zoo.

All sites share one compiled tile artifact: the Toolchain's content-
addressed cache makes every compile after the first — including sweeps
over the whole zoo, and re-runs in later sessions — a cache hit.

The target CGRA defaults to the paper's 4x4 cluster; pass a user-defined
architecture as ``--arch-file <adl.json>`` (the ADL JSON produced by
``CGRAArch.to_json`` — see ``examples/cluster_4x4.adl.json``) to retarget
the whole analysis, the paper's architecture-adaptive claim from the
command line.

The analyzer maps and compiles on the host and simulates nothing, so it
needs no card and takes no ``--device``.

Run:  python examples/edge_deploy_torch.py --arch llama3.2-1b
      add --all to sweep the whole model zoo off one warm cache
      add --arch-file examples/cluster_4x4.adl.json for a custom target
      add --emit-streams DIR to export every distinct compiled tile as
      a per-PE instruction-stream artifact family (repro_torch.isa)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import CGRAArch, MapperOptions, Toolchain  # noqa: E402
from repro_torch.core.adl import cluster_4x4  # noqa: E402
from repro_torch.core.mapper import MapError  # noqa: E402
from repro_torch.core.offload import (analyze_arch_gemms,  # noqa: E402
                                      analyze_gemm_tile, choose_gemm_tile,
                                      model_gemm_sites)


def load_arch_file(path: str) -> CGRAArch:
    """Load and validate a user-defined ADL architecture from JSON."""
    with open(path, "r", encoding="utf-8") as f:
        arch = CGRAArch.from_json(f.read())
    arch.validate()
    return arch


def report_arch(arch_id: str, tokens: int, toolchain: Toolchain) -> None:
    cfg = get_config(arch_id)
    print(f"arch: {arch_id} ({cfg.family}); "
          f"GEMM sites at {tokens} tokens:")
    for s in model_gemm_sites(cfg, tokens):
        print(f"  {s.name:<14} {s.M}x{s.K}x{s.N}  x{s.count_per_layer} "
              f"in {s.n_layers(cfg)} layers")

    print("\nCGRA mapping (per-site bank-capacity-feasible tiles, "
          "output-stationary):")
    t0 = time.time()
    reports = analyze_arch_gemms(arch_id, tokens=tokens,
                                 toolchain=toolchain)
    dt = time.time() - t0
    print(f"{'site':<14} {'tile':>8} {'II':>3} {'MII':>4} {'util':>7} "
          f"{'tile_us':>8} {'tiles':>7} {'xinst':>6} {'site_ms':>10}")
    for r in reports:
        tile = "x".join(str(t) for t in r.tile)
        print(f"{r.site:<14} {tile:>8} {r.II:>3} {r.mii:>4} "
              f"{r.utilization*100:6.1f}% {r.est_tile_us:8.1f} "
              f"{r.tiles:>7} {r.instances:>6} {r.est_site_ms:10.3f}")
    print(f"# analyzed in {dt*1e3:.0f} ms (compiles are cache hits after "
          f"the first)")


def emit_streams(arch_id: str, tokens: int, out_dir: str,
                 toolchain: Toolchain) -> None:
    """Export every distinct compiled tile of the model's GEMM sites as a
    deployable instruction-stream family (``repro_torch.isa``) — the
    artifacts a CGRA control memory actually consumes.  Tiles shared
    across sites (the common case) export once; compiles are warm-cache
    hits after the analysis pass."""
    cfg = get_config(arch_id)
    arch = toolchain.arch or cluster_4x4()
    done = set()
    for s in model_gemm_sites(cfg, tokens):
        tile = choose_gemm_tile(arch, s)
        if tile in done:
            continue
        done.add(tile)
        try:
            ck = analyze_gemm_tile(*tile, arch=arch, toolchain=toolchain)
        except MapError:
            continue
        dest = os.path.join(out_dir, arch_id,
                            "gemm_" + "x".join(str(t) for t in tile))
        paths = toolchain.export_streams(ck, dest)
        print(f"  emitted {ck.name} (II={ck.II}) -> {dest} "
              f"({len(paths)} files)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--all", action="store_true",
                    help="sweep every model in the zoo (one shared cache)")
    ap.add_argument("--arch-file", default=None, metavar="ADL_JSON",
                    help="user-defined CGRA architecture (ADL JSON, "
                         "as written by CGRAArch.to_json)")
    ap.add_argument("--emit-streams", default=None, metavar="DIR",
                    help="export each distinct compiled tile as per-PE "
                         "instruction streams (instructions.csv / "
                         "kernel.asm / stream_manifest.json) under "
                         "DIR/<model>/<tile>/")
    args = ap.parse_args()

    cgra = load_arch_file(args.arch_file) if args.arch_file else None
    if cgra is not None:
        print(f"target CGRA (from {args.arch_file}): {cgra.name}, "
              f"{cgra.rows}x{cgra.cols} PEs, {len(cgra.banks)} banks, "
              f"{cgra.datapath_bits}-bit datapath")

    # one Toolchain for the whole sweep: the tile compile happens once
    toolchain = Toolchain(arch=cgra, options=MapperOptions())
    for arch_id in (ARCH_IDS if args.all else [args.arch]):
        report_arch(arch_id, args.tokens, toolchain)
        if args.emit_streams:
            print(f"\ninstruction streams ({args.emit_streams}):")
            emit_streams(arch_id, args.tokens, args.emit_streams, toolchain)
        if args.all:
            print()


if __name__ == "__main__":
    main()
