"""Roofline table driver (PyTorch port of ``repro.roofline.run``): per
(arch x shape) cell on the single-pod mesh, compute the three roofline
terms via the L=1/L=2 two-point fit (see analysis.py) and merge with the
dry-run memory records.

    python -m repro_torch.roofline.run [--cells arch:shape ...]
                                       [--out roofline.json]
"""
import argparse
import json
import sys
import time
import traceback

from ..configs.registry import ARCH_IDS, SHAPES
from ..launch.mesh import make_production_mesh, release
from .analysis import SUGGESTIONS, analyze_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="*", default=None,
                    help="arch:shape pairs; default = all 40")
    ap.add_argument("--dryrun-json", default="dryrun_singlepod.json")
    ap.add_argument("--out", default="roofline.json")
    ap.add_argument("--device", default=None,
                    help="device type the fake mesh traces (default: the "
                    "CUDA card)")
    args = ap.parse_args(argv)

    full = {}
    try:
        with open(args.dryrun_json) as f:
            for rec in json.load(f):
                full[(rec["arch"], rec["shape"])] = rec
    except FileNotFoundError:
        pass

    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells]
    else:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]

    mesh = make_production_mesh(multi_pod=False, device=args.device)
    out = []
    try:
        for arch, shape in cells:
            t0 = time.time()
            try:
                rec = analyze_cell(arch, shape, mesh,
                                   full.get((arch, shape)))
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}"}
                traceback.print_exc()
            rec["elapsed_s"] = round(time.time() - t0, 1)
            if rec.get("status") == "ok":
                rec["suggestion"] = SUGGESTIONS[rec["dominant"]]
            out.append(rec)
            print(json.dumps({k: v for k, v in rec.items()
                              if k != "suggestion"}), flush=True)
    finally:
        release()

    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)

    # markdown summary
    ok = [r for r in out if r.get("status") == "ok"]
    print("\n| arch | shape | compute s | memory s | collective s | "
          "dominant | MODEL/HLO flops | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    for r in sorted(ok, key=lambda r: r["roofline_fraction"]):
        print(f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4g} | "
              f"{r['memory_s']:.4g} | {r['collective_s']:.4g} | "
              f"{r['dominant']} | {r['model_vs_hlo_flops']:.3f} | "
              f"{r['roofline_fraction']:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
