"""Per-PE instruction-stream exporter: SimConfig -> deployment artifacts.

The Morpher ecosystem's RTL flows consume per-PE control streams (the
ESL-CGRA ``instructions.csv`` / assembly artifact family), not an
in-process numpy struct.  This module lowers a :class:`SimConfig` to that
shape: one record per (II slot, PE) carrying the FU opcode mnemonic, the
three operand mux selects, the four crossbar and RF writeback selects, the
immediate, the operand force window (loop-carried prologue preloads), the
memory bank binding and the store-validity start — everything a control
memory needs, nothing the simulator privately caches.

Three files per kernel, all byte-deterministic (fixed column order, fixed
integer formatting, ``\\n`` line endings, trailing newline):

  ``instructions.csv``       canonical machine-readable stream (sorted
                             columns, rows sorted by (slot, pe))
  ``kernel.asm``             human-readable disassembly of the same stream
  ``stream_manifest.json``   self-describing envelope: II/P/RF/LI/bits,
                             depth, bank offsets, live-in register
                             assignments, the neighbour table, the CSV
                             column list, ARTIFACT_VERSION

Opcode and mux-select spellings come from the bidirectional mnemonic
tables in ``core.config_gen`` (``MNEMONIC`` / ``KIND_MNEMONIC``) — the
single source of truth shared with the simulator and the standalone
interpreter (``repro_torch.isa.interp``), so the three can never drift.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..core.config_gen import (INDEXED_KINDS, KIND_MNEMONIC, KIND_NONE,
                               MNEMONIC, OPC_NONE, OPC_STORE, SimConfig)

# version of the stream *format* itself (column set, mnemonic spellings,
# manifest schema) — distinct from the toolchain ARTIFACT_VERSION, which
# tracks the CompiledKernel artifact family
STREAM_FORMAT = 1

CSV_NAME = "instructions.csv"
ASM_NAME = "kernel.asm"
MANIFEST_NAME = "stream_manifest.json"

# direction order of the xo_* columns and the manifest neighbour table
DIRS = ("n", "e", "s", "w")


def _artifact_version() -> int:
    from ..core.toolchain import ARTIFACT_VERSION
    return ARTIFACT_VERSION


def _sel(kind: int, idx: int) -> str:
    """One mux select as its CSV spelling: bare mnemonic, or mnemonic+index
    for the register-file / live-in-register kinds ("reg3", "li0")."""
    m = KIND_MNEMONIC[int(kind)]
    return f"{m}{int(idx)}" if kind in INDEXED_KINDS else m


def columns(cfg: SimConfig) -> List[str]:
    """The canonical CSV column list for this configuration: the fixed
    scalar columns plus one writeback column per RF register, sorted
    lexicographically (the byte-determinism contract's column order)."""
    cols = ["slot", "pe", "opcode", "imm",
            "mem_off", "mem_words", "tstart"]
    for o in range(3):
        cols += [f"op{o}", f"op{o}_fb", f"op{o}_fv"]
    cols += [f"xo_{d}" for d in DIRS]
    cols += [f"rf{r}" for r in range(cfg.RF)]
    return sorted(cols)


def encode_rows(cfg: SimConfig) -> Tuple[List[str], List[Dict[str, str]]]:
    """Lower every (slot, pe) configuration cell to its CSV record.

    Returns (header, rows); rows are sorted by (slot, pe) and every value
    is already a string in its canonical spelling.
    """
    header = columns(cfg)
    op = np.asarray(cfg.op)
    rows: List[Dict[str, str]] = []
    for slot in range(cfg.II):
        for pe in range(cfg.P):
            rec = {
                "slot": str(slot), "pe": str(pe),
                "opcode": MNEMONIC[int(op[slot, pe])],
                "imm": str(int(cfg.imm[slot, pe])),
                "mem_off": str(int(cfg.mem_off[slot, pe])),
                "mem_words": str(int(cfg.mem_words[slot, pe])),
                "tstart": str(int(cfg.valid_start[slot, pe])),
            }
            for o in range(3):
                rec[f"op{o}"] = _sel(cfg.src_kind[slot, pe, o],
                                     cfg.src_idx[slot, pe, o])
                rec[f"op{o}_fb"] = str(int(cfg.force_before[slot, pe, o]))
                rec[f"op{o}_fv"] = str(int(cfg.force_val[slot, pe, o]))
            for d, dn in enumerate(DIRS):
                rec[f"xo_{dn}"] = _sel(cfg.xo_kind[slot, pe, d],
                                       cfg.xo_idx[slot, pe, d])
            for r in range(cfg.RF):
                rec[f"rf{r}"] = _sel(cfg.rf_kind[slot, pe, r],
                                     cfg.rf_idx[slot, pe, r])
            rows.append(rec)
    return header, rows


def to_csv(cfg: SimConfig) -> str:
    """The canonical ``instructions.csv`` text (byte-deterministic)."""
    header, rows = encode_rows(cfg)
    lines = [",".join(header)]
    lines += [",".join(rec[c] for c in header) for rec in rows]
    return "\n".join(lines) + "\n"


def manifest_dict(cfg: SimConfig, name: str) -> dict:
    """The self-describing stream envelope: everything the standalone
    interpreter needs beyond the CSV itself."""
    neighbors = [[int(cfg.nbr_idx[p, d]) if bool(cfg.nbr_ok[p, d]) else None
                  for d in range(4)] for p in range(cfg.P)]
    return {
        "artifact_version": _artifact_version(),
        "stream_format": STREAM_FORMAT,
        "kernel": name,
        "II": cfg.II, "P": cfg.P, "RF": cfg.RF, "LI": cfg.LI,
        "bits": cfg.bits, "depth": cfg.depth,
        "total_words": cfg.total_words,
        "bank_offsets": {str(bid): off
                         for bid, off in cfg.bank_offsets.items()},
        "liveins": {n: list(pe_idx)
                    for n, pe_idx in cfg.lireg_assign.items()},
        "dirs": list(DIRS),
        "neighbors": neighbors,
        "columns": columns(cfg),
    }


def to_manifest_json(cfg: SimConfig, name: str) -> str:
    return json.dumps(manifest_dict(cfg, name), sort_keys=True,
                      separators=(",", ":")) + "\n"


def _asm_cell(cfg: SimConfig, slot: int, pe: int) -> str:
    """One PE's instruction at one slot, disassembled; '' when idle."""
    opc = int(cfg.op[slot, pe])
    parts: List[str] = []
    ops = []
    for o in range(3):
        k, i = int(cfg.src_kind[slot, pe, o]), int(cfg.src_idx[slot, pe, o])
        if k == KIND_NONE:
            continue
        s = f"op{o}={_sel(k, i)}"
        if KIND_MNEMONIC[k] == "imm":
            s += f"({int(cfg.imm[slot, pe])})"
        fb = int(cfg.force_before[slot, pe, o])
        if fb > 0:
            s += f"{{t<{fb}:{int(cfg.force_val[slot, pe, o])}}}"
        ops.append(s)
    if opc != OPC_NONE or ops:
        line = f"{MNEMONIC[opc]:<7s}" + " ".join(ops)
        if int(cfg.mem_words[slot, pe]) > 1:
            line += (f" @mem(off={int(cfg.mem_off[slot, pe])},"
                     f"words={int(cfg.mem_words[slot, pe])})")
        if opc == OPC_STORE:
            line += f" valid>={int(cfg.valid_start[slot, pe])}"
        parts.append(line)
    wb = []
    for d, dn in enumerate(DIRS):
        k = int(cfg.xo_kind[slot, pe, d])
        if k != KIND_NONE:
            wb.append(f"xo_{dn}<-{_sel(k, int(cfg.xo_idx[slot, pe, d]))}")
    for r in range(cfg.RF):
        k = int(cfg.rf_kind[slot, pe, r])
        if k != KIND_NONE:
            wb.append(f"rf{r}<-{_sel(k, int(cfg.rf_idx[slot, pe, r]))}")
    if wb:
        parts.append("; " + " ".join(wb))
    return " ".join(parts)


def to_asm(cfg: SimConfig, name: str) -> str:
    """Readable disassembly of the stream (idle PEs omitted per slot)."""
    out = [f"; {name}: per-PE instruction streams",
           f"; II={cfg.II} P={cfg.P} RF={cfg.RF} LI={cfg.LI} "
           f"bits={cfg.bits} depth={cfg.depth} "
           f"total_words={cfg.total_words}",
           f"; artifact_version={_artifact_version()} "
           f"stream_format={STREAM_FORMAT}"]
    for n, (pe, idx) in sorted(cfg.lireg_assign.items()):
        out.append(f"; livein {n} -> pe{pe} li{idx}")
    for slot in range(cfg.II):
        out.append(f"slot {slot}:")
        for pe in range(cfg.P):
            cell = _asm_cell(cfg, slot, pe)
            if cell:
                out.append(f"  pe{pe:<3d} {cell}")
    return "\n".join(out) + "\n"


def encode_kernel(ck) -> Dict[str, str]:
    """All three stream artifacts of a :class:`CompiledKernel` as text,
    keyed by their canonical filenames."""
    return {CSV_NAME: to_csv(ck.cfg),
            ASM_NAME: to_asm(ck.cfg, ck.name),
            MANIFEST_NAME: to_manifest_json(ck.cfg, ck.name)}


def export_streams(ck, out_dir: str) -> Dict[str, str]:
    """Write the stream artifact family for one compiled kernel.

    Creates ``out_dir`` and writes ``instructions.csv``, ``kernel.asm``
    and ``stream_manifest.json`` (newline-exact, so ``cmp`` across two
    cold exports is the determinism check).  Returns filename -> path.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths: Dict[str, str] = {}
    for fn, text in encode_kernel(ck).items():
        path = os.path.join(out_dir, fn)
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            f.write(text)
        paths[fn] = path
    return paths
