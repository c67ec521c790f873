"""Stream legality: audit the exported ``instructions.csv`` / manifest
pair from the raw text alone.

This is a deliberately independent re-derivation of the config checker's
facts from the CSV mnemonics — it shares the mnemonic *tables* with
``core.config_gen`` (the single source of truth for spellings) but not
the :class:`SimConfig` planes, the encoder, or the interpreter's parsed
``Insn`` form, so it doubles as a structural auditor of ``isa.encode``:
a bug that makes the encoder emit an illegal stream fires here even when
the in-memory config was legal.

Bank extents are reconstructed the way a deployment target would: sort
the manifest's declared word offsets; each bank spans from its offset to
the next (the last bank ends at ``total_words - 1``, the trailing
scratch word).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..core.config_gen import (KIND_BY_MNEMONIC, KIND_LIREG, KIND_NONE,
                               KIND_REG, OPC_BY_MNEMONIC, OPC_LOAD,
                               OPC_NONE, OPC_STORE)
from ..isa.encode import DIRS, STREAM_FORMAT

from .diagnostics import Diagnostic, ERROR, cell_locus, sort_diagnostics

_SEL_RE = re.compile(r"^([a-z_]+?)(\d*)$")

_IN_KINDS = {f"in_{d}": di for di, d in enumerate(DIRS)}

# mnemonics whose result lands in the FU output register one cycle after
# issue (everything except nop, load and store)
_RESULT_MNEMONICS = frozenset(
    m for m, c in OPC_BY_MNEMONIC.items()
    if c not in (OPC_NONE, OPC_LOAD, OPC_STORE))

_MANIFEST_KEYS = ("stream_format", "II", "P", "RF", "LI", "depth",
                  "total_words", "bank_offsets", "liveins", "neighbors",
                  "columns")


def _bank_extents(manifest: dict) -> Dict[int, int]:
    """word offset -> words, reconstructed from the manifest's declared
    offsets and total_words (scratch word excluded)."""
    offs = sorted(int(off) for off in manifest["bank_offsets"].values())
    end = int(manifest["total_words"]) - 1
    extents: Dict[int, int] = {}
    for i, off in enumerate(offs):
        nxt = offs[i + 1] if i + 1 < len(offs) else end
        extents[off] = nxt - off
    return extents


def check_stream(csv_text: str, manifest: dict, *,
                 rf_write_ports: Optional[int] = None) -> List[Diagnostic]:
    """Audit a CSV/manifest pair; returns sorted diagnostics.

    ``rf_write_ports`` is optional because the manifest does not carry it;
    pass the architecture's value to enable the ``STR-RF-WPORTS`` rule.
    """
    diags: List[Diagnostic] = []

    def err(rule: str, locus: str, message: str):
        diags.append(Diagnostic(rule, ERROR, locus, message))

    missing = [k for k in _MANIFEST_KEYS if k not in manifest]
    if missing:
        err("STR-PARSE", "manifest", f"manifest lacks keys {missing}")
        return sort_diagnostics(diags)
    if manifest["stream_format"] != STREAM_FORMAT:
        err("STR-PARSE", "manifest",
            f"stream_format {manifest['stream_format']} != supported "
            f"{STREAM_FORMAT}")
        return sort_diagnostics(diags)

    II, P, RF, LI = (int(manifest[k]) for k in ("II", "P", "RF", "LI"))
    depth = int(manifest["depth"])
    neighbors = manifest["neighbors"]
    liveins = {(int(pe), int(idx))
               for pe, idx in manifest["liveins"].values()}

    lines = csv_text.splitlines()
    if not lines:
        err("STR-PARSE", "stream", "empty CSV")
        return sort_diagnostics(diags)
    header = lines[0].split(",")
    if header != list(manifest["columns"]):
        err("STR-PARSE", "stream",
            "CSV header does not match the manifest column list")
        return sort_diagnostics(diags)
    records = [ln.split(",") for ln in lines[1:] if ln]
    if len(records) != II * P:
        err("STR-PARSE", "stream",
            f"{len(records)} records for an II={II} x P={P} stream "
            f"(expected {II * P}; truncated or padded)")
        return sort_diagnostics(diags)

    col = {c: i for i, c in enumerate(header)}

    def field(rec: List[str], name: str) -> str:
        return rec[col[name]]

    def int_field(rec: List[str], name: str, locus: str) -> Optional[int]:
        v = field(rec, name)
        try:
            return int(v)
        except ValueError:
            err("STR-PARSE", locus, f"column {name} is not an integer: {v!r}")
            return None

    extents = _bank_extents(manifest)
    seen: Dict[Tuple[int, int], bool] = {}
    load_cells = set()
    result_cells: Dict[Tuple[int, int], str] = {}
    bank_port: Dict[Tuple[int, int], List[int]] = {}

    def check_sel(locus: str, pe: int, what: str, text: str):
        m = _SEL_RE.match(text)
        if not m or m.group(1) not in KIND_BY_MNEMONIC:
            err("STR-SEL-RANGE", locus, f"{what} select unparseable: {text!r}")
            return
        mnem, idx_s = m.group(1), m.group(2)
        kind = KIND_BY_MNEMONIC[mnem]
        if kind in (KIND_REG, KIND_LIREG):
            if not idx_s:
                err("STR-SEL-RANGE", locus,
                    f"{what} select {mnem!r} needs an index")
                return
            idx = int(idx_s)
            bound = RF if kind == KIND_REG else LI
            if not (0 <= idx < bound):
                err("STR-SEL-RANGE", locus,
                    f"{what} reads {text}, outside the {bound}-entry "
                    f"{'register file' if kind == KIND_REG else 'live-in registers'}")
            elif kind == KIND_LIREG and (pe, idx) not in liveins:
                err("STR-LIVEIN", locus,
                    f"{what} reads {text} on pe{pe}, which the manifest "
                    f"never initializes")
        else:
            if idx_s:
                err("STR-SEL-RANGE", locus,
                    f"{what} select {text!r} carries a stray index")
            elif mnem in _IN_KINDS and kind != KIND_NONE:
                di = _IN_KINDS[mnem]
                if neighbors[pe][di] is None:
                    err("STR-SEL-RANGE", locus,
                        f"{what} reads {mnem} but pe{pe} has no "
                        f"{DIRS[di]} neighbour wire")

    for rec in records:
        if len(rec) != len(header):
            err("STR-PARSE", "stream",
                f"record has {len(rec)} fields, header has {len(header)}")
            continue
        slot = int_field(rec, "slot", "stream")
        pe = int_field(rec, "pe", "stream")
        if slot is None or pe is None:
            continue
        locus = cell_locus(slot, pe)
        if not (0 <= slot < II and 0 <= pe < P):
            err("STR-PARSE", locus, "record outside the (II, P) grid")
            continue
        if (slot, pe) in seen:
            err("STR-PARSE", locus, "duplicate record")
            continue
        seen[(slot, pe)] = True

        opcode = field(rec, "opcode")
        if opcode not in OPC_BY_MNEMONIC:
            err("STR-OPC", locus, f"unknown opcode mnemonic {opcode!r}")
            opcode = "nop"
        if opcode == "load":
            load_cells.add((slot, pe))
        if opcode in _RESULT_MNEMONICS:
            result_cells[(slot, pe)] = opcode

        tstart = int_field(rec, "tstart", locus)
        if tstart is not None:
            if opcode != "nop":
                if tstart < 0 or tstart > depth - 2 or tstart % II != slot:
                    err("STR-STORE-WINDOW", locus,
                        f"{opcode} window starts at t{tstart}, which is not "
                        f"on slot {slot} within depth {depth}")
            elif tstart != 0:
                err("STR-STORE-WINDOW", locus,
                    f"nop record carries stray window start t{tstart}")

        moff = int_field(rec, "mem_off", locus)
        mwords = int_field(rec, "mem_words", locus)
        if moff is not None and mwords is not None:
            if opcode in ("load", "store"):
                if extents.get(moff) != mwords:
                    err("STR-BANK-RANGE", locus,
                        f"{opcode} binding (off={moff}, words={mwords}) "
                        f"matches no bank derivable from the manifest")
                else:
                    bank_port.setdefault((moff, slot), []).append(pe)
            elif (moff, mwords) != (0, 1):
                err("STR-BANK-RANGE", locus,
                    f"non-memory record carries stray binding "
                    f"(off={moff}, words={mwords})")

        for o in range(3):
            check_sel(locus, pe, f"op{o}", field(rec, f"op{o}"))
            int_field(rec, f"op{o}_fb", locus)
            int_field(rec, f"op{o}_fv", locus)
        for d in DIRS:
            check_sel(locus, pe, f"xo_{d}", field(rec, f"xo_{d}"))
        writes = 0
        for r in range(RF):
            text = field(rec, f"rf{r}")
            if text != "none":
                writes += 1
            check_sel(locus, pe, f"rf{r}", text)
        if rf_write_ports is not None and writes > rf_write_ports:
            err("STR-RF-WPORTS", locus,
                f"{writes} register-file writebacks exceed "
                f"{rf_write_ports} write ports")
        int_field(rec, "imm", locus)

    if len(seen) != II * P:
        err("STR-PARSE", "stream",
            f"only {len(seen)} of {II * P} (slot, pe) cells are present")

    for (off, slot), pes in sorted(bank_port.items()):
        if len(pes) > 1:
            err("STR-BANK-PORT", f"slot{slot}/off{off}",
                f"{len(pes)} memory ops share the bank at word offset "
                f"{off}: {[f'pe{p}' for p in pes]}")

    if II > 1:
        for (slot, pe) in sorted(load_cells):
            nxt = ((slot + 1) % II, pe)
            if nxt in result_cells:
                err("STR-LOAD-HAZARD", cell_locus(nxt[0], pe),
                    f"{result_cells[nxt]} result is clobbered by the load "
                    f"completing from slot {slot}")

    return sort_diagnostics(diags)
