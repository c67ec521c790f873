"""Config/timing legality: audit a :class:`~repro_torch.core.config_gen.SimConfig`
against its :class:`~repro_torch.core.adl.CGRAArch` without simulating it.

Everything here is decidable from the configuration planes and the
architecture tables alone:

* shapes and scalar parameters agree with the ADL (``CFG-SHAPE``),
* every opcode and mux select is representable on the fabric
  (``CFG-OPC-RANGE`` / ``CFG-MUX-RANGE`` / ``CFG-NBR``),
* the register file is written within its port budget (``CFG-RF-WPORTS``),
* the 2-cycle load pipeline never clobbers a same-PE ALU result
  (``CFG-LOAD-HAZARD``),
* validity windows sit on their II slot inside the schedule depth
  (``CFG-STORE-WINDOW``),
* memory bindings name real banks, on the bank's bus, one access per bank
  per slot (``CFG-BANK-RANGE`` / ``CFG-BANK-PORT``),
* live-in reads hit host-initialized registers (``CFG-LIVEIN``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.adl import CGRAArch, DIRS
from ..core.config_gen import (
    INDEXED_KINDS, KIND_IN_N, KIND_IN_W, KIND_LIREG, KIND_MNEMONIC,
    KIND_NONE, KIND_REG, MNEMONIC, OPC_LOAD, OPC_NONE, OPC_STORE, SimConfig,
)

from .diagnostics import Diagnostic, ERROR, cell_locus, sort_diagnostics

# opcodes whose result lands in the FU output register at t+1 (everything
# except nop, load — which lands at t+2 via the load pipeline — and store)
_RESULT_OPCS = frozenset(c for c in MNEMONIC
                         if c not in (OPC_NONE, OPC_LOAD, OPC_STORE))


def _declared_banks(arch: CGRAArch) -> Dict[int, Tuple[int, int]]:
    """bank id -> (global word offset, words), in declaration order — the
    exact layout ``generate_config`` materializes."""
    out: Dict[int, Tuple[int, int]] = {}
    off = 0
    for b in arch.banks:
        out[b.id] = (off, b.words)
        off += b.words
    return out


def check_config(cfg: SimConfig, arch: CGRAArch) -> List[Diagnostic]:
    """Audit config/timing legality; returns sorted diagnostics."""
    diags: List[Diagnostic] = []

    def err(rule: str, locus: str, message: str):
        diags.append(Diagnostic(rule, ERROR, locus, message))

    II, P, RF, LI = cfg.II, cfg.P, cfg.RF, cfg.LI

    # ------------------------------------------------------------ CFG-SHAPE
    banks = _declared_banks(arch)
    exp_total = sum(w for _off, w in banks.values()) + 1
    shape_problems = []
    if P != arch.n_pes:
        shape_problems.append(f"P={P} but the arch has {arch.n_pes} PEs")
    if RF != arch.regfile_size:
        shape_problems.append(f"RF={RF} != regfile_size {arch.regfile_size}")
    if LI != max(1, arch.livein_regs):
        shape_problems.append(
            f"LI={LI} != livein_regs {max(1, arch.livein_regs)}")
    if cfg.bits != arch.datapath_bits:
        shape_problems.append(
            f"bits={cfg.bits} != datapath_bits {arch.datapath_bits}")
    if II < 1 or cfg.depth < 2:
        shape_problems.append(f"degenerate II={II} / depth={cfg.depth}")
    if dict(cfg.bank_offsets) != {b: off for b, (off, _w) in banks.items()}:
        shape_problems.append(
            f"bank_offsets {dict(cfg.bank_offsets)} disagree with the "
            f"declared layout {{id: offset}} "
            f"{ {b: off for b, (off, _w) in banks.items()} }")
    if cfg.total_words != exp_total:
        shape_problems.append(
            f"total_words={cfg.total_words} != declared {exp_total} "
            f"(banks + scratch)")
    expected_shapes = {
        "op": (II, P), "imm": (II, P), "src_kind": (II, P, 3),
        "src_idx": (II, P, 3), "force_before": (II, P, 3),
        "force_val": (II, P, 3), "xo_kind": (II, P, 4), "xo_idx": (II, P, 4),
        "rf_kind": (II, P, RF), "rf_idx": (II, P, RF), "mem_off": (II, P),
        "mem_words": (II, P), "valid_start": (II, P), "nbr_idx": (P, 4),
        "nbr_ok": (P, 4),
    }
    for name, shape in expected_shapes.items():
        plane = getattr(cfg, name)
        if tuple(plane.shape) != shape:
            shape_problems.append(
                f"{name} plane has shape {tuple(plane.shape)}, "
                f"expected {shape}")
    if shape_problems:
        for p in shape_problems:
            err("CFG-SHAPE", "config", p)
        # planes cannot be trusted past a shape mismatch
        return sort_diagnostics(diags)

    # -------------------------------------------------------------- CFG-NBR
    for pe in range(P):
        for di, d in enumerate(DIRS):
            q = arch.neighbor(pe, d)
            ok = bool(cfg.nbr_ok[pe, di])
            idx = int(cfg.nbr_idx[pe, di])
            if ok != (q is not None) or (q is not None and idx != q) \
                    or (q is None and idx != 0):
                err("CFG-NBR", f"pe{pe}",
                    f"neighbour table entry {d}=({idx}, ok={ok}) disagrees "
                    f"with the topology ({q})")

    lireg_cells = {}
    for name in sorted(cfg.lireg_assign):
        pe, idx = cfg.lireg_assign[name]
        if not (0 <= pe < P) or not (0 <= idx < LI):
            err("CFG-LIVEIN", f"livein({name})",
                f"assignment (pe{pe}, li{idx}) outside the fabric's "
                f"{LI} live-in registers")
            continue
        prev = lireg_cells.setdefault((pe, idx), name)
        if prev != name:
            err("CFG-LIVEIN", f"pe{pe}/li{idx}",
                f"live-in register double-booked by {prev!r} and {name!r}")
    assigned = set(lireg_cells)

    def check_sel(slot: int, pe: int, what: str, kind: int, idx: int):
        locus = cell_locus(slot, pe)
        if kind not in KIND_MNEMONIC:
            err("CFG-MUX-RANGE", locus,
                f"{what} select kind {kind} is not a mux input")
            return
        if KIND_IN_N <= kind <= KIND_IN_W:
            di = kind - KIND_IN_N
            if not bool(cfg.nbr_ok[pe, di]):
                err("CFG-MUX-RANGE", locus,
                    f"{what} reads in_{DIRS[di].lower()} but pe{pe} has no "
                    f"{DIRS[di]} neighbour wire")
        if kind == KIND_REG and not (0 <= idx < RF):
            err("CFG-MUX-RANGE", locus,
                f"{what} reads reg{idx}, outside the {RF}-entry register "
                f"file")
        elif kind == KIND_LIREG:
            if not (0 <= idx < LI):
                err("CFG-MUX-RANGE", locus,
                    f"{what} reads li{idx}, outside the {LI} live-in "
                    f"registers")
            elif (pe, idx) not in assigned:
                err("CFG-LIVEIN", locus,
                    f"{what} reads li{idx} on pe{pe}, which no live-in "
                    f"initializes")
        elif kind not in INDEXED_KINDS and idx != 0:
            err("CFG-MUX-RANGE", locus,
                f"{what} select {KIND_MNEMONIC[kind]} carries stray "
                f"index {idx}")

    # per-cell scan: opcodes, selects, windows, memory, write ports
    load_cells = set()      # (slot, pe) holding a LOAD
    result_cells = {}       # (slot, pe) -> opcode producing an FU result
    mem_cells = []          # (slot, pe, opc)
    for slot in range(II):
        for pe in range(P):
            locus = cell_locus(slot, pe)
            opc = int(cfg.op[slot, pe])
            if opc not in MNEMONIC:
                err("CFG-OPC-RANGE", locus,
                    f"opcode {opc} is outside the opcode table")
                opc = OPC_NONE
            if opc == OPC_LOAD:
                load_cells.add((slot, pe))
            if opc in _RESULT_OPCS:
                result_cells[(slot, pe)] = opc
            if opc in (OPC_LOAD, OPC_STORE):
                mem_cells.append((slot, pe, opc))
            # validity window: an active cell fires at valid_start,
            # valid_start + II, ... so its residue must be this slot and
            # the first firing must sit inside the schedule depth
            vs = int(cfg.valid_start[slot, pe])
            if opc != OPC_NONE:
                if vs < 0 or vs > cfg.depth - 2 or vs % II != slot:
                    err("CFG-STORE-WINDOW", locus,
                        f"{MNEMONIC[opc]} window starts at t{vs}, which is "
                        f"not on slot {slot} within depth {cfg.depth}")
            elif vs != 0:
                err("CFG-STORE-WINDOW", locus,
                    f"inactive cell carries stray window start t{vs}")
            # operand / crossbar / RF selects
            for o in range(3):
                check_sel(slot, pe, f"operand {o}",
                          int(cfg.src_kind[slot, pe, o]),
                          int(cfg.src_idx[slot, pe, o]))
            for di in range(4):
                check_sel(slot, pe, f"xo_{DIRS[di].lower()}",
                          int(cfg.xo_kind[slot, pe, di]),
                          int(cfg.xo_idx[slot, pe, di]))
            writes = 0
            for r in range(RF):
                k = int(cfg.rf_kind[slot, pe, r])
                if k != KIND_NONE:
                    writes += 1
                check_sel(slot, pe, f"rf{r}", k, int(cfg.rf_idx[slot, pe, r]))
            if writes > arch.rf_write_ports:
                err("CFG-RF-WPORTS", locus,
                    f"{writes} register-file writes exceed "
                    f"{arch.rf_write_ports} write ports")
            # memory binding
            moff = int(cfg.mem_off[slot, pe])
            mwords = int(cfg.mem_words[slot, pe])
            if opc in (OPC_LOAD, OPC_STORE):
                match = [b for b, (off, w) in banks.items()
                         if (off, w) == (moff, mwords)]
                if not match:
                    err("CFG-BANK-RANGE", locus,
                        f"{MNEMONIC[opc]} binding (off={moff}, "
                        f"words={mwords}) matches no declared bank")
                elif pe not in arch.bank(match[0]).pes:
                    err("CFG-BANK-RANGE", locus,
                        f"pe{pe} is not on bank{match[0]}'s shared bus")
            elif (moff, mwords) != (0, 1):
                err("CFG-BANK-RANGE", locus,
                    f"non-memory cell carries stray binding (off={moff}, "
                    f"words={mwords})")

    # ------------------------------------------------------- CFG-BANK-PORT
    off_to_bank = {off: b for b, (off, _w) in banks.items()}
    port: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for slot, pe, _opc in mem_cells:
        b = off_to_bank.get(int(cfg.mem_off[slot, pe]))
        if b is not None:
            port.setdefault((b, slot), []).append((slot, pe))
    for (b, slot), cells in sorted(port.items()):
        if len(cells) > 1:
            err("CFG-BANK-PORT", f"slot{slot}/bank{b}",
                f"{len(cells)} memory ops share bank{b}'s port: "
                f"{[f'pe{pe}' for _s, pe in cells]}")

    # ------------------------------------------------------ CFG-LOAD-HAZARD
    # a load issued at slot s owns the FU output register at (s+2); a
    # 1-cycle result issued at slot s+1 lands there the same cycle and is
    # silently discarded by the load pipeline (simulator: completing loads
    # win).  With II == 1 the pattern is inexpressible (s+1 is s itself).
    if II > 1:
        for (slot, pe) in sorted(load_cells):
            nxt = ((slot + 1) % II, pe)
            if nxt in result_cells:
                err("CFG-LOAD-HAZARD", cell_locus(nxt[0], pe),
                    f"{MNEMONIC[result_cells[nxt]]} result is clobbered by "
                    f"the load completing from slot {slot}")

    return sort_diagnostics(diags)
