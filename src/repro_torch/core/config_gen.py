"""Configuration generation (paper Fig. 3 piece 6, adapted).

Morpher's architecture generator emits Verilog RTL plus per-PE control
memories; the artifact the control memories consume is the cycle-by-cycle
configuration.  This module generates exactly that artifact from a Mapping:
for each of the II slots and each PE — FU opcode, operand mux selects,
immediate, crossbar output selects, register-file write selects, memory
bank binding, and store-validity windows (the control-module iteration
counters that gate prologue/epilogue side effects).

The output `SimConfig` is a dense numpy struct-of-arrays, directly
consumed by the cycle-accurate simulator and serializable to JSON for
inspection (the "mapping configuration file" of the paper).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .adl import CGRAArch, DIRS, OPP, DIR_IDX
from .dfg import DFG, Op, wrap
from .layout import DataLayout
from .mapper import Mapping
from .mrrg import F, R

# operand-source mux kinds
KIND_NONE, KIND_IN_N, KIND_IN_E, KIND_IN_S, KIND_IN_W = 0, 1, 2, 3, 4
KIND_REG, KIND_FUOUT, KIND_IMM, KIND_LIREG = 5, 6, 7, 8
KIND_IN = {d: 1 + DIR_IDX[d] for d in DIRS}

# simulator opcodes
OPC = {None: 0, "pass": 1, Op.ADD: 2, Op.SUB: 3, Op.MUL: 4, Op.SHL: 5,
       Op.SHR: 6, Op.AND: 7, Op.OR: 8, Op.XOR: 9, Op.CMPGE: 10,
       Op.CMPEQ: 11, Op.CMPLT: 12, Op.SELECT: 13, Op.LOAD: 14, Op.STORE: 15}
OPC_NONE, OPC_PASS = 0, 1
OPC_LOAD, OPC_STORE = OPC[Op.LOAD], OPC[Op.STORE]

# bidirectional opcode <-> mnemonic map shared by the simulator, the
# instruction-stream exporter (repro_torch.isa.encode) and the standalone
# interpreter (repro_torch.isa.interp), so the three can never drift: the
# exporter writes MNEMONIC[code] into instructions.csv and the
# interpreter dispatches on those names
MNEMONIC = {code: ("nop" if key is None
                   else key if isinstance(key, str) else key.value)
            for key, code in OPC.items()}
OPC_BY_MNEMONIC = {m: c for c, m in MNEMONIC.items()}


def opcode_of(op: Optional[Op]) -> int:
    """FU opcode for a DFG node op.  CONST and LIVEIN lower to PASS (the
    value enters through the imm / live-in-register operand mux, not the
    ALU); every other op must have an explicit encoding — raising here is
    what keeps a newly added ``Op`` member from dying as a bare KeyError
    deep inside config generation."""
    if op in (Op.CONST, Op.LIVEIN):
        return OPC_PASS
    try:
        return OPC[op]
    except KeyError:
        raise NotImplementedError(
            f"op {op!r} has no simulator opcode encoding — add it to "
            f"config_gen.OPC") from None


# operand/writeback mux-kind <-> mnemonic map (same drift-proofing as
# MNEMONIC).  KIND_REG and KIND_LIREG selects carry an index; the CSV
# spelling is mnemonic+index ("reg3", "li0"), the rest are bare.
KIND_MNEMONIC = {KIND_NONE: "none", KIND_IN_N: "in_n", KIND_IN_E: "in_e",
                 KIND_IN_S: "in_s", KIND_IN_W: "in_w", KIND_REG: "reg",
                 KIND_FUOUT: "fu", KIND_IMM: "imm", KIND_LIREG: "li"}
KIND_BY_MNEMONIC = {m: k for k, m in KIND_MNEMONIC.items()}
INDEXED_KINDS = (KIND_REG, KIND_LIREG)


@dataclass
class SimConfig:
    II: int
    P: int
    RF: int
    LI: int
    bits: int
    op: np.ndarray            # [II,P]
    imm: np.ndarray           # [II,P]
    src_kind: np.ndarray      # [II,P,3]
    src_idx: np.ndarray       # [II,P,3]
    force_before: np.ndarray  # [II,P,3]  (operand := force_val while t < this)
    force_val: np.ndarray     # [II,P,3]
    xo_kind: np.ndarray       # [II,P,4]
    xo_idx: np.ndarray        # [II,P,4]
    rf_kind: np.ndarray       # [II,P,RF]
    rf_idx: np.ndarray        # [II,P,RF]
    mem_off: np.ndarray       # [II,P]  global word offset of the bank
    mem_words: np.ndarray     # [II,P]
    valid_start: np.ndarray   # [II,P]  absolute schedule time of the node
    nbr_idx: np.ndarray       # [P,4]   pe index of neighbour in DIRS order
    nbr_ok: np.ndarray        # [P,4]
    bank_offsets: Dict[int, int]  # bank id -> global word offset
    total_words: int          # incl. trailing scratch word
    depth: int
    lireg_assign: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    def livein_array(self, values: Dict[str, int]) -> np.ndarray:
        li = np.zeros((self.P, max(1, self.LI)), dtype=np.int32)
        for name, (pe, idx) in self.lireg_assign.items():
            li[pe, idx] = wrap(values.get(name, 0), self.bits)
        return li

    def n_cycles(self, n_iters: int) -> int:
        return (n_iters - 1) * self.II + self.depth

    def to_json(self) -> str:
        # underscore attributes are transient caches (e.g. the simulator's
        # device-resident plane copies), not part of the artifact.
        # Canonical form (sorted keys, compact separators): the same
        # byte-determinism contract as ServePlan.to_json, so artifacts
        # embedding a SimConfig are byte-stable across runs and machines.
        d = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in self.__dict__.items() if not k.startswith("_")}
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    _ARRAY_DTYPES = {
        "op": np.int32, "imm": np.int32, "src_kind": np.int32,
        "src_idx": np.int32, "force_before": np.int32, "force_val": np.int32,
        "xo_kind": np.int32, "xo_idx": np.int32, "rf_kind": np.int32,
        "rf_idx": np.int32, "mem_off": np.int32, "mem_words": np.int32,
        "valid_start": np.int32, "nbr_idx": np.int32, "nbr_ok": bool,
    }

    @staticmethod
    def from_json(s: str) -> "SimConfig":
        d = json.loads(s)
        for k, dt in SimConfig._ARRAY_DTYPES.items():
            d[k] = np.asarray(d[k], dtype=dt)
        d["lireg_assign"] = {name: tuple(v)
                             for name, v in d["lireg_assign"].items()}
        # JSON object keys are strings; bank ids are ints
        d["bank_offsets"] = {int(k): v
                             for k, v in d["bank_offsets"].items()}
        return SimConfig(**d)


# the configuration planes the simulator consumes, in a stable order (the
# 13 II-slot-indexed planes first, then the static neighbour table)
SIM_PLANES = ("op", "imm", "src_kind", "src_idx", "force_before",
              "force_val", "xo_kind", "xo_idx", "rf_kind", "rf_idx",
              "mem_off", "mem_words", "valid_start", "nbr_idx")


def _fit_dtype(a: np.ndarray) -> np.dtype:
    """Smallest of int8/int16/int32 that represents every value exactly."""
    if a.size:
        lo, hi = int(a.min()), int(a.max())
        for dt in (np.int8, np.int16):
            info = np.iinfo(dt)
            if info.min <= lo and hi <= info.max:
                return np.dtype(dt)
    else:
        return np.dtype(np.int8)
    return np.dtype(np.int32)


def narrowed_planes(cfg: SimConfig) -> Dict[str, np.ndarray]:
    """Per-plane dtype narrowing for the simulator's config streams.

    Mux kinds, opcodes and register indices are tiny enumerations and
    addresses/immediates are bounded by the bank sizes and the datapath
    width, so most planes fit int8/int16.  The simulator pre-tiles these
    planes into per-cycle scan streams; narrowing shrinks those streams
    (and the executable's constant footprint) by ~4x, letting the tiling
    cap admit proportionally longer simulations.  Narrowing is exact —
    a plane is only demoted when every value round-trips — and planes
    that feed arithmetic are re-widened inside the simulator body, so
    simulation results are bit-identical to the int32 planes.
    """
    return {k: (lambda a: a.astype(_fit_dtype(a)))(np.asarray(getattr(cfg, k)))
            for k in SIM_PLANES}


def plane_dtypes(cfg: SimConfig) -> Dict[str, str]:
    """The narrowed dtype chosen for each simulator plane (introspection;
    derived from ``narrowed_planes`` so the two can never disagree)."""
    return {k: str(v.dtype) for k, v in narrowed_planes(cfg).items()}


class ConfigConflict(RuntimeError):
    pass


def generate_config(mapping: Mapping, layout: DataLayout) -> SimConfig:
    arch, dfg, II = mapping.arch, mapping.dfg, mapping.II
    P, RF, LI = arch.n_pes, arch.regfile_size, max(1, arch.livein_regs)
    bits = arch.datapath_bits

    op = np.zeros((II, P), dtype=np.int32)
    imm = np.zeros((II, P), dtype=np.int32)
    src_kind = np.zeros((II, P, 3), dtype=np.int32)
    src_idx = np.zeros((II, P, 3), dtype=np.int32)
    force_before = np.zeros((II, P, 3), dtype=np.int32)
    force_val = np.zeros((II, P, 3), dtype=np.int32)
    xo_kind = np.zeros((II, P, 4), dtype=np.int32)
    xo_idx = np.zeros((II, P, 4), dtype=np.int32)
    rf_kind = np.zeros((II, P, RF), dtype=np.int32)
    rf_idx = np.zeros((II, P, RF), dtype=np.int32)
    mem_off = np.zeros((II, P), dtype=np.int32)
    mem_words = np.ones((II, P), dtype=np.int32)
    valid_start = np.zeros((II, P), dtype=np.int32)

    # global memory image: banks concatenated in declaration order, each
    # addressed by its declared id
    bank_offsets: Dict[int, int] = {}
    off = 0
    for b in arch.banks:
        bank_offsets[b.id] = off
        off += b.words
    total_words = off + 1  # + scratch word for masked stores
    scratch = total_words - 1

    # provenance of mux-config cells: cell -> (value, abs_t) for conflict check
    xo_owner: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
    rf_owner: Dict[Tuple[int, int, int], Tuple[int, int]] = {}

    def resolve(route, step_i: int) -> Tuple[int, int]:
        """(kind, idx) with which PE ``steps[step_i].pe`` reads the value at
        time steps[step_i].t."""
        kind, pe, t = route.steps[step_i]
        if kind == R:
            ridx = mapping.reg_assign.get((pe, route.value, t))
            if ridx is None:
                raise ConfigConflict(
                    f"slot{t % II}/pe{pe}: no register for value "
                    f"{route.value} at t{t} (rule MAP-REG-RANGE)")
            return KIND_REG, ridx
        # fresh: either straight off the producing FU, or an inbound wire
        if step_i == 0:
            return KIND_FUOUT, 0
        _pk, ppe, _pt = route.steps[step_i - 1]
        if ppe == pe:
            # F can only be entered from the source or a hop; same-PE
            # predecessor implies source state
            return KIND_FUOUT, 0
        for d in DIRS:
            if arch.neighbor(pe, d) == ppe:
                return KIND_IN[d], 0
        raise ConfigConflict(
            f"slot{t % II}/pe{pe}: inbound value {route.value} from pe{ppe}, "
            f"which is not adjacent (rule MAP-ROUTE-ADJ)")

    def set_xo(pe: int, d: int, slot: int, kind: int, idx: int,
               owner: Tuple[int, int]) -> None:
        cell = (pe, d, slot)
        if cell in xo_owner:
            if xo_owner[cell] == owner:
                return
            raise ConfigConflict(
                f"slot{slot}/pe{pe}: xo_{DIRS[d].lower()} crossbar port "
                f"double-driven, xo conflict at {cell} "
                f"(rule MAP-ROUTE-OVERLAP)")
        xo_owner[cell] = owner
        xo_kind[slot, pe, d] = kind
        xo_idx[slot, pe, d] = idx

    def set_rf(pe: int, r: int, slot: int, kind: int, idx: int,
               owner: Tuple[int, int]) -> None:
        cell = (pe, r, slot)
        if cell in rf_owner:
            if rf_owner[cell] == owner:
                return
            raise ConfigConflict(
                f"slot{slot}/pe{pe}: rf{r} writeback double-driven, rf "
                f"write conflict at {cell} (rule MAP-ROUTE-OVERLAP)")
        rf_owner[cell] = owner
        rf_kind[slot, pe, r] = kind
        rf_idx[slot, pe, r] = idx

    # ------------------------------------------------------------- FU slots
    for vid, (pe, t) in mapping.place.items():
        n = dfg.nodes[vid]
        slot = t % II
        valid_start[slot, pe] = t
        if n.op == Op.CONST:
            op[slot, pe] = OPC_PASS
            src_kind[slot, pe, 0] = KIND_IMM
            imm[slot, pe] = wrap(n.imm, bits)
        elif n.op == Op.LIVEIN:
            op[slot, pe] = OPC_PASS
            src_kind[slot, pe, 0] = KIND_LIREG
            src_idx[slot, pe, 0] = mapping.lireg_assign[n.livein][1]
        else:
            op[slot, pe] = opcode_of(n.op)
        if n.is_mem:
            b = mapping.bank_of[vid]
            mem_off[slot, pe] = bank_offsets[b]
            mem_words[slot, pe] = arch.bank(b).words

    # ------------------------------------------------- routes -> mux configs
    for (src, dst, oslot), route in mapping.routes.items():
        dnode = dfg.nodes[dst]
        dpe, dt = mapping.place[dst]
        dslot = dt % II
        # consumer operand select
        kind, idx = resolve(route, len(route.steps) - 1)
        cur_k = src_kind[dslot, dpe, oslot]
        if cur_k != KIND_NONE and (cur_k, src_idx[dslot, dpe, oslot]) != (kind, idx):
            raise ConfigConflict(
                f"slot{dslot}/pe{dpe}: operand mux conflict node {dst} "
                f"port {oslot} (rule MAP-ROUTE-OVERLAP)")
        src_kind[dslot, dpe, oslot] = kind
        src_idx[dslot, dpe, oslot] = idx
        # loop-carried init forcing (host-preloaded prologue values)
        opnd = dnode.operands[oslot]
        if opnd.dist > 0:
            force_before[dslot, dpe, oslot] = dt + opnd.dist * II
            force_val[dslot, dpe, oslot] = wrap(opnd.init, bits)
        # intermediate steps
        for i in range(len(route.steps) - 1):
            k0, p0, t0 = route.steps[i]
            k1, p1, t1 = route.steps[i + 1]
            owner = (route.value, t0)
            if p1 != p0:  # crossbar hop
                d = next(d for d in DIRS if arch.neighbor(p0, d) == p1)
                kk, ii_ = resolve(route, i)
                set_xo(p0, DIR_IDX[d], t0 % II, kk, ii_, owner)
            elif k1 == R and k0 == F:  # RF write
                ridx = mapping.reg_assign.get((p0, route.value, t1))
                if ridx is None:
                    raise ConfigConflict(
                        f"slot{t1 % II}/pe{p0}: no register for value "
                        f"{route.value} at t{t1} (rule MAP-REG-RANGE)")
                kk, ii_ = resolve(route, i)
                set_rf(p0, ridx, t0 % II, kk, ii_, owner)
            # R->R same pe: value stays put, no config needed

    nbr_idx = np.zeros((P, 4), dtype=np.int32)
    nbr_ok = np.zeros((P, 4), dtype=bool)
    for p in range(P):
        for di, d in enumerate(DIRS):
            q = arch.neighbor(p, d)
            nbr_idx[p, di] = q if q is not None else 0
            nbr_ok[p, di] = q is not None

    return SimConfig(
        II=II, P=P, RF=RF, LI=LI, bits=bits,
        op=op, imm=imm, src_kind=src_kind, src_idx=src_idx,
        force_before=force_before, force_val=force_val,
        xo_kind=xo_kind, xo_idx=xo_idx, rf_kind=rf_kind, rf_idx=rf_idx,
        mem_off=mem_off, mem_words=mem_words, valid_start=valid_start,
        nbr_idx=nbr_idx, nbr_ok=nbr_ok, bank_offsets=bank_offsets,
        total_words=total_words, depth=mapping.depth,
        lireg_assign=dict(mapping.lireg_assign),
    )
