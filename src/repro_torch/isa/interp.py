"""Standalone interpreter for exported per-PE instruction streams.

This is the reproduction's *second, independent* executable semantics: a
small pure-Python/numpy machine that parses the ``instructions.csv`` /
``stream_manifest.json`` artifact family (``repro_torch.isa.encode``) and
executes it cycle-by-cycle over a word-addressed memory image.  It shares
**no code** with the torch simulator (``core/simulator.py``): instructions
are decoded from their CSV mnemonics, not from ``SimConfig`` arrays, and
every machine rule below is written from the architecture contract —

  * each cycle, every PE runs its slot-(t mod II) instruction;
  * all reads (operand muxes, RF/crossbar writeback selects, loads) see
    the *start-of-cycle* state snapshot; all writes (FU output register,
    load pipeline register, RF, crossbar output registers, memory stores)
    commit together at end of cycle (fully synchronous design);
  * operand selects draw from {4 inbound crossbar wires (the neighbour's
    opposite-facing output port), register file, own FU output, the
    slot's immediate, live-in registers}; an operand with an active force
    window reads its preload value while ``t < force_before``;
  * the datapath is ``bits``-wide two's complement; LOAD has a 2-cycle
    latency through the load pipeline register; STORE commits end of
    cycle, gated by the iteration-validity window
    ``tstart <= t < tstart + n_iters * II``; load/store addresses clip
    into the bound bank;
  * invocations reset all registers but thread the memory image.

Cross-validation (``repro_torch.isa.xval``) pins this interpreter bit-identical
to ``simulate()`` on the whole kernel library, which is what makes the
exported stream a trustworthy deployment artifact *and* gives the verify
fleet an oracle that cannot share a bug with the simulator's torch path.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .encode import ASM_NAME, CSV_NAME, MANIFEST_NAME, STREAM_FORMAT


class StreamError(ValueError):
    """The stream artifact is malformed or internally inconsistent."""


# the four inbound-wire mnemonics, in the manifest's direction order, and
# the opposite-facing port a reader consults on its neighbour
_IN_DIRS = ("in_n", "in_e", "in_s", "in_w")
_OPP = (2, 3, 0, 1)

_SEL_RE = re.compile(r"^([a-z_]+?)(\d*)$")


def _parse_sel(text: str) -> Tuple[str, int]:
    """'reg3' -> ('reg', 3); 'in_n' -> ('in_n', 0); 'none' -> ('none', 0)."""
    m = _SEL_RE.match(text)
    if not m:
        raise StreamError(f"unparseable mux select {text!r} "
                          f"(rule STR-SEL-RANGE)")
    kind, idx = m.group(1), m.group(2)
    return kind, int(idx) if idx else 0


@dataclass
class Insn:
    """One decoded (slot, pe) record with at least one effect."""
    pe: int
    opcode: str                                  # mnemonic ('nop' possible)
    imm: int
    ops: List[Tuple[str, int]]                   # 3 operand selects
    force: List[Tuple[int, int]]                 # (force_before, force_val)
    xo: List[Tuple[int, str, int]] = field(default_factory=list)
    rf: List[Tuple[int, str, int]] = field(default_factory=list)
    mem_off: int = 0
    mem_words: int = 1
    tstart: int = 0


@dataclass
class InstructionStream:
    """A parsed stream: the manifest header plus per-slot decoded insns."""
    kernel: str
    II: int
    P: int
    RF: int
    LI: int
    bits: int
    depth: int
    total_words: int
    bank_offsets: Dict[int, int]
    liveins: Dict[str, Tuple[int, int]]
    neighbors: List[List[Optional[int]]]         # [P][4], None = no wire
    slots: List[List[Insn]]                      # [II] active insns, pe asc

    def n_cycles(self, n_iters: int) -> int:
        return (n_iters - 1) * self.II + self.depth


def parse_stream(csv_text: str, manifest: dict) -> InstructionStream:
    """Decode the CSV against its manifest into an executable stream."""
    if manifest.get("stream_format") != STREAM_FORMAT:
        raise StreamError(f"stream_format {manifest.get('stream_format')} "
                          f"!= {STREAM_FORMAT} (rule STR-PARSE)")
    II, P, RF = manifest["II"], manifest["P"], manifest["RF"]
    LI = max(1, manifest["LI"])
    lines = csv_text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()                              # trailing newline
    header = lines[0].split(",")
    if header != manifest["columns"]:
        raise StreamError("CSV header does not match manifest columns "
                          "(rule STR-PARSE)")
    col = {c: i for i, c in enumerate(header)}
    if len(lines) - 1 != II * P:
        raise StreamError(f"expected {II * P} records, got {len(lines) - 1} "
                          f"(rule STR-PARSE)")

    slots: List[List[Insn]] = [[] for _ in range(II)]
    seen = set()
    for ln in lines[1:]:
        v = ln.split(",")
        if len(v) != len(header):
            raise StreamError(f"short record: {ln!r} (rule STR-PARSE)")
        slot, pe = int(v[col["slot"]]), int(v[col["pe"]])
        if not (0 <= slot < II and 0 <= pe < P):
            raise StreamError(f"slot{slot}/pe{pe}: record out of range "
                              f"(rule STR-PARSE)")
        if (slot, pe) in seen:
            raise StreamError(f"slot{slot}/pe{pe}: duplicate record "
                              f"(rule STR-PARSE)")
        seen.add((slot, pe))
        ops = [_parse_sel(v[col[f"op{o}"]]) for o in range(3)]
        force = [(int(v[col[f"op{o}_fb"]]), int(v[col[f"op{o}_fv"]]))
                 for o in range(3)]
        xo = []
        for d, dn in enumerate(manifest["dirs"]):
            k, i = _parse_sel(v[col[f"xo_{dn.lower()}"]])
            if k != "none":
                xo.append((d, k, i))
        rf = []
        for r in range(RF):
            k, i = _parse_sel(v[col[f"rf{r}"]])
            if k != "none":
                rf.append((r, k, i))
        ins = Insn(pe=pe, opcode=v[col["opcode"]],
                   imm=int(v[col["imm"]]), ops=ops, force=force,
                   xo=xo, rf=rf,
                   mem_off=int(v[col["mem_off"]]),
                   mem_words=int(v[col["mem_words"]]),
                   tstart=int(v[col["tstart"]]))
        if ins.opcode != "nop" or xo or rf:
            slots[slot].append(ins)
    for sl in slots:
        sl.sort(key=lambda i: i.pe)              # commit order = pe asc
    return InstructionStream(
        kernel=manifest["kernel"], II=II, P=P, RF=RF, LI=LI,
        bits=manifest["bits"], depth=manifest["depth"],
        total_words=manifest["total_words"],
        bank_offsets={int(k): v
                      for k, v in manifest["bank_offsets"].items()},
        liveins={n: (pe, idx)
                 for n, (pe, idx) in manifest["liveins"].items()},
        neighbors=manifest["neighbors"], slots=slots)


def load_stream(stream_dir: str) -> InstructionStream:
    """Parse an exported stream directory (``instructions.csv`` +
    ``stream_manifest.json``; the ``.asm`` is documentation, not input)."""
    with open(os.path.join(stream_dir, MANIFEST_NAME), encoding="utf-8") as f:
        manifest = json.load(f)
    with open(os.path.join(stream_dir, CSV_NAME), encoding="utf-8") as f:
        csv_text = f.read()
    return parse_stream(csv_text, manifest)


def _wrap(x: int, bits: int) -> int:
    m = 1 << bits
    x &= m - 1
    return x - m if x >= (m >> 1) else x


def _alu(opcode: str, a: int, b: int, c: int, bits: int) -> int:
    if opcode == "pass":
        r = a
    elif opcode == "add":
        r = a + b
    elif opcode == "sub":
        r = a - b
    elif opcode == "mul":
        r = a * b
    elif opcode == "shl":
        r = a << (b & (bits - 1))
    elif opcode == "shr":
        r = a >> (b & (bits - 1))
    elif opcode == "and":
        r = a & b
    elif opcode == "or":
        r = a | b
    elif opcode == "xor":
        r = a ^ b
    elif opcode == "cmpge":
        r = 1 if a >= b else 0
    elif opcode == "cmpeq":
        r = 1 if a == b else 0
    elif opcode == "cmplt":
        r = 1 if a < b else 0
    elif opcode == "select":
        r = b if a != 0 else c
    else:
        raise StreamError(f"unknown opcode mnemonic {opcode!r} "
                          f"(rule STR-OPC)")
    return _wrap(r, bits)


class _Machine:
    """Register state of one invocation (memory lives outside: it threads
    across invocations)."""

    def __init__(self, s: InstructionStream):
        self.regs = [[0] * s.RF for _ in range(s.P)]
        self.xo = [[0, 0, 0, 0] for _ in range(s.P)]
        self.fu = [0] * s.P
        self.ldp = [0] * s.P
        self.fl: set = set()                     # PEs that loaded last cycle


def _resolve(s: InstructionStream, m: _Machine, pe: int, imm: int,
             kind: str, idx: int) -> int:
    """One mux select against the start-of-cycle snapshot."""
    if kind == "none":
        return 0
    if kind == "fu":
        return m.fu[pe]
    if kind == "imm":
        return imm
    if kind == "reg":
        return m.regs[pe][idx]
    if kind == "li":
        return m.li[pe][idx]
    try:
        d = _IN_DIRS.index(kind)
    except ValueError:
        raise StreamError(f"pe{pe}: unknown mux select {kind!r} "
                          f"(rule STR-SEL-RANGE)") from None
    nbr = s.neighbors[pe][d]
    if nbr is None:
        raise StreamError(f"pe{pe} reads {kind} but has no neighbour there "
                          f"(rule STR-SEL-RANGE)")
    return m.xo[nbr][_OPP[d]]


def interpret(s: InstructionStream, banks: Dict[str, np.ndarray],
              invocations: Sequence[Dict[str, int]],
              n_iters: int) -> Dict[str, np.ndarray]:
    """Execute every invocation over the initial bank images; returns the
    final banks (same keying as the simulator: ``bank<id>`` -> array).
    """
    dtype = np.int16 if s.bits == 16 else np.int32
    mem = np.zeros(s.total_words, dtype=dtype)
    for bid, off in s.bank_offsets.items():
        img = np.asarray(banks[f"bank{bid}"])
        mem[off:off + len(img)] = img.astype(dtype)  # datapath-width wrap

    n_cycles = s.n_cycles(n_iters)
    window = n_iters * s.II
    for inv in invocations:
        m = _Machine(s)
        m.li = [[0] * s.LI for _ in range(s.P)]
        for name, (pe, idx) in s.liveins.items():
            m.li[pe][idx] = _wrap(int(inv.get(name, 0)), s.bits)
        for t in range(n_cycles):
            insns = s.slots[t % s.II]
            res_up: Dict[int, int] = {}
            ld_up: Dict[int, int] = {}
            st_commits: List[Tuple[int, int]] = []
            rf_writes: List[Tuple[int, int, int]] = []
            xo_writes: List[Tuple[int, int, int]] = []
            for ins in insns:
                pe = ins.pe
                vals = [_resolve(s, m, pe, ins.imm, k, i)
                        for k, i in ins.ops]
                for o, (fb, fv) in enumerate(ins.force):
                    if t < fb:
                        vals[o] = fv
                a, b, c = vals
                if ins.opcode == "load":
                    addr = ins.mem_off + min(max(a, 0), ins.mem_words - 1)
                    ld_up[pe] = int(mem[addr])
                elif ins.opcode == "store":
                    if ins.tstart <= t < ins.tstart + window:
                        addr = ins.mem_off + min(max(a, 0),
                                                 ins.mem_words - 1)
                        st_commits.append((addr, b))
                elif ins.opcode != "nop":
                    res_up[pe] = _alu(ins.opcode, a, b, c, s.bits)
                for d, k, i in ins.xo:
                    xo_writes.append((pe, d, _resolve(s, m, pe, ins.imm,
                                                      k, i)))
                for r, k, i in ins.rf:
                    rf_writes.append((pe, r, _resolve(s, m, pe, ins.imm,
                                                      k, i)))
            # end-of-cycle commit: FU pipeline first (a completing load
            # wins the FU output register over this slot's ALU result)
            for pe in m.fl:
                m.fu[pe] = m.ldp[pe]
            for pe, v in res_up.items():
                if pe not in m.fl:
                    m.fu[pe] = v
            m.fl = set(ld_up)
            for pe, v in ld_up.items():
                m.ldp[pe] = v
            for addr, v in st_commits:
                mem[addr] = v
            for pe, r, v in rf_writes:
                m.regs[pe][r] = v
            for pe, d, v in xo_writes:
                m.xo[pe][d] = v
    return {f"bank{bid}": mem[off:off + len(np.asarray(banks[f"bank{bid}"]))]
            .copy()
            for bid, off in s.bank_offsets.items()}
