"""Dataflow-graph IR for CGRA loop kernels.

This is the analogue of Morpher's DFG generator output (paper Fig. 3, piece
4).  A DFG describes the body of one loop iteration of the *mapped* loop
level; loop-carried dependences are expressed as operand references with an
iteration ``dist`` >= 1 (plus an ``init`` value consumed for the first
``dist`` iterations, which models the host pre-loading live-in registers —
the paper's "transferring outer loop iteration variables from the host").

Node ops (all execute on a CGRA PE functional unit):
  CONST   -- materialize an immediate from configuration memory (lat 1)
  LIVEIN  -- read a host-preloaded live-in scalar register        (lat 1)
  ADD/SUB/MUL/SHL/SHR/AND/OR/XOR/CMPGE/CMPEQ/CMPLT  -- ALU        (lat 1)
  SELECT  -- predicated select: operands (cond, a, b)             (lat 1)
  LOAD    -- read a word from a memory bank: operands (addr,)     (lat 2)
  STORE   -- write a word to a memory bank: operands (addr, val)  (lat 1)

A pure sequential ``reference_execute`` gives the oracle semantics used by
the verification flow (paper section IV-C): the modulo-scheduled, pipelined
CGRA simulation must produce the same final memory state.
"""
from __future__ import annotations

import enum
import heapq
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DATAPATH_BITS = 16


def wrap(x: int, bits: int = DATAPATH_BITS) -> int:
    """Two's-complement wraparound to the CGRA datapath width."""
    m = 1 << bits
    x &= m - 1
    if x >= m >> 1:
        x -= m
    return x


class Op(enum.Enum):
    CONST = "const"
    LIVEIN = "livein"
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    SHL = "shl"
    SHR = "shr"
    AND = "and"
    OR = "or"
    XOR = "xor"
    CMPGE = "cmpge"
    CMPEQ = "cmpeq"
    CMPLT = "cmplt"
    SELECT = "select"
    LOAD = "load"
    STORE = "store"


ALU_OPS = {Op.ADD, Op.SUB, Op.MUL, Op.SHL, Op.SHR, Op.AND, Op.OR, Op.XOR,
           Op.CMPGE, Op.CMPEQ, Op.CMPLT, Op.SELECT}
MEM_OPS = {Op.LOAD, Op.STORE}

LATENCY = {Op.LOAD: 2}
DEFAULT_LATENCY = 1

# operand arity per op (binary ALU ops default to 2)
_N_OPERANDS = {Op.CONST: 0, Op.LIVEIN: 0, Op.LOAD: 1, Op.STORE: 2,
               Op.SELECT: 3}


def latency(op: Op) -> int:
    return LATENCY.get(op, DEFAULT_LATENCY)


@dataclass(frozen=True, slots=True)
class Operand:
    """A data edge src -> consumer.

    dist: iteration distance (0 = same iteration, d>=1 = loop-carried: the
          consumer in iteration n reads the producer's value from iteration
          n - d; for n < d it reads ``init``).
    """
    src: int
    dist: int = 0
    init: int = 0


@dataclass(slots=True)
class Node:
    id: int
    op: Op
    operands: Tuple[Operand, ...] = ()
    imm: Optional[int] = None       # CONST value
    livein: Optional[str] = None    # LIVEIN symbolic name
    array: Optional[str] = None     # LOAD/STORE target array
    name: str = ""

    @property
    def lat(self) -> int:
        return latency(self.op)

    @property
    def is_mem(self) -> bool:
        return self.op in MEM_OPS


@dataclass(frozen=True)
class MemDep:
    """Ordering-only loop-carried memory dependence (e.g. the
    output-stationary O[i][j] store -> next-iteration load)."""
    src: int    # store node
    dst: int    # load node
    dist: int = 1


@dataclass
class DFG:
    name: str
    nodes: Dict[int, Node] = field(default_factory=dict)
    mem_deps: List[MemDep] = field(default_factory=list)

    # ---------------------------------------------------------------- util
    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_mem_nodes(self) -> int:
        return sum(1 for n in self.nodes.values() if n.is_mem)

    def consumers(self) -> Dict[int, List[Tuple[int, int]]]:
        """node id -> list of (consumer id, operand slot)."""
        out: Dict[int, List[Tuple[int, int]]] = {i: [] for i in self.nodes}
        for n in self.nodes.values():
            for slot, opnd in enumerate(n.operands):
                out[opnd.src].append((n.id, slot))
        return out

    def data_edges(self) -> List[Tuple[int, int, int, Operand]]:
        """(src, dst, slot, operand) for every data edge."""
        edges = []
        for n in self.nodes.values():
            for slot, opnd in enumerate(n.operands):
                edges.append((opnd.src, n.id, slot, opnd))
        return edges

    def topo_order(self) -> List[int]:
        """Topological order over dist==0 edges (loop body DAG).

        Ready nodes resolve lowest-id-first (a min-heap; order-identical
        to the historical sort-per-step implementation, without its
        quadratic re-sorting — this sits on the tracing and reference-
        execution hot paths)."""
        indeg = {i: 0 for i in self.nodes}
        succ: Dict[int, List[int]] = {i: [] for i in self.nodes}
        for n in self.nodes.values():
            for opnd in n.operands:
                if opnd.dist == 0:
                    indeg[n.id] += 1
                    succ[opnd.src].append(n.id)
        ready = [i for i, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        order: List[int] = []
        while ready:
            v = heapq.heappop(ready)
            order.append(v)
            for s in succ[v]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if len(order) != len(self.nodes):
            raise ValueError(f"DFG {self.name}: cycle through dist-0 edges")
        return order

    def validate(self) -> None:
        for n in self.nodes.values():
            for opnd in n.operands:
                if opnd.src not in self.nodes:
                    raise ValueError(f"node {n.id} references missing {opnd.src}")
            if n.op == Op.CONST and n.imm is None:
                raise ValueError(f"CONST node {n.id} missing imm")
            if n.op == Op.LIVEIN and n.livein is None:
                raise ValueError(f"LIVEIN node {n.id} missing name")
            if n.op in MEM_OPS and n.array is None:
                raise ValueError(f"mem node {n.id} missing array")
            nops = _N_OPERANDS.get(n.op, 2)
            if len(n.operands) != nops:
                raise ValueError(
                    f"node {n.id} op {n.op} expects {nops} operands, "
                    f"got {len(n.operands)}")
        self.topo_order()  # raises on dist-0 cycles

    # --------------------------------------------------------- serialization
    def to_json_dict(self) -> dict:
        """JSON-able structural form (same idiom as the ADL round-trip)."""
        nodes = []
        for nid in sorted(self.nodes):
            n = self.nodes[nid]
            nodes.append({
                "id": n.id, "op": n.op.value,
                "operands": [[o.src, o.dist, o.init] for o in n.operands],
                "imm": n.imm, "livein": n.livein, "array": n.array,
                "name": n.name,
            })
        return {"name": self.name, "nodes": nodes,
                "mem_deps": [[m.src, m.dst, m.dist] for m in self.mem_deps]}

    @staticmethod
    def from_json_dict(d: dict) -> "DFG":
        dfg = DFG(d["name"])
        for nd in d["nodes"]:
            dfg.nodes[nd["id"]] = Node(
                id=nd["id"], op=Op(nd["op"]),
                operands=tuple(Operand(src, dist, init)
                               for src, dist, init in nd["operands"]),
                imm=nd["imm"], livein=nd["livein"], array=nd["array"],
                name=nd["name"])
        dfg.mem_deps = [MemDep(src, dst, dist)
                        for src, dst, dist in d["mem_deps"]]
        return dfg

    def canonical_dict(self) -> dict:
        """Structural canonical form — the content-addressing identity.

        Node ids are compacted to a dense 0..n-1 numbering (emission
        order) and cosmetic node ``name`` labels are dropped: two DFGs
        describing the same program through different front ends (the
        hand-built :class:`DFGBuilder` wiring vs the ``repro_torch.frontend``
        tracer) canonicalize identically, while any semantic difference —
        ops, operand wiring, loop-carried dists/inits, immediates, live-in
        names, target arrays, memory ordering edges — still changes the
        form (and therefore the compile cache key).
        """
        order = sorted(self.nodes)
        remap = {nid: i for i, nid in enumerate(order)}
        nodes = []
        for nid in order:
            n = self.nodes[nid]
            nodes.append({
                "id": remap[nid], "op": n.op.value,
                "operands": [[remap[o.src], o.dist, o.init]
                             for o in n.operands],
                "imm": n.imm, "livein": n.livein, "array": n.array,
            })
        return {"name": self.name, "nodes": nodes,
                "mem_deps": sorted([remap[m.src], remap[m.dst], m.dist]
                                   for m in self.mem_deps)}

    def canonical_json(self) -> str:
        """Stable canonical form — the content-addressing key component."""
        return json.dumps(self.canonical_dict(), sort_keys=True,
                          separators=(",", ":"))

    # ------------------------------------------------------- oracle semantics
    def reference_execute(self, n_iters: int, arrays: Dict[str, List[int]],
                          liveins: Dict[str, int],
                          bits: int = DATAPATH_BITS) -> Dict[str, List[int]]:
        """Sequential (non-pipelined) execution: the verification oracle.

        arrays: name -> flat word list (mutated copy returned).
        liveins: live-in scalar values for this invocation.
        """
        mem = {k: list(v) for k, v in arrays.items()}
        order = self.topo_order()
        # history[node][d] = value produced d iterations ago (d=1..maxdist)
        maxdist = max([o.dist for _s, _d, _sl, o in
                       [(e[0], e[1], e[2], e[3]) for e in self.data_edges()]]
                      + [0])
        hist: Dict[int, List[int]] = {i: [] for i in self.nodes}

        def read(opnd: Operand, cur: Dict[int, int]) -> int:
            if opnd.dist == 0:
                return cur[opnd.src]
            h = hist[opnd.src]
            if len(h) < opnd.dist:
                return wrap(opnd.init, bits)
            return h[-opnd.dist]

        for _it in range(n_iters):
            cur: Dict[int, int] = {}
            for vid in order:
                n = self.nodes[vid]
                if n.op == Op.CONST:
                    cur[vid] = wrap(n.imm, bits)
                elif n.op == Op.LIVEIN:
                    cur[vid] = wrap(liveins[n.livein], bits)
                elif n.op == Op.LOAD:
                    addr = read(n.operands[0], cur)
                    buf = mem[n.array]
                    cur[vid] = buf[addr] if 0 <= addr < len(buf) else 0
                elif n.op == Op.STORE:
                    addr = read(n.operands[0], cur)
                    val = read(n.operands[1], cur)
                    buf = mem[n.array]
                    if 0 <= addr < len(buf):
                        buf[addr] = val
                    cur[vid] = 0
                else:
                    a = read(n.operands[0], cur)
                    b = read(n.operands[1], cur) if len(n.operands) > 1 else 0
                    if n.op == Op.ADD:
                        r = a + b
                    elif n.op == Op.SUB:
                        r = a - b
                    elif n.op == Op.MUL:
                        r = a * b
                    elif n.op == Op.SHL:
                        r = a << (b & (bits - 1))
                    elif n.op == Op.SHR:
                        r = a >> (b & (bits - 1))
                    elif n.op == Op.AND:
                        r = a & b
                    elif n.op == Op.OR:
                        r = a | b
                    elif n.op == Op.XOR:
                        r = a ^ b
                    elif n.op == Op.CMPGE:
                        r = 1 if a >= b else 0
                    elif n.op == Op.CMPEQ:
                        r = 1 if a == b else 0
                    elif n.op == Op.CMPLT:
                        r = 1 if a < b else 0
                    elif n.op == Op.SELECT:
                        c = read(n.operands[2], cur)
                        r = b if a != 0 else c  # operands (cond, a_true, b_false)
                    else:
                        raise NotImplementedError(n.op)
                    cur[vid] = wrap(r, bits)
            for vid in order:
                h = hist[vid]
                h.append(cur[vid])
                if len(h) > maxdist:
                    h.pop(0)
        return mem

    def reference_execute_batch(self, n_iters: int, arrays, invocations,
                                bits: int = DATAPATH_BITS):
        """``reference_execute`` vectorized over a leading batch axis and
        folded over all invocations in one call.

        arrays: name -> int array of shape [batch, words] (one row per
        test vector); invocations: the host outer-loop livein dicts; a
        fresh dict of final images is returned.  Per row the result is
        bit-identical to folding the scalar oracle over the invocations:
        every node value becomes a [batch] int64 vector, wrapped to the
        datapath width after each op exactly as the scalar path wraps its
        Python ints (operands are always in 16-bit range, so int64
        intermediates never overflow).  The node program (topological
        order, operand bindings) is compiled once for the whole sweep,
        which together with the batch vectorization keeps the numpy
        oracle off the critical path when the batched verification engine
        checks many seeds at once.
        """
        import numpy as np
        mem = {k: np.array(v, dtype=np.int64) for k, v in arrays.items()}
        B = next(iter(mem.values())).shape[0] if mem else 1
        rows = np.arange(B)
        half, full = 1 << (bits - 1), 1 << bits

        def awrap(x):
            return ((x + half) & (full - 1)) - half

        order = self.topo_order()
        prog = [(vid, self.nodes[vid]) for vid in order]
        maxdist = max([o.dist for _s, _d, _sl, o in self.data_edges()] + [0])

        def read(opnd: Operand, cur, hist):
            if opnd.dist == 0:
                return cur[opnd.src]
            h = hist[opnd.src]
            if len(h) < opnd.dist:
                return np.full(B, wrap(opnd.init, bits), dtype=np.int64)
            return h[-opnd.dist]

        for inv in invocations:
            hist: Dict[int, List] = {i: [] for i in self.nodes}
            for _it in range(n_iters):
                cur: Dict[int, "np.ndarray"] = {}
                for vid, n in prog:
                    if n.op == Op.CONST:
                        cur[vid] = np.full(B, wrap(n.imm, bits),
                                           dtype=np.int64)
                    elif n.op == Op.LIVEIN:
                        cur[vid] = np.full(B, wrap(inv[n.livein], bits),
                                           dtype=np.int64)
                    elif n.op == Op.LOAD:
                        addr = read(n.operands[0], cur, hist)
                        buf = mem[n.array]
                        ok = (addr >= 0) & (addr < buf.shape[1])
                        cur[vid] = np.where(
                            ok, buf[rows, np.clip(addr, 0,
                                                  buf.shape[1] - 1)], 0)
                    elif n.op == Op.STORE:
                        addr = read(n.operands[0], cur, hist)
                        val = read(n.operands[1], cur, hist)
                        buf = mem[n.array]
                        ok = (addr >= 0) & (addr < buf.shape[1])
                        buf[rows[ok], addr[ok]] = val[ok]
                        cur[vid] = np.zeros(B, dtype=np.int64)
                    else:
                        a = read(n.operands[0], cur, hist)
                        b = read(n.operands[1], cur, hist) \
                            if len(n.operands) > 1 \
                            else np.zeros(B, dtype=np.int64)
                        if n.op == Op.ADD:
                            r = a + b
                        elif n.op == Op.SUB:
                            r = a - b
                        elif n.op == Op.MUL:
                            r = a * b
                        elif n.op == Op.SHL:
                            r = a << (b & (bits - 1))
                        elif n.op == Op.SHR:
                            r = a >> (b & (bits - 1))
                        elif n.op == Op.AND:
                            r = a & b
                        elif n.op == Op.OR:
                            r = a | b
                        elif n.op == Op.XOR:
                            r = a ^ b
                        elif n.op == Op.CMPGE:
                            r = (a >= b).astype(np.int64)
                        elif n.op == Op.CMPEQ:
                            r = (a == b).astype(np.int64)
                        elif n.op == Op.CMPLT:
                            r = (a < b).astype(np.int64)
                        elif n.op == Op.SELECT:
                            c = read(n.operands[2], cur, hist)
                            r = np.where(a != 0, b, c)
                        else:
                            raise NotImplementedError(n.op)
                        cur[vid] = awrap(r)
                if maxdist:
                    for vid in order:
                        h = hist[vid]
                        h.append(cur[vid])
                        if len(h) > maxdist:
                            h.pop(0)
        return mem


class DFGBuilder:
    """Small builder DSL — the stand-in for Morpher's LLVM DFG pass."""

    def __init__(self, name: str):
        self.dfg = DFG(name)
        self._next = 0
        self._const_cache: Dict[int, int] = {}
        self._livein_cache: Dict[str, int] = {}

    def _add(self, op: Op, operands=(), **kw) -> int:
        nid = self._next
        self._next += 1
        ops = tuple(o if isinstance(o, Operand) else Operand(o)
                    for o in operands)
        self.dfg.nodes[nid] = Node(nid, op, ops, **kw)
        return nid

    # SSA-ish helpers. Constants / live-ins are cached (the LLVM pass also
    # CSEs these), which keeps node counts in the paper's ballpark.
    def const(self, v: int, name: str = "") -> int:
        if v not in self._const_cache:
            self._const_cache[v] = self._add(Op.CONST, imm=v,
                                             name=name or f"c{v}")
        return self._const_cache[v]

    def livein(self, nm: str) -> int:
        if nm not in self._livein_cache:
            self._livein_cache[nm] = self._add(Op.LIVEIN, livein=nm, name=nm)
        return self._livein_cache[nm]

    def add(self, a, b, name=""):
        return self._add(Op.ADD, (a, b), name=name)

    def sub(self, a, b, name=""):
        return self._add(Op.SUB, (a, b), name=name)

    def mul(self, a, b, name=""):
        return self._add(Op.MUL, (a, b), name=name)

    def cmpge(self, a, b, name=""):
        return self._add(Op.CMPGE, (a, b), name=name)

    def cmpeq(self, a, b, name=""):
        return self._add(Op.CMPEQ, (a, b), name=name)

    def select(self, cond, a, b, name=""):
        return self._add(Op.SELECT, (cond, a, b), name=name)

    def load(self, array: str, addr, name=""):
        return self._add(Op.LOAD, (addr,), array=array, name=name)

    def store(self, array: str, addr, val, name=""):
        return self._add(Op.STORE, (addr, val), array=array, name=name)

    def op(self, op: Op, *operands, name=""):
        return self._add(op, operands, name=name)

    def carried(self, src: int, dist: int = 1, init: int = 0) -> Operand:
        """Reference to ``src``'s value from ``dist`` iterations ago."""
        return Operand(src, dist=dist, init=init)

    def mem_dep(self, store_id: int, load_id: int, dist: int = 1) -> None:
        self.dfg.mem_deps.append(MemDep(store_id, load_id, dist))

    def build(self) -> DFG:
        self.dfg.validate()
        return self.dfg
