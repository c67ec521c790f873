"""Packed MRRG routing engine (the hot path behind ``mrrg.py``).

The historical router kept resource usage in a ``Dict[Tuple, Set[Tuple]]``
and ran the time-layered BFS over ``(kind, pe, hold)`` tuples, paying a
tuple allocation plus ``CGRAArch.neighbor`` trigonometry for every explored
state.  This module packs both sides into flat integers:

  * resource keys ``('fu'|'fuout'|'xo'|'regpool'|'wr'|'bank'|'lireg', ...)``
    become indices into one dense id space (:class:`RouterTables.pack`),
  * router states become ``pe`` (fresh) or ``P + pe*II + (hold-1)``
    (register-resident),
  * per-PE neighbour/direction and Manhattan-distance tables are
    precomputed once per (topology, II) and shared across all ``Usage``
    instances (the mapper creates one per (II, seed) trial).

The exploration order of :func:`route_value` — register holds before
crossbar hops, hops in DIRS order, first-writer-wins frontier dedup —
is bit-for-bit the same as the historical implementation, so every route
(steps *and* the order of resource claims in ``uses``) is JSON-identical
to what the dict-of-tuples router produced.  ``mrrg.py`` re-exports this
module's API as the typed façade; see its docstring for the resource
model itself.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .adl import CGRAArch, DIRS

Key = Tuple
Inst = Tuple[int, int]   # (value_id, abs_time) — or (name, -1) for liregs

F, R = 0, 1   # state kinds

# transition codes stored in the packed parent entries: 0..3 = crossbar hop
# in DIRS order, 4 = register hold from R, 5 = register hold from F (which
# additionally claims a write port).
_HOLD_R, _HOLD_F = 4, 5

_EMPTY: frozenset = frozenset()


class RouterTables:
    """Per-(topology, II) packed lookup tables shared by every ``Usage``."""

    __slots__ = ("P", "II", "fuout_base", "xo_base", "regpool_base",
                 "wr_base", "bank_base", "lireg_base", "n_resources",
                 "nbrs", "dist", "cap_regpool", "cap_wr", "cap_lireg")

    def __init__(self, arch: CGRAArch, II: int):
        P = arch.n_pes
        self.P, self.II = P, II
        n = P * II
        self.fuout_base = n                   # fu occupies [0, n)
        self.xo_base = 2 * n                  # 4 ports per PE
        self.regpool_base = 6 * n
        self.wr_base = 7 * n
        self.bank_base = 8 * n
        self.lireg_base = 8 * n + len(arch.banks) * II
        self.n_resources = self.lireg_base + P
        self.nbrs: List[Tuple[Tuple[int, int], ...]] = [
            tuple((di, q) for di, d in enumerate(DIRS)
                  if (q := arch.neighbor(p, d)) is not None)
            for p in range(P)]
        self.dist: List[List[int]] = [
            [arch.manhattan(p, q) for q in range(P)] for p in range(P)]
        self.cap_regpool = arch.regfile_size
        self.cap_wr = arch.rf_write_ports
        self.cap_lireg = arch.livein_regs

    def pack(self, key: Key) -> int:
        k = key[0]
        II = self.II
        if k == "fu":
            return key[1] * II + key[2]
        if k == "fuout":
            return self.fuout_base + key[1] * II + key[2]
        if k == "xo":
            return self.xo_base + (key[1] * 4 + key[2]) * II + key[3]
        if k == "regpool":
            return self.regpool_base + key[1] * II + key[2]
        if k == "wr":
            return self.wr_base + key[1] * II + key[2]
        if k == "bank":
            return self.bank_base + key[1] * II + key[2]
        if k == "lireg":
            return self.lireg_base + key[1]
        raise KeyError(key)


_tables_cache: Dict[Tuple, RouterTables] = {}


def router_tables(arch: CGRAArch, II: int) -> RouterTables:
    # everything the tables read off the arch, nothing else
    ck = (II, arch.rows, arch.cols, arch.torus, arch.regfile_size,
          arch.rf_write_ports, arch.livein_regs, len(arch.banks))
    t = _tables_cache.get(ck)
    if t is None:
        t = _tables_cache[ck] = RouterTables(arch, II)
    return t


class Usage:
    """Resource usage map with value-instance dedup.

    Publicly keyed by the typed tuples documented in ``mrrg.py``; backed by
    the packed id space so the router never hashes a tuple key.
    """

    __slots__ = ("arch", "II", "tables", "_sets", "_keys")

    def __init__(self, arch: CGRAArch, II: int):
        self.arch = arch
        self.II = II
        self.tables = router_tables(arch, II)
        self._sets: Dict[int, Set[Inst]] = {}   # packed key -> instances
        self._keys: Dict[int, Key] = {}         # packed key -> typed key

    @property
    def map(self) -> Dict[Key, Set[Inst]]:
        """Typed view of the occupancy map (fresh dict; sets are live)."""
        keys = self._keys
        return {keys[i]: s for i, s in self._sets.items()}

    def cap(self, key: Key) -> int:
        k = key[0]
        if k in ("fu", "fuout", "xo", "bank"):
            return 1
        if k == "regpool":
            return self.arch.regfile_size
        if k == "wr":
            return self.arch.rf_write_ports
        if k == "lireg":
            return self.arch.livein_regs
        raise KeyError(key)

    def entries(self, key: Key) -> Set[Inst]:
        """Instances occupying ``key`` — always a fresh set, so callers
        cannot corrupt the occupancy map through the return value."""
        return set(self._sets.get(self.tables.pack(key), _EMPTY))

    def free_for(self, key: Key, inst: Inst) -> bool:
        """True if ``inst`` may occupy ``key`` (already present == free)."""
        cur = self._sets.get(self.tables.pack(key))
        if cur is None or inst in cur:
            return True
        # same value at a different absolute time aliasing this modulo slot
        # would be a second live copy of a periodic value: reject outright
        # for capacity-1 resources, count separately for pools.
        return len(cur) < self.cap(key)

    def has(self, key: Key, inst: Inst) -> bool:
        return inst in self._sets.get(self.tables.pack(key), _EMPTY)

    def add(self, key: Key, inst: Inst) -> None:
        i = self.tables.pack(key)
        s = self._sets.get(i)
        if s is None:
            s = self._sets[i] = set()
            self._keys[i] = key
        s.add(inst)

    def remove(self, key: Key, inst: Inst) -> None:
        i = self.tables.pack(key)
        s = self._sets.get(i)
        if s is not None:
            s.discard(inst)
            if not s:
                del self._sets[i]
                del self._keys[i]

    def clone_shallow(self) -> "Usage":
        u = Usage(self.arch, self.II)
        u._sets = {i: set(s) for i, s in self._sets.items()}
        u._keys = dict(self._keys)
        return u


@dataclass
class Route:
    """A routed data edge: value ``value`` travels from its production
    (src_pe, t_src) to consumption (dst_pe, t_dst)."""
    value: int
    src_pe: int
    t_src: int
    dst_pe: int
    t_dst: int
    # states visited: (kind, pe, t); steps[0] is the source, steps[-1] the
    # state the consumer reads from at t_dst.
    steps: List[Tuple[int, int, int]] = field(default_factory=list)
    # resource claims made for this route (excluding dedup-shared ones)
    uses: List[Tuple[Key, Inst]] = field(default_factory=list)

    @property
    def final_kind(self) -> int:
        return self.steps[-1][0]


def route_value(usage: Usage, arch: CGRAArch, II: int, value: int,
                src_pe: int, t_src: int, dst_pe: int, t_dst: int
                ) -> Optional[Route]:
    """Time-layered BFS over the routing graph.  All transitions advance
    one cycle, so every feasible route has identical cost — a forward
    frontier sweep from t_src to t_dst finds one if it exists.  Resources
    already carrying this exact value instance are reusable for free
    (fan-out sharing).  Register holds are explored before hops (they
    conserve crossbar bandwidth)."""
    if t_dst < t_src:
        return None
    if t_dst == t_src:
        if src_pe != dst_pe:
            return None
        return Route(value, src_pe, t_src, dst_pe, t_dst,
                     steps=[(F, src_pe, t_src)], uses=[])

    T = usage.tables
    P = T.P
    sets = usage._sets
    nbrs = T.nbrs
    xo_base, rp_base, wr_base = T.xo_base, T.regpool_base, T.wr_base
    cap_rp, cap_wr = T.cap_regpool, T.cap_wr

    # state ids: F at pe -> pe; R at pe with hold h -> P + pe*II + (h-1).
    # parent layers: state id -> prev_state_id * 8 + transition code.
    frontier: List[int] = [src_pe]
    parents: List[Dict[int, int]] = []
    for t in range(t_src, t_dst):
        slot = t % II
        slot1 = (t + 1) % II
        inst_t = (value, t)
        inst_t1 = (value, t + 1)
        layer: Dict[int, int] = {}
        nxt: List[int] = []
        for sid in frontier:
            if sid < P:
                pe, nh = sid, 1
            else:
                r = sid - P
                pe = r // II
                nh = (r % II) + 2          # hold + 1
            # 1) hold in the register file (preferred: no wire pressure)
            if nh <= II:
                nst = P + pe * II + (nh - 1)
                if nst not in layer:
                    cur = sets.get(rp_base + pe * II + slot1)
                    ok = (cur is None or inst_t1 in cur
                          or len(cur) < cap_rp)
                    if ok and sid < P:
                        cur = sets.get(wr_base + pe * II + slot)
                        ok = (cur is None or inst_t in cur
                              or len(cur) < cap_wr)
                    if ok:
                        layer[nst] = sid * 8 + (_HOLD_F if sid < P
                                                else _HOLD_R)
                        nxt.append(nst)
            # 2) crossbar hops (the F state of PE q has id q)
            base_pe = xo_base + pe * 4 * II
            for di, q in nbrs[pe]:
                if q in layer:
                    continue
                cur = sets.get(base_pe + di * II + slot)
                if cur is None or inst_t in cur:   # xo capacity is 1
                    layer[q] = sid * 8 + di
                    nxt.append(q)
        if not nxt:
            return None
        parents.append(layer)
        frontier = nxt

    goal = -1
    for sid in frontier:
        if (sid if sid < P else (sid - P) // II) == dst_pe:
            goal = sid
            break
    if goal < 0:
        return None

    # backtrack goal -> source, reconstructing the typed claims from the
    # transition codes; then reverse, exactly like the historical router.
    steps: List[Tuple[int, int, int]] = []
    uses: List[Tuple[Key, Inst]] = []
    sid = goal
    for li in range(len(parents) - 1, -1, -1):
        t = t_src + li + 1
        if sid < P:
            kind, pe = F, sid
        else:
            kind, pe = R, (sid - P) // II
        steps.append((kind, pe, t))
        entry = parents[li][sid]
        prev, code = entry >> 3, entry & 7
        pt = t - 1
        if code >= _HOLD_R:
            inst = (value, t)
            if inst not in sets.get(rp_base + pe * II + t % II, _EMPTY):
                uses.append((("regpool", pe, t % II), inst))
            if code == _HOLD_F:
                inst = (value, pt)
                if inst not in sets.get(wr_base + pe * II + pt % II, _EMPTY):
                    uses.append((("wr", pe, pt % II), inst))
        else:
            ppe = prev if prev < P else (prev - P) // II
            inst = (value, pt)
            if inst not in sets.get(xo_base + (ppe * 4 + code) * II
                                    + pt % II, _EMPTY):
                uses.append((("xo", ppe, code, pt % II), inst))
        sid = prev
    steps.append((F, src_pe, t_src))
    steps.reverse()
    uses.reverse()
    return Route(value, src_pe, t_src, dst_pe, t_dst, steps=steps, uses=uses)


def commit_route(usage: Usage, route: Route) -> None:
    for key, inst in route.uses:
        usage.add(key, inst)


def release_route(usage: Usage, route: Route) -> None:
    for key, inst in route.uses:
        usage.remove(key, inst)
