"""CGRA mapper: iterative modulo scheduling + placement + routing on the
MRRG (paper Fig. 3 piece 5).

Pipeline per candidate II (starting at MII, escalating on failure):
  1. priority order: recurrence-cycle nodes first, then by DAG height;
  2. unified slot+PE assignment: for each node scan a (time x PE) candidate
     window ordered by a cheap lower bound, place at the first candidate
     from which *all* edges to already-placed neighbours route conflict-free
     on the MRRG (strict, no-overuse routing with free fan-out sharing);
  3. limited rip-up: on failure evict the blocking neighbourhood and retry;
  4. register-file assignment: residency intervals from the routes are
     coloured onto the R physical registers per PE (cyclic-interval greedy).

MII = max(ResMII, RecMII):
  ResMII = max( ceil(#ops / #PEs), max_bank #accesses(bank),
                ceil(#mem-ops / #mem-PEs) )
  RecMII = smallest II with no positive cycle of (lat(u) - II*dist) —
           Bellman-Ford feasibility test (Rau'94).
"""
from __future__ import annotations

import json
import random
import warnings
from collections import deque
from concurrent.futures import TimeoutError as _FuturesTimeout
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .adl import CGRAArch
from .dfg import DFG, Node, Op, Operand, latency
from .layout import DataLayout
from .mrrg import F, R, Route, Usage, commit_route, release_route, route_value
from .pool import reset_pool, submit_all


# ----------------------------------------------------------------- options
@dataclass(frozen=True)
class MapperOptions:
    """The one place mapper search knobs live (paper's DRESC loop limits).

    Every caller of the flow — toolchain, offload analyzer, benchmarks,
    examples — goes through this dataclass instead of scattering raw
    ``ii_max``/``seeds``/``time_budget_s`` arguments.  The defaults are the
    project-wide policy: II escalation up to 32 (every Table-I kernel maps
    well below that), four placement seeds per II, no wall-clock budget.
    """
    ii_max: int = 32
    seeds: Tuple[int, ...] = (0, 1, 2, 3)
    ii_start: Optional[int] = None
    time_budget_s: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "seeds", tuple(self.seeds))

    # JSON round-trip (same idiom as the ADL) — feeds the content-addressed
    # compile cache key, so it must be stable and canonical.
    def to_json_dict(self) -> dict:
        return {"ii_max": self.ii_max, "seeds": list(self.seeds),
                "ii_start": self.ii_start,
                "time_budget_s": self.time_budget_s}

    @staticmethod
    def from_json_dict(d: dict) -> "MapperOptions":
        return MapperOptions(ii_max=d["ii_max"], seeds=tuple(d["seeds"]),
                             ii_start=d["ii_start"],
                             time_budget_s=d["time_budget_s"])


# --------------------------------------------------------------------- MII
def _edges_with_memdeps(dfg: DFG):
    """(src, dst, lat(src), dist) including ordering-only memory deps."""
    out = []
    for src, dst, _slot, opnd in dfg.data_edges():
        out.append((src, dst, latency(dfg.nodes[src].op), opnd.dist))
    for md in dfg.mem_deps:
        out.append((md.src, md.dst, latency(dfg.nodes[md.src].op), md.dist))
    return out


def rec_mii(dfg: DFG, ii_max: int = 128) -> int:
    edges = _edges_with_memdeps(dfg)
    ids = list(dfg.nodes)

    def feasible(ii: int) -> bool:
        # no positive cycle of weight lat - ii*dist  (longest-path relax)
        pot = {i: 0 for i in ids}
        for it in range(len(ids) + 1):
            changed = False
            for src, dst, lat, dist in edges:
                w = lat - ii * dist
                if pot[src] + w > pot[dst]:
                    pot[dst] = pot[src] + w
                    changed = True
            if not changed:
                return True
        return False

    lo, hi = 1, ii_max
    while lo < hi:
        mid = (lo + hi) // 2
        if feasible(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def res_mii(dfg: DFG, arch: CGRAArch, bank_of: Dict[int, int]) -> int:
    n_pes = arch.n_pes
    fu = -(-dfg.n_nodes // n_pes)
    mem_nodes = [n for n in dfg.nodes.values() if n.is_mem]
    per_bank: Dict[int, int] = {}
    for n in mem_nodes:
        per_bank[bank_of[n.id]] = per_bank.get(bank_of[n.id], 0) + 1
    bank = max(per_bank.values(), default=0)
    mem_pe = -(-len(mem_nodes) // max(1, len(arch.mem_pes)))
    return max(fu, bank, mem_pe, 1)


def compute_mii(dfg: DFG, arch: CGRAArch, bank_of: Dict[int, int]
                ) -> Tuple[int, Dict[str, int]]:
    r = rec_mii(dfg)
    s = res_mii(dfg, arch, bank_of)
    fu_only = max(-(-dfg.n_nodes // arch.n_pes), r)
    return max(r, s), {"rec_mii": r, "res_mii": s, "fu_only_mii": fu_only}


# ----------------------------------------------------------------- mapping
@dataclass
class Mapping:
    dfg: DFG
    arch: CGRAArch
    II: int
    mii: int
    mii_parts: Dict[str, int]
    place: Dict[int, Tuple[int, int]]            # node -> (pe, abs time)
    routes: Dict[Tuple[int, int, int], Route]    # (src, dst, slot) -> route
    usage: Usage
    reg_assign: Dict[Tuple[int, int, int], int]  # (pe, value, t_start) -> reg
    lireg_assign: Dict[str, Tuple[int, int]]     # livein name -> (pe, index)
    bank_of: Dict[int, int]                      # mem node -> bank id

    @property
    def depth(self) -> int:
        return max(t for _pe, t in self.place.values()) + 2

    @property
    def utilization(self) -> float:
        return self.dfg.n_nodes / (self.arch.n_pes * self.II)

    def schedule_len(self, n_iters: int) -> int:
        """Cycles to run n_iters pipelined iterations (fill + steady + drain)."""
        return (n_iters - 1) * self.II + self.depth

    # --------------------------------------------------------- serialization
    def to_json_dict(self) -> dict:
        """JSON-able form of everything except dfg/arch (serialized by the
        artifact that owns this mapping)."""
        def route_dict(r: Route) -> dict:
            return {"value": r.value, "src_pe": r.src_pe, "t_src": r.t_src,
                    "dst_pe": r.dst_pe, "t_dst": r.t_dst,
                    "steps": [list(s) for s in r.steps],
                    "uses": [[list(k), list(i)] for k, i in r.uses]}

        return {
            "II": self.II, "mii": self.mii, "mii_parts": self.mii_parts,
            "place": [[v, pe, t] for v, (pe, t) in sorted(self.place.items())],
            "routes": [[src, dst, slot, route_dict(r)]
                       for (src, dst, slot), r in sorted(self.routes.items())],
            "usage": [[list(k), sorted(list(i) for i in insts)]
                      for k, insts in sorted(self.usage.map.items(),
                                             key=lambda kv: repr(kv[0]))],
            "reg_assign": [[pe, val, t, reg] for (pe, val, t), reg
                           in sorted(self.reg_assign.items())],
            "lireg_assign": {name: list(v)
                             for name, v in sorted(self.lireg_assign.items())},
            "bank_of": [[v, b] for v, b in sorted(self.bank_of.items())],
        }

    @staticmethod
    def from_json_dict(d: dict, dfg: DFG, arch: CGRAArch) -> "Mapping":
        def route_from(rd: dict) -> Route:
            return Route(value=rd["value"], src_pe=rd["src_pe"],
                         t_src=rd["t_src"], dst_pe=rd["dst_pe"],
                         t_dst=rd["t_dst"],
                         steps=[tuple(s) for s in rd["steps"]],
                         uses=[(tuple(k), tuple(i)) for k, i in rd["uses"]])

        usage = Usage(arch, d["II"])
        for k, insts in d["usage"]:
            for inst in insts:
                usage.add(tuple(k), tuple(inst))
        return Mapping(
            dfg=dfg, arch=arch, II=d["II"], mii=d["mii"],
            mii_parts=dict(d["mii_parts"]),
            place={v: (pe, t) for v, pe, t in d["place"]},
            routes={(src, dst, slot): route_from(rd)
                    for src, dst, slot, rd in d["routes"]},
            usage=usage,
            reg_assign={(pe, val, t): reg
                        for pe, val, t, reg in d["reg_assign"]},
            lireg_assign={name: tuple(v)
                          for name, v in d["lireg_assign"].items()},
            bank_of={v: b for v, b in d["bank_of"]},
        )


class MapError(RuntimeError):
    pass


DEBUG = False


def _dbg(*a):
    if DEBUG:
        print("[mapper]", *a, flush=True)


def _bank_of_nodes(dfg: DFG, layout: DataLayout) -> Dict[int, int]:
    out = {}
    for n in dfg.nodes.values():
        if n.is_mem:
            assert n.array.startswith("bank")
            out[n.id] = int(n.array[4:])
    return out


def _sccs(dfg: DFG) -> List[List[int]]:
    """Tarjan SCCs over the full dependence graph (any-dist data edges +
    memory deps).  Non-trivial SCCs = recurrence cycles."""
    succ: Dict[int, List[int]] = {i: [] for i in dfg.nodes}
    for src, dst, _s, _o in dfg.data_edges():
        succ[src].append(dst)
    for md in dfg.mem_deps:
        succ[md.src].append(md.dst)
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: Set[int] = set()
    stack: List[int] = []
    out: List[List[int]] = []
    counter = [0]

    def strong(v0: int) -> None:
        # iterative Tarjan
        work = [(v0, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack.add(v)
            recurse = False
            for i in range(pi, len(succ[v])):
                w = succ[v][i]
                if w not in index:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    for v in dfg.nodes:
        if v not in index:
            strong(v)
    return out


@dataclass
class _DFGInfo:
    """Per-DFG search invariants, computed once per compile and shared by
    every (II, seed) trial.  Everything here is II- and seed-independent;
    hoisting it out of ``_try_map`` keeps the portfolio's per-trial cost to
    the placement/routing search itself."""
    edges: List[Tuple[int, int, int, int]]     # (src, dst, lat, dist)
    cons: Dict[int, List[Tuple[int, int]]]     # consumers per node
    height: Dict[int, int]                     # dist-0 DAG height
    cyc_ids: List[int]                         # priority prefix (cycles)
    rest: List[int]                            # acyclic ids, dfg.nodes order
    self_loop: Set[int]                        # dist>0 self-loop sources
    multi_cycle: Set[int]                      # members of len>1 SCCs
    comps: List[List[int]]                     # len>1 SCCs
    rank: List[int]                            # condensation longest-path
    order_c: List[int]                         # comp placement order


def _dfg_info(dfg: DFG) -> _DFGInfo:
    order = dfg.topo_order()
    topo_pos = {v: i for i, v in enumerate(order)}
    cons = dfg.consumers()
    height = {i: 0 for i in dfg.nodes}
    for v in reversed(order):
        for c, _slot in cons[v]:
            if any(o.src == v and o.dist == 0 for o in dfg.nodes[c].operands):
                height[v] = max(height[v], height[c] + 1)

    self_loop = {src for src, dst, _s, o in dfg.data_edges()
                 if src == dst and o.dist > 0}
    sccs = _sccs(dfg)
    cyc_comps = [c for c in sccs
                 if len(c) > 1 or (len(c) == 1 and c[0] in self_loop)]
    # tightest (largest) cycles first; members in dataflow order so each
    # node lands next to its already-placed cycle neighbours
    cyc_comps.sort(key=len, reverse=True)
    cyc_ids: List[int] = []
    seen: Set[int] = set()
    for comp in cyc_comps:
        for v in sorted(comp, key=lambda v: topo_pos[v]):
            cyc_ids.append(v)
            seen.add(v)
    rest = [i for i in dfg.nodes if i not in seen]

    comps = [c for c in sccs if len(c) > 1]
    multi_cycle: Set[int] = set()
    for c in comps:
        multi_cycle.update(c)
    # condensation DAG: comp A -> comp B if a dist-0 path (through glue
    # nodes) leads from A into B; stagger start margins by longest-path
    # rank so glue nodes keep non-empty windows between dependent comps.
    comp_of: Dict[int, int] = {}
    for ci, c in enumerate(comps):
        for v in c:
            comp_of[v] = ci
    succ0: Dict[int, List[int]] = {i: [] for i in dfg.nodes}
    for s, d, _sl, o in dfg.data_edges():
        if o.dist == 0:
            succ0[s].append(d)
    comp_succ: Dict[int, Set[int]] = {ci: set() for ci in range(len(comps))}
    for ci, c in enumerate(comps):
        seen_n: Set[int] = set(c)
        stack = [d for v in c for d in succ0[v] if d not in seen_n]
        while stack:
            v = stack.pop()
            if v in seen_n:
                continue
            seen_n.add(v)
            cj = comp_of.get(v)
            if cj is not None and cj != ci:
                comp_succ[ci].add(cj)
                continue
            stack.extend(succ0[v])
    rank = [0] * len(comps)
    for _ in range(len(comps) + 1):          # longest-path fixpoint
        for ci in range(len(comps)):
            for cj in comp_succ[ci]:
                rank[cj] = max(rank[cj], rank[ci] + 1)
    order_c = sorted(range(len(comps)), key=lambda ci: (rank[ci],
                                                        -len(comps[ci])))
    return _DFGInfo(edges=_edges_with_memdeps(dfg), cons=cons, height=height,
                    cyc_ids=cyc_ids, rest=rest, self_loop=self_loop,
                    multi_cycle=multi_cycle, comps=comps, rank=rank,
                    order_c=order_c)


def _priorities(info: _DFGInfo, rng: random.Random) -> List[int]:
    """Recurrence-cycle nodes first (grouped per SCC, in dependence order),
    then the acyclic remainder by DAG height (seed-jittered tie-break)."""
    jitter = {i: rng.random() for i in info.rest}
    height = info.height
    rest = sorted(info.rest, key=lambda i: (-height[i], jitter[i]))
    return info.cyc_ids + rest


def _asap(dfg: DFG, II: int,
          edges: Optional[List[Tuple[int, int, int, int]]] = None
          ) -> Dict[int, int]:
    pot = {i: 0 for i in dfg.nodes}
    if edges is None:
        edges = _edges_with_memdeps(dfg)
    for _ in range(len(pot) + 1):
        changed = False
        for src, dst, lat, dist in edges:
            w = lat - II * dist
            if pot[src] + w > pot[dst]:
                pot[dst] = pot[src] + w
                changed = True
        if not changed:
            break
    base = -min(pot.values(), default=0)
    return {i: v + base for i, v in pot.items()}


def _try_map(dfg: DFG, arch: CGRAArch, II: int, seed: int,
             bank_of: Dict[int, int], info: Optional[_DFGInfo] = None,
             asap: Optional[Dict[int, int]] = None, window_factor: int = 3,
             ripup_budget: int = 60) -> Optional[Tuple[Dict, Dict, Usage]]:
    if info is None:
        info = _dfg_info(dfg)
    rng = random.Random(seed)
    order = _priorities(info, rng)
    if asap is None:
        asap = _asap(dfg, II, info.edges)
    # recurrence cycles are internally rigid; start them late enough that
    # their feeder chains (which accrue routing hops beyond the latency-only
    # ASAP estimate) fit underneath.
    # induction-variable self-loops are chain *sources*: keep them early so
    # downstream feeders retain routing-drift slack; multi-node recurrences
    # (accumulators) are chain *sinks*: start them late enough for feeders.
    multi_cycle = info.multi_cycle
    cycle_nodes = multi_cycle | info.self_loop
    margin = II + 4
    self_margin = 1
    usage = Usage(arch, II)
    dtab = usage.tables.dist
    place: Dict[int, Tuple[int, int]] = {}
    routes: Dict[Tuple[int, int, int], Route] = {}
    cons = info.cons

    def node_claims(n: Node, pe: int, t: int) -> List:
        claims = [(("fu", pe, t % II), (n.id, t))]
        if n.op != Op.STORE:
            claims.append((("fuout", pe, (t + n.lat) % II), (n.id, t + n.lat)))
        if n.is_mem:
            claims.append((("bank", bank_of[n.id], t % II), (n.id, t)))
        if n.op == Op.LIVEIN:
            claims.append((("lireg", pe), (n.livein, -1)))
        return claims

    def claims_free(claims) -> bool:
        return all(usage.free_for(k, i) for k, i in claims)

    def edge_jobs(v: int):
        """Edges between v and already-placed nodes, plus mem-dep checks."""
        jobs = []  # (src, dst, slot, dist)
        n = dfg.nodes[v]
        for slot, opnd in enumerate(n.operands):
            if opnd.src in place or opnd.src == v:
                jobs.append((opnd.src, v, slot, opnd.dist))
        for c, cslot in cons[v]:
            if c in place and c != v:
                d = dfg.nodes[c].operands[cslot].dist
                jobs.append((v, c, cslot, d))
        return jobs

    def memdep_ok(v: int, t: int) -> bool:
        for md in dfg.mem_deps:
            if md.src == v and md.dst in place:
                if place[md.dst][1] + II * md.dist < t + dfg.nodes[v].lat:
                    return False
            if md.dst == v and md.src in place:
                su = place[md.src][1]
                if t + II * md.dist < su + dfg.nodes[md.src].lat:
                    return False
        return True

    def unplace(v: int) -> None:
        if v not in place:
            return
        pe, t = place.pop(v)
        n = dfg.nodes[v]
        for k, i in node_claims(n, pe, t):
            usage.remove(k, i)
        for key in [k for k in routes if k[0] == v or k[1] == v]:
            release_route(usage, routes.pop(key))

    def try_place(v: int) -> bool:
        n = dfg.nodes[v]
        # time window
        t_lo = asap[v]
        if v in cycle_nodes and not any(
                o.src in place for o in n.operands if o.src != v) and not any(
                c in place for c, _ in cons[v] if c != v):
            # first node of its recurrence: leave feeder room
            t_lo += margin if v in multi_cycle else self_margin
        t_hi = t_lo + window_factor * II - 1
        succ_bound = False
        for slot, opnd in enumerate(n.operands):
            if opnd.src in place and opnd.src != v:
                su = place[opnd.src][1]
                t_lo = max(t_lo, su + dfg.nodes[opnd.src].lat - II * opnd.dist)
        for c, cslot in cons[v]:
            if c in place and c != v:
                d = dfg.nodes[c].operands[cslot].dist
                t_hi = min(t_hi, place[c][1] + II * d - n.lat)
                succ_bound = True
        if t_hi < t_lo:
            _dbg(f"node {v} ({n.name or n.op.value}): empty window "
                 f"[{t_lo},{t_hi}]")
            return False
        # PE candidates
        if n.is_mem:
            pes = [p for p in arch.pes_of_bank(bank_of[v])
                   if arch.supports(p, n.op)]
        else:
            pes = [p for p in range(arch.n_pes) if arch.supports(p, n.op)]
        if not pes:
            return False
        anchors = [place[o.src][0] for o in n.operands
                   if o.src in place and o.src != v]
        anchors += [place[c][0] for c, _ in cons[v] if c in place and c != v]

        # the anchor-distance lower bound depends only on the PE, not the
        # slot: one table-lookup sum per PE instead of one per candidate
        lb_pe = {pe: sum(dtab[pe][a] for a in anchors) for pe in pes}
        cands = []
        for t in range(t_lo, t_hi + 1):
            # feeders of placed consumers want to sit close to them (long
            # waits burn registers across pipelined iterations); nodes with
            # no placed consumer prefer the earliest slot.
            tbias = 0.25 * ((t_hi - t) if succ_bound else (t - t_lo))
            for pe in pes:
                cands.append((lb_pe[pe] + tbias + rng.random() * 0.1, t, pe))
        cands.sort()

        tried_routing = 0
        for _lb, t, pe in cands:
            if tried_routing >= 64:
                break
            if not memdep_ok(v, t):
                continue
            claims = node_claims(n, pe, t)
            if not claims_free(claims):
                continue
            for k, i in claims:
                usage.add(k, i)
            place[v] = (pe, t)
            tried_routing += 1
            new_routes: List[Tuple[Tuple[int, int, int], Route]] = []
            ok = True
            for src, dst, eslot, dist in edge_jobs(v):
                spe, st_ = place[src]
                dpe, dt = place[dst]
                r = route_value(usage, arch, II, src, spe,
                                st_ + dfg.nodes[src].lat, dpe, dt + II * dist)
                if r is None:
                    ok = False
                    break
                commit_route(usage, r)
                new_routes.append(((src, dst, eslot), r))
            if ok:
                for key, r in new_routes:
                    routes[key] = r
                return True
            for _key, r in new_routes:
                release_route(usage, r)
            for k, i in claims:
                usage.remove(k, i)
            del place[v]
        _dbg(f"node {v} ({n.name or n.op.value}): no feasible candidate in "
             f"window [{t_lo},{t_hi}] x {len(pes)} PEs, "
             f"{len(place)} placed")
        return False

    def place_comp_jointly(comp: List[int], extra_margin: int) -> bool:
        """Co-locate a recurrence SCC on one PE at internal ASAP offsets.
        Removes the tight-coupling failure mode of per-node greedy search
        (e.g. the load->acc->store output-stationary cycle at II=RecMII).
        extra_margin staggers dependent comps so the acyclic glue nodes
        between them (e.g. the AND feeding a coalesced-index select) keep
        non-empty scheduling windows."""
        comp_set = set(comp)
        # internal relative offsets: longest path inside the component
        off = {v: 0 for v in comp}
        intern = [(s, d, latency(dfg.nodes[s].op), o.dist)
                  for s, d, _sl, o in dfg.data_edges()
                  if s in comp_set and d in comp_set and s != d]
        intern += [(md.src, md.dst, latency(dfg.nodes[md.src].op), md.dist)
                   for md in dfg.mem_deps
                   if md.src in comp_set and md.dst in comp_set]
        for _ in range(len(comp) + 1):
            for s, d, lat, dist in intern:
                off[d] = max(off[d], off[s] + lat - II * dist)
        base0 = min(off.values())
        off = {v: o - base0 for v, o in off.items()}
        # candidate PEs must satisfy every member's op/bank constraint
        pes = []
        for p in range(arch.n_pes):
            ok = True
            for v in comp:
                n = dfg.nodes[v]
                if not arch.supports(p, n.op):
                    ok = False
                    break
                if n.is_mem and p not in arch.pes_of_bank(bank_of[v]):
                    ok = False
                    break
            if ok:
                pes.append(p)
        # prefer PEs near already-placed comps (their values flow here
        # through at most a couple of glue nodes)
        anchors = [pe for pe, _t in place.values()]
        if anchors:
            pes.sort(key=lambda p: (sum(dtab[p][a]
                                        for a in anchors) / len(anchors)
                                    + rng.random()))
        else:
            rng.shuffle(pes)
        t0_lo = max(asap[v] - off[v] for v in comp) + margin + extra_margin
        for t0 in range(t0_lo, t0_lo + window_factor * II):
            for p in pes:
                claims = []
                for v in comp:
                    claims.extend(node_claims(dfg.nodes[v], p, t0 + off[v]))
                if not all(usage.free_for(k, i) for k, i in claims):
                    continue
                for k, i in claims:
                    usage.add(k, i)
                for v in comp:
                    place[v] = (p, t0 + off[v])
                new_routes = []
                ok = True
                # internal edges + cross edges to previously-placed comps
                jobs = [(s, d, sl, o.dist) for s, d, sl, o in dfg.data_edges()
                        if (s in comp_set and d in comp_set)
                        or (s in comp_set and d in place and d not in comp_set)
                        or (d in comp_set and s in place and s not in comp_set)]
                for s, d, eslot, dist in jobs:
                    if s not in place or d not in place:
                        continue
                    r = route_value(usage, arch, II, s, place[s][0],
                                    place[s][1] + dfg.nodes[s].lat,
                                    place[d][0], place[d][1] + II * dist)
                    if r is None:
                        ok = False
                        break
                    commit_route(usage, r)
                    new_routes.append(((s, d, eslot), r))
                if ok:
                    for key, r in new_routes:
                        routes[key] = r
                    return True
                for _key, r in new_routes:
                    release_route(usage, r)
                for k, i in claims:
                    usage.remove(k, i)
                for v in comp:
                    del place[v]
        return False

    joint_done: Set[int] = set()
    comps, rank = info.comps, info.rank
    for ci in info.order_c:
        # routing drift accrues roughly linearly along the feeder chain:
        # scale each comp's start slack with its ASAP depth (plus the DAG
        # rank so sibling comps at equal depth still stagger).
        depth_slack = max(asap[v] for v in comps[ci])
        if place_comp_jointly(comps[ci],
                              extra_margin=depth_slack + 3 * rank[ci]):
            joint_done.update(comps[ci])
        # else: fall through to per-node placement for these nodes

    pending = deque(v for v in order if v not in joint_done)
    ripups = 0
    while pending:
        v = pending.popleft()
        if try_place(v):
            continue
        # rip-up: evict placed neighbours (and a random victim) and retry
        if ripups >= ripup_budget:
            return None
        ripups += 1
        n = dfg.nodes[v]
        vic: Set[int] = set()
        for o in n.operands:
            if o.src in place and o.src != v:
                vic.add(o.src)
        for c, _ in cons[v]:
            if c in place and c != v:
                vic.add(c)
        if place:
            vic.add(rng.choice(list(place)))
        vic -= joint_done  # jointly-placed recurrences stay put
        for w in vic:
            unplace(w)
        if not try_place(v):
            # place v first in an emptier context next round
            pending.appendleft(v)
        pending.extend(sorted(vic))
    return place, routes, usage


# ------------------------------------------------------- register coloring
def _color_registers(arch: CGRAArch, II: int,
                     routes: Dict[Tuple[int, int, int], Route]
                     ) -> Optional[Dict[Tuple[int, int, int], int]]:
    """Assign physical registers to residency intervals.

    Returns {(pe, value, t): reg_index} for every resident cycle t, or
    None if > R registers would be needed on some PE.
    """
    res: Dict[Tuple[int, int], Set[int]] = {}
    for r in routes.values():
        for kind, pe, t in r.steps:
            if kind == R:
                res.setdefault((pe, r.value), set()).add(t)
    intervals: Dict[int, List[Tuple[int, int, int]]] = {}  # pe -> [(a, b, val)]
    for (pe, val), ts in res.items():
        ts = sorted(ts)
        a = prev = ts[0]
        for t in ts[1:]:
            if t == prev + 1:
                prev = t
                continue
            intervals.setdefault(pe, []).append((a, prev, val))
            a = prev = t
        intervals.setdefault(pe, []).append((a, prev, val))

    assign: Dict[Tuple[int, int, int], int] = {}
    for pe, ivs in intervals.items():
        ivs.sort()
        slot_sets = []
        for a, b, val in ivs:
            assert b - a + 1 <= II, "residency longer than II"
            slot_sets.append(frozenset(t % II for t in range(a, b + 1)))
        regs_slots: List[Set[int]] = [set() for _ in range(arch.regfile_size)]
        # values may legitimately share a register across disjoint slots;
        # identical (value) intervals overlapping in slots collide.
        for (a, b, val), slots in zip(ivs, slot_sets):
            placed = False
            for ridx in range(arch.regfile_size):
                if not (regs_slots[ridx] & slots):
                    regs_slots[ridx] |= slots
                    for t in range(a, b + 1):
                        assign[(pe, val, t)] = ridx
                    placed = True
                    break
            if not placed:
                return None
    return assign


def _assign_liregs(arch: CGRAArch, dfg: DFG,
                   place: Dict[int, Tuple[int, int]]
                   ) -> Dict[str, Tuple[int, int]]:
    per_pe: Dict[int, List[str]] = {}
    out: Dict[str, Tuple[int, int]] = {}
    for n in dfg.nodes.values():
        if n.op == Op.LIVEIN:
            pe = place[n.id][0]
            names = per_pe.setdefault(pe, [])
            if n.livein not in names:
                names.append(n.livein)
            out[n.livein] = (pe, names.index(n.livein))
    for pe, names in per_pe.items():
        assert len(names) <= arch.livein_regs
    return out


def _portfolio_worker(payload: str) -> Optional[str]:
    """Process-pool worker for one (II, seed) trial.  Returns the mapping's
    canonical JSON dict (the exact bytes the sequential path would have
    serialized) or None when the trial is infeasible."""
    d = json.loads(payload)
    arch = CGRAArch.from_json(json.dumps(d["arch"]))
    dfg = DFG.from_json_dict(d["dfg"])
    bank_of = {v: b for v, b in d["bank_of"]}
    II, seed = d["II"], d["seed"]
    got = _try_map(dfg, arch, II, seed, bank_of)
    if got is None:
        return None
    place, routes, usage = got
    regs = _color_registers(arch, II, routes)
    if regs is None:
        return None
    mapping = Mapping(dfg=dfg, arch=arch, II=II, mii=d["mii"],
                      mii_parts=d["mii_parts"], place=place, routes=routes,
                      usage=usage, reg_assign=regs,
                      lireg_assign=_assign_liregs(arch, dfg, place),
                      bank_of=bank_of)
    return json.dumps(mapping.to_json_dict())


def map_kernel_opts(dfg: DFG, arch: CGRAArch, layout: DataLayout,
                    options: Optional[MapperOptions] = None, *,
                    portfolio: Optional[bool] = None) -> Mapping:
    """Map a DFG onto the CGRA: returns the first feasible Mapping,
    escalating II from MII (DRESC/Morpher semantics).

    Search runs as a *portfolio* over the candidate seeds of each II: the
    first seed runs in-process (the common fast path) while the remaining
    seeds race on the shared worker pool.  Selection is deterministic —
    the lowest feasible II wins, ties broken by the earliest seed in
    ``options.seeds`` order — so the result is bit-identical to the
    sequential search, which also serves as the fallback whenever process
    fan-out is unavailable (single core, nested workers, REPL drivers).
    ``portfolio=False`` (or ``MORPHER_PORTFOLIO=0``) forces sequential.

    This is the canonical mapper entry point; search limits come from one
    :class:`MapperOptions`.  Prefer `repro_torch.core.toolchain.Toolchain.compile`
    which adds configuration generation and artifact caching on top.
    """
    import os as _os
    import time as _time
    opt = options or MapperOptions()
    deadline = _time.time() + opt.time_budget_s if opt.time_budget_s else None
    dfg.validate()
    bank_of = _bank_of_nodes(dfg, layout)
    mii, parts = compute_mii(dfg, arch, bank_of)
    info = _dfg_info(dfg)
    start = max(mii, opt.ii_start or 0)
    # portfolio=True races unconditionally; auto mode races a round only
    # when its in-process seed-0 trial was expensive enough to amortize
    # the worker dispatch (cheap trials finish sequentially faster)
    force_pool = portfolio is True
    if portfolio is None:
        portfolio = _os.environ.get("MORPHER_PORTFOLIO", "1") != "0"
    use_pool = portfolio and len(opt.seeds) > 1
    min_trial_s = float(_os.environ.get("MORPHER_PORTFOLIO_MIN_TRIAL_S",
                                        "0.2"))

    def budget_left() -> Optional[float]:
        if deadline is None:
            return None
        left = deadline - _time.time()
        if left <= 0:
            raise MapError(f"{dfg.name}: time budget exhausted at "
                           f"II={II} (MII={mii})")
        return left

    def attempt(II: int, seed: int, asap: Dict[int, int]
                ) -> Optional[Mapping]:
        got = _try_map(dfg, arch, II, seed, bank_of, info, asap)
        if got is None:
            return None
        place, routes, usage = got
        regs = _color_registers(arch, II, routes)
        if regs is None:
            return None
        return Mapping(dfg=dfg, arch=arch, II=II, mii=mii,
                       mii_parts=parts, place=place, routes=routes,
                       usage=usage, reg_assign=regs,
                       lireg_assign=_assign_liregs(arch, dfg, place),
                       bank_of=bank_of)

    base_payload = None
    seeds = opt.seeds
    for II in range(start, opt.ii_max + 1):
        if not seeds:                          # degenerate options: no
            continue                           # trials, MapError below
        asap = _asap(dfg, II, info.edges)
        # the first seed always runs in-process: when it succeeds (the
        # common case) the compile pays zero fan-out overhead
        budget_left()
        t_trial = _time.time()
        m = attempt(II, seeds[0], asap)
        if m is not None:
            return m
        trial_cost = _time.time() - t_trial
        futs = None
        if use_pool and (force_pool or trial_cost >= min_trial_s):
            if base_payload is None:
                base_payload = {"dfg": dfg.to_json_dict(),
                                "arch": json.loads(arch.to_json()),
                                "bank_of": sorted(bank_of.items()),
                                "mii": mii, "mii_parts": parts}
            futs = submit_all(_portfolio_worker, [
                json.dumps({**base_payload, "II": II, "seed": s})
                for s in seeds[1:]])
        if futs is None:                       # sequential search
            for seed in seeds[1:]:
                budget_left()
                m = attempt(II, seed, asap)
                if m is not None:
                    return m
            continue
        # the remaining seeds race on the pool; consume results in seeds
        # order so the winner matches the sequential search
        try:
            for f, seed in zip(futs, seeds[1:]):
                out = f.result(timeout=budget_left())
                if out is not None:
                    m = Mapping.from_json_dict(json.loads(out), dfg, arch)
                    break
        except MapError:
            for f in futs:
                f.cancel()
            raise
        except (_FuturesTimeout, TimeoutError):
            for f in futs:
                f.cancel()
            raise MapError(f"{dfg.name}: time budget exhausted at "
                           f"II={II} (MII={mii})")
        except Exception:
            # broken pool / worker crash: finish this II sequentially
            # (seeds[0] already ran in-process) and drop back to the
            # sequential path for the remaining IIs
            reset_pool()
            use_pool = False
            for seed in seeds[1:]:
                budget_left()
                m = attempt(II, seed, asap)
                if m is not None:
                    return m
            continue
        for f in futs:
            f.cancel()
        if m is not None:
            return m
    raise MapError(f"{dfg.name}: no mapping found with II <= {opt.ii_max} "
                   f"(MII={mii}, parts={parts})")


def map_kernel(dfg: DFG, arch: CGRAArch, layout: DataLayout,
               ii_max: int = 32, seeds: Sequence[int] = (0, 1, 2, 3),
               ii_start: Optional[int] = None,
               time_budget_s: Optional[float] = None) -> Mapping:
    """Deprecated shim — use ``Toolchain.compile(spec)`` (or, for a bare
    DFG, :func:`map_kernel_opts` with a :class:`MapperOptions`).  Defaults
    mirror :class:`MapperOptions` exactly (``ii_max=32``)."""
    warnings.warn(
        "map_kernel(dfg, arch, layout, ii_max=..., ...) is deprecated; "
        "use repro_torch.core.toolchain.Toolchain.compile(spec) or "
        "map_kernel_opts(dfg, arch, layout, MapperOptions(...))",
        DeprecationWarning, stacklevel=2)
    return map_kernel_opts(dfg, arch, layout,
                           MapperOptions(ii_max=ii_max, seeds=tuple(seeds),
                                         ii_start=ii_start,
                                         time_budget_s=time_budget_s))
