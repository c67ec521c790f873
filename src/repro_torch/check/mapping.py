"""Mapping legality: audit a :class:`~repro_torch.core.mapper.Mapping` against
its DFG and :class:`~repro_torch.core.adl.CGRAArch` without touching the mapper's
own ``usage`` bookkeeping.

The checker re-derives every resource claim from first principles — the
placement table, the route step lists and the topology tables — and then
applies the MRRG capacity model (fu/fuout/xo/bank are exclusive per
II-slot, register pools hold ``regfile_size`` values, ``rf_write_ports``
writes per cycle, one live-in register per name).  Fan-out sharing is
honoured exactly as in the router: identical ``(value, abs_time)``
instances may share a resource cell; distinct instances on a capacity-1
cell are a conflict.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ..core.adl import DIRS
from ..core.dfg import Op, latency
from ..core.router import F, R

from .diagnostics import Diagnostic, ERROR, cell_locus, sort_diagnostics

Inst = Tuple[int, int]


def check_mapping(mapping) -> List[Diagnostic]:
    """Audit mapping legality; returns sorted diagnostics (empty = legal)."""
    diags: List[Diagnostic] = []
    dfg, arch, II = mapping.dfg, mapping.arch, mapping.II
    P = arch.n_pes
    place = mapping.place
    bank_ids = {b.id for b in arch.banks}

    def err(rule: str, locus: str, message: str):
        diags.append(Diagnostic(rule, ERROR, locus, message))

    # re-derived occupancy: typed resource key -> set of (value, abs_t)
    occ: Dict[Tuple, Set[Inst]] = {}

    def claim(key: Tuple, inst: Inst):
        occ.setdefault(key, set()).add(inst)

    # ------------------------------------------------------------ placement
    for nid in sorted(dfg.nodes):
        node = dfg.nodes[nid]
        locus = f"node{nid}"
        if nid not in place:
            err("MAP-NODE-RANGE", locus, "node has no placement")
            continue
        pe, t = place[nid]
        if not (0 <= pe < P) or t < 0:
            err("MAP-NODE-RANGE", locus,
                f"placed at pe{pe} t{t}, outside the {P}-PE grid / schedule")
            continue
        if not arch.supports(pe, node.op):
            err("MAP-OP-SUPPORT", locus,
                f"op {node.op.name} is not supported by pe{pe}'s FU")
        claim(("fu", pe, t % II), (nid, t))
        if node.op is not Op.STORE:
            tf = t + node.lat
            claim(("fuout", pe, tf % II), (nid, tf))
        if node.is_mem:
            b = mapping.bank_of.get(nid)
            if b is None or b not in bank_ids:
                err("MAP-BANK-BUS", locus, f"bound to unknown bank {b}")
            else:
                if pe not in arch.bank(b).pes:
                    err("MAP-BANK-BUS", locus,
                        f"pe{pe} is not on bank{b}'s shared bus")
                claim(("bank", b, t % II), (nid, t))
        if node.op is Op.LIVEIN:
            asn = mapping.lireg_assign.get(node.livein)
            if asn is None:
                err("MAP-LIREG", locus,
                    f"live-in {node.livein!r} has no register assignment")
            elif asn[0] != pe:
                err("MAP-LIREG", locus,
                    f"live-in {node.livein!r} assigned to pe{asn[0]} but the "
                    f"node is placed on pe{pe}")

    # live-in register file: per-PE capacity and double-booking
    lireg_cells: Dict[Tuple[int, int], List[str]] = {}
    per_pe_names: Dict[int, Set[str]] = {}
    for name in sorted(mapping.lireg_assign):
        pe, idx = mapping.lireg_assign[name]
        locus = f"livein({name})"
        if not (0 <= pe < P) or not (0 <= idx < max(1, arch.livein_regs)):
            err("MAP-LIREG", locus,
                f"assignment (pe{pe}, li{idx}) outside the fabric's "
                f"{arch.livein_regs} live-in registers")
            continue
        lireg_cells.setdefault((pe, idx), []).append(name)
        per_pe_names.setdefault(pe, set()).add(name)
    for (pe, idx), names in sorted(lireg_cells.items()):
        if len(names) > 1:
            err("MAP-LIREG", f"pe{pe}/li{idx}",
                f"live-in register double-booked by {names}")
    for pe, names in sorted(per_pe_names.items()):
        if len(names) > arch.livein_regs:
            err("MAP-LIREG", f"pe{pe}",
                f"{len(names)} live-ins assigned but only "
                f"{arch.livein_regs} live-in registers exist")

    # ----------------------------------------------------- routes and edges
    routed = set(mapping.routes)
    for src, dst, slot, opnd in dfg.data_edges():
        if (src, dst, slot) not in routed:
            err("MAP-ROUTE-CONT", f"route({src}->{dst}#{slot})",
                "data edge has no route")

    for (src, dst, eslot) in sorted(mapping.routes):
        r = mapping.routes[(src, dst, eslot)]
        locus = f"route({src}->{dst}#{eslot})"
        # endpoint consistency with the placement / schedule
        if src in place and dst in place and src in dfg.nodes \
                and dst in dfg.nodes:
            spe, st = place[src]
            dpe, dt = place[dst]
            opnds = dfg.nodes[dst].operands
            dist = opnds[eslot].dist if eslot < len(opnds) else 0
            exp_tsrc = st + latency(dfg.nodes[src].op)
            exp_tdst = dt + II * dist
            if (r.value != src or r.src_pe != spe or r.t_src != exp_tsrc
                    or r.dst_pe != dpe or r.t_dst != exp_tdst):
                err("MAP-ROUTE-CONT", locus,
                    f"endpoints (v{r.value} pe{r.src_pe}@t{r.t_src} -> "
                    f"pe{r.dst_pe}@t{r.t_dst}) disagree with the schedule "
                    f"(v{src} pe{spe}@t{exp_tsrc} -> pe{dpe}@t{exp_tdst})")
        steps = r.steps
        if not steps:
            err("MAP-ROUTE-CONT", locus, "route has no steps")
            continue
        if tuple(steps[0]) != (F, r.src_pe, r.t_src):
            err("MAP-ROUTE-CONT", locus,
                f"first step {tuple(steps[0])} is not the fresh source "
                f"state (pe{r.src_pe}, t{r.t_src})")
        if steps[-1][1] != r.dst_pe or steps[-1][2] != r.t_dst:
            err("MAP-ROUTE-CONT", locus,
                f"last step {tuple(steps[-1])} does not reach the consumer "
                f"at (pe{r.dst_pe}, t{r.t_dst})")
        for i in range(len(steps) - 1):
            k0, p0, t0 = steps[i]
            k1, p1, t1 = steps[i + 1]
            if t1 != t0 + 1:
                err("MAP-ROUTE-CONT", locus,
                    f"step {i}: time jumps t{t0} -> t{t1}")
                continue
            if not (0 <= p0 < P and 0 <= p1 < P):
                err("MAP-ROUTE-CONT", locus,
                    f"step {i}: pe{p0} -> pe{p1} outside the grid")
                continue
            if p1 != p0:
                # crossbar hop: must land on an adjacent PE, fresh
                if k1 != F:
                    err("MAP-ROUTE-CONT", locus,
                        f"step {i}: hop pe{p0} -> pe{p1} must arrive fresh")
                di = next((j for j, d in enumerate(DIRS)
                           if arch.neighbor(p0, d) == p1), None)
                if di is None:
                    err("MAP-ROUTE-ADJ", locus,
                        f"step {i}: pe{p0} and pe{p1} are not adjacent")
                else:
                    claim(("xo", p0, di, t0 % II), (r.value, t0))
            else:
                if k1 == R:
                    # register hold; entering from F costs a write port
                    claim(("regpool", p0, t1 % II), (r.value, t1))
                    if k0 == F:
                        claim(("wr", p0, t0 % II), (r.value, t0))
                else:
                    err("MAP-ROUTE-CONT", locus,
                        f"step {i}: illegal same-PE transition "
                        f"{'F' if k0 == F else 'R'}->F at pe{p0} t{t0}")
        # register-resident steps must be colored into physical registers
        for (k, p, t) in steps:
            if k != R:
                continue
            ridx = mapping.reg_assign.get((p, r.value, t))
            if ridx is None:
                err("MAP-REG-RANGE", locus,
                    f"register-resident at pe{p} t{t} but no register "
                    f"assignment exists")
            elif not (0 <= ridx < arch.regfile_size):
                err("MAP-REG-RANGE", locus,
                    f"value v{r.value} at pe{p} t{t} colored into r{ridx}, "
                    f"outside the {arch.regfile_size}-entry register file")
            else:
                claim(("reg", p, ridx, t % II), (r.value, t))

    # --------------------------------------------- capacity over re-derived occ
    rule_by_kind = {"fu": "MAP-FU-OVERLAP", "fuout": "MAP-FU-OVERLAP",
                    "xo": "MAP-ROUTE-OVERLAP", "reg": "MAP-ROUTE-OVERLAP",
                    "regpool": "MAP-ROUTE-OVERLAP",
                    "wr": "MAP-ROUTE-OVERLAP", "bank": "MAP-BANK-PORT"}
    for key in sorted(occ, key=repr):
        insts = occ[key]
        kind = key[0]
        if kind == "regpool":
            cap = arch.regfile_size
        elif kind == "wr":
            cap = arch.rf_write_ports
        else:
            cap = 1
        if len(insts) <= cap:
            continue
        who = sorted(insts)[:4]
        if kind == "fu":
            _, pe, slot = key
            err("MAP-FU-OVERLAP", cell_locus(slot, pe),
                f"{len(insts)} nodes issue on one FU slot: {who}")
        elif kind == "fuout":
            _, pe, slot = key
            err("MAP-FU-OVERLAP", cell_locus(slot, pe),
                f"{len(insts)} results land in one FU output register "
                f"slot: {who}")
        elif kind == "bank":
            _, b, slot = key
            err("MAP-BANK-PORT", f"slot{slot}/bank{b}",
                f"{len(insts)} memory nodes share bank{b}'s port: {who}")
        elif kind == "xo":
            _, pe, di, slot = key
            err("MAP-ROUTE-OVERLAP", cell_locus(slot, pe),
                f"{len(insts)} values share the {DIRS[di]} crossbar "
                f"port: {who}")
        elif kind == "reg":
            _, pe, ridx, slot = key
            err("MAP-ROUTE-OVERLAP", cell_locus(slot, pe),
                f"{len(insts)} values colored into register r{ridx}: {who}")
        elif kind == "regpool":
            _, pe, slot = key
            err("MAP-ROUTE-OVERLAP", cell_locus(slot, pe),
                f"{len(insts)} live values exceed the "
                f"{arch.regfile_size}-entry register pool")
        elif kind == "wr":
            _, pe, slot = key
            err("MAP-ROUTE-OVERLAP", cell_locus(slot, pe),
                f"{len(insts)} RF writes exceed {arch.rf_write_ports} "
                f"write ports")

    return sort_diagnostics(diags)
