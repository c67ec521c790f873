"""Seeded corruption harness: proves the checker's rules have teeth.

Every mutation class below takes a *clean* compiled kernel, applies one
realistic corruption to a clone of one of its artifacts (never the
original — simulated ``SimConfig``\\ s freeze their planes), and records
which rules fire.  The gate asserts each class is caught by its
*intended* rule id (extra rules co-firing is fine — one corruption can
violate several properties) and that the corpus mutation score is at
least :data:`MIN_SCORE`.

Any mutant the checker misses is cross-checked dynamically: if the
original and the mutant produce bit-identical final memory over the
probe seeds, the corrupted lane was dead (the mutation changed bits the
execution never observes) and the miss is a non-event, not a false
negative.  A live miss — observable corruption the checker waved
through — fails the gate outright.

Mutation sites are chosen with ``random.Random(seed_string)`` (string
seeding is process-stable), so the corpus is reproducible run-over-run
and across machines.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.config_gen import (KIND_FUOUT, KIND_IN_N, KIND_LIREG, KIND_NONE,
                               KIND_REG, MNEMONIC, OPC, OPC_LOAD, OPC_NONE,
                               OPC_STORE, SimConfig)
from ..core.dfg import Op
from ..core.mapper import Mapping

from .config import check_config
from .diagnostics import Diagnostic
from .mapping import check_mapping
from .report import errors
from .stream import check_stream

MIN_SCORE = 0.95

# mutation class -> (layer, intended rule id)
CLASSES: Dict[str, Tuple[str, str]] = {
    "mux_select":       ("config", "CFG-MUX-RANGE"),
    "store_window":     ("config", "CFG-STORE-WINDOW"),
    "bank_clobber":     ("config", "CFG-BANK-RANGE"),
    "rf_overcommit":    ("config", "CFG-RF-WPORTS"),
    "load_hazard":      ("config", "CFG-LOAD-HAZARD"),
    "opcode_clobber":   ("config", "CFG-OPC-RANGE"),
    "livein_clobber":   ("config", "CFG-LIVEIN"),
    "nbr_clobber":      ("config", "CFG-NBR"),
    "fu_alias":         ("mapping", "MAP-FU-OVERLAP"),
    "route_alias":      ("mapping", "MAP-ROUTE-OVERLAP"),
    "reg_clobber":      ("mapping", "MAP-REG-RANGE"),
    "op_unsupported":   ("mapping", "MAP-OP-SUPPORT"),
    "node_eject":       ("mapping", "MAP-NODE-RANGE"),
    "stream_truncate":  ("stream", "STR-PARSE"),
    "stream_select":    ("stream", "STR-SEL-RANGE"),
    "stream_opcode":    ("stream", "STR-OPC"),
    "stream_tstart":    ("stream", "STR-STORE-WINDOW"),
    "stream_bank":      ("stream", "STR-BANK-RANGE"),
}


@dataclass
class MutationOutcome:
    kernel: str
    cls: str
    layer: str
    intended_rule: str
    description: str
    caught: bool
    fired: List[str]
    dead: Optional[bool] = None      # only probed for missed mutants

    def to_json_dict(self) -> dict:
        return {"kernel": self.kernel, "class": self.cls,
                "layer": self.layer, "intended_rule": self.intended_rule,
                "description": self.description, "caught": self.caught,
                "fired": sorted(set(self.fired)), "dead": self.dead}


@dataclass
class CorpusReport:
    outcomes: List[MutationOutcome] = field(default_factory=list)

    @property
    def total(self) -> int:
        return len(self.outcomes)

    @property
    def caught(self) -> int:
        return sum(1 for o in self.outcomes if o.caught)

    @property
    def missed(self) -> List[MutationOutcome]:
        return [o for o in self.outcomes if not o.caught]

    @property
    def live_misses(self) -> List[MutationOutcome]:
        return [o for o in self.missed if o.dead is not True]

    @property
    def score(self) -> float:
        return self.caught / self.total if self.total else 1.0

    def by_class(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for o in self.outcomes:
            c = out.setdefault(o.cls, {"total": 0, "caught": 0, "dead": 0})
            c["total"] += 1
            c["caught"] += int(o.caught)
            c["dead"] += int(o.dead is True)
        return out

    def to_json_dict(self) -> dict:
        return {"total": self.total, "caught": self.caught,
                "score": round(self.score, 4),
                "by_class": self.by_class(),
                "outcomes": [o.to_json_dict() for o in self.outcomes]}


# ------------------------------------------------------------------ clones
def _clone_cfg(cfg: SimConfig) -> SimConfig:
    # JSON round-trip: fresh writable planes (a simulated config's planes
    # are frozen read-only by the host-plane cache)
    return SimConfig.from_json(cfg.to_json())


def _clone_mapping(ck) -> Mapping:
    return Mapping.from_json_dict(ck.mapping.to_json_dict(), ck.dfg, ck.arch)


# --------------------------------------------------------- config mutators
# each returns (mutated object, description) or None when the kernel has
# no site for this class (e.g. no loads, II == 1)

def _mut_mux_select(ck, rng) -> Optional[Tuple[SimConfig, str]]:
    cfg = _clone_cfg(ck.cfg)
    sites = [(s, p, o) for s in range(cfg.II) for p in range(cfg.P)
             for o in range(3) if cfg.src_kind[s, p, o] != KIND_NONE]
    if not sites:
        return None
    s, p, o = rng.choice(sites)
    variant = rng.randrange(3)
    if variant == 0:
        # dangle the select off the register file
        cfg.src_kind[s, p, o] = KIND_REG
        cfg.src_idx[s, p, o] = cfg.RF + rng.randrange(1, 4)
        what = f"op{o} -> reg{int(cfg.src_idx[s, p, o])} (RF={cfg.RF})"
    elif variant == 1:
        # invalid select kind entirely
        cfg.src_kind[s, p, o] = 17 + rng.randrange(4)
        what = f"op{o} -> kind {int(cfg.src_kind[s, p, o])}"
    else:
        # read through a missing neighbour wire, if the fabric has one
        missing = [(pp, di) for pp in range(cfg.P) for di in range(4)
                   if not bool(cfg.nbr_ok[pp, di])]
        if not missing:
            cfg.src_kind[s, p, o] = KIND_REG
            cfg.src_idx[s, p, o] = cfg.RF + 1
            what = f"op{o} -> reg{cfg.RF + 1} (RF={cfg.RF})"
        else:
            p, di = rng.choice(missing)
            o = rng.randrange(3)
            cfg.src_kind[s, p, o] = KIND_IN_N + di
            cfg.src_idx[s, p, o] = 0
            what = f"op{o} reads missing neighbour wire dir{di} on pe{p}"
    return cfg, f"slot{s}/pe{p}: {what}"


def _mut_store_window(ck, rng) -> Optional[Tuple[SimConfig, str]]:
    cfg = _clone_cfg(ck.cfg)
    sites = [(s, p) for s in range(cfg.II) for p in range(cfg.P)
             if cfg.op[s, p] == OPC_STORE]
    if not sites:
        sites = [(s, p) for s in range(cfg.II) for p in range(cfg.P)
                 if cfg.op[s, p] != OPC_NONE]
    if not sites:
        return None
    s, p = rng.choice(sites)
    old = int(cfg.valid_start[s, p])
    if cfg.II > 1 and rng.random() < 0.5:
        cfg.valid_start[s, p] = old + 1          # off its II slot
    else:
        cfg.valid_start[s, p] = -(old + 1)       # before the schedule
    return cfg, (f"slot{s}/pe{p}: window start {old} -> "
                 f"{int(cfg.valid_start[s, p])}")


def _mut_bank_clobber(ck, rng) -> Optional[Tuple[SimConfig, str]]:
    cfg = _clone_cfg(ck.cfg)
    sites = [(s, p) for s in range(cfg.II) for p in range(cfg.P)
             if cfg.op[s, p] in (OPC_LOAD, OPC_STORE)]
    if not sites:
        return None
    s, p = rng.choice(sites)
    if rng.random() < 0.5:
        cfg.mem_off[s, p] = int(cfg.mem_off[s, p]) + rng.randrange(1, 4)
        what = f"mem_off -> {int(cfg.mem_off[s, p])}"
    else:
        cfg.mem_words[s, p] = int(cfg.mem_words[s, p]) - rng.randrange(1, 4)
        what = f"mem_words -> {int(cfg.mem_words[s, p])}"
    return cfg, f"slot{s}/pe{p}: {what}"


def _mut_rf_overcommit(ck, rng) -> Optional[Tuple[SimConfig, str]]:
    cfg = _clone_cfg(ck.cfg)
    ports = ck.arch.rf_write_ports
    if cfg.RF <= ports:
        return None
    s = rng.randrange(cfg.II)
    p = rng.randrange(cfg.P)
    for r in range(ports + 1):
        cfg.rf_kind[s, p, r] = KIND_FUOUT
        cfg.rf_idx[s, p, r] = 0
    return cfg, (f"slot{s}/pe{p}: {ports + 1} simultaneous RF writes "
                 f"(ports={ports})")


def _mut_load_hazard(ck, rng) -> Optional[Tuple[SimConfig, str]]:
    cfg = _clone_cfg(ck.cfg)
    if cfg.II <= 1:
        return None
    sites = []
    for s in range(cfg.II):
        for p in range(cfg.P):
            if cfg.op[s, p] == OPC_LOAD \
                    and cfg.op[(s + 1) % cfg.II, p] == OPC_NONE:
                sites.append((s, p))
    if not sites:
        return None
    s, p = rng.choice(sites)
    nxt = (s + 1) % cfg.II
    cfg.op[nxt, p] = OPC[Op.ADD]
    cfg.valid_start[nxt, p] = nxt        # keep the window itself legal
    return cfg, (f"slot{nxt}/pe{p}: add scheduled in the shadow of the "
                 f"load at slot {s}")


def _mut_opcode_clobber(ck, rng) -> Optional[Tuple[SimConfig, str]]:
    cfg = _clone_cfg(ck.cfg)
    sites = [(s, p) for s in range(cfg.II) for p in range(cfg.P)
             if cfg.op[s, p] != OPC_NONE]
    if not sites:
        return None
    s, p = rng.choice(sites)
    cfg.op[s, p] = max(MNEMONIC) + 1 + rng.randrange(16)
    return cfg, f"slot{s}/pe{p}: opcode -> {int(cfg.op[s, p])}"


def _mut_livein_clobber(ck, rng) -> Optional[Tuple[SimConfig, str]]:
    cfg = _clone_cfg(ck.cfg)
    reads = [(s, p, o) for s in range(cfg.II) for p in range(cfg.P)
             for o in range(3) if cfg.src_kind[s, p, o] == KIND_LIREG]
    if not reads or not cfg.lireg_assign:
        return None
    s, p, o = rng.choice(reads)
    # drop the host initialization the read depends on
    victims = [name for name, (pe, idx) in sorted(cfg.lireg_assign.items())
               if (pe, idx) == (p, int(cfg.src_idx[s, p, o]))]
    if not victims:
        return None
    del cfg.lireg_assign[victims[0]]
    victim = victims[0]
    return cfg, (f"slot{s}/pe{p}: live-in {victim!r} no longer "
                 f"host-initialized but still read by op{o}")


def _mut_nbr_clobber(ck, rng) -> Optional[Tuple[SimConfig, str]]:
    cfg = _clone_cfg(ck.cfg)
    p = rng.randrange(cfg.P)
    di = rng.randrange(4)
    cfg.nbr_ok[p, di] = not bool(cfg.nbr_ok[p, di])
    return cfg, f"pe{p}: neighbour wire dir{di} flipped"


# -------------------------------------------------------- mapping mutators
def _mut_fu_alias(ck, rng) -> Optional[Tuple[Mapping, str]]:
    m = _clone_mapping(ck)
    II = m.II
    by_slot: Dict[int, List[int]] = {}
    for nid, (pe, t) in sorted(m.place.items()):
        by_slot.setdefault(t % II, []).append(nid)
    pairs = [(a, b) for nids in by_slot.values()
             for a in nids for b in nids
             if a != b and m.place[a][0] != m.place[b][0]]
    if not pairs:
        return None
    a, b = rng.choice(pairs)
    pe_a = m.place[a][0]
    t_b = m.place[b][1]
    m.place[b] = (pe_a, t_b)
    return m, f"node{b} moved onto node{a}'s FU at pe{pe_a}"


def _mut_route_alias(ck, rng) -> Optional[Tuple[Mapping, str]]:
    m = _clone_mapping(ck)
    keys = sorted(m.routes)
    donors = [k for k in keys
              if any(m.routes[k].steps[i][1] != m.routes[k].steps[i + 1][1]
                     for i in range(len(m.routes[k].steps) - 1))]
    if not donors:
        return None
    dk = rng.choice(donors)
    donor = m.routes[dk]
    victims = [k for k in keys if m.routes[k].value != donor.value]
    if not victims:
        return None
    vk = rng.choice(victims)
    m.routes[vk].steps = [tuple(s) for s in donor.steps]
    return m, (f"route({vk[0]}->{vk[1]}#{vk[2]}) aliased onto "
               f"route({dk[0]}->{dk[1]}#{dk[2]})'s steps")


def _mut_reg_clobber(ck, rng) -> Optional[Tuple[Mapping, str]]:
    m = _clone_mapping(ck)
    if not m.reg_assign:
        return None
    key = rng.choice(sorted(m.reg_assign))
    m.reg_assign[key] = m.arch.regfile_size + rng.randrange(1, 4)
    pe, val, t = key
    return m, (f"value v{val} at pe{pe} t{t} colored into "
               f"r{m.reg_assign[key]}")


def _mut_op_unsupported(ck, rng) -> Optional[Tuple[Mapping, str]]:
    m = _clone_mapping(ck)
    off_bus = sorted(set(range(m.arch.n_pes)) - set(m.arch.mem_pes))
    mem_nodes = [nid for nid in sorted(m.place) if m.dfg.nodes[nid].is_mem]
    if not off_bus or not mem_nodes:
        return None
    nid = rng.choice(mem_nodes)
    pe = rng.choice(off_bus)
    m.place[nid] = (pe, m.place[nid][1])
    return m, f"memory node{nid} moved off the bus onto pe{pe}"


def _mut_node_eject(ck, rng) -> Optional[Tuple[Mapping, str]]:
    m = _clone_mapping(ck)
    nid = rng.choice(sorted(m.place))
    m.place[nid] = (m.arch.n_pes + rng.randrange(1, 4), m.place[nid][1])
    return m, f"node{nid} placed outside the grid at pe{m.place[nid][0]}"


# --------------------------------------------------------- stream mutators
# each returns ((csv_text, manifest), description)

def _stream_pair(ck) -> Tuple[str, dict]:
    from ..isa.encode import manifest_dict, to_csv
    return to_csv(ck.cfg), manifest_dict(ck.cfg, ck.name)


def _mut_stream_truncate(ck, rng) -> Optional[Tuple[Tuple[str, dict], str]]:
    csv_text, manifest = _stream_pair(ck)
    lines = csv_text.splitlines()
    k = rng.randrange(1, min(4, len(lines) - 1))
    return ("\n".join(lines[:-k]) + "\n", manifest), f"last {k} record(s) dropped"


def _pick_row(lines: List[str], rng, pred: Callable[[List[str]], bool]
              ) -> Optional[int]:
    rows = [i for i in range(1, len(lines)) if pred(lines[i].split(","))]
    return rng.choice(rows) if rows else None


def _mut_stream_select(ck, rng) -> Optional[Tuple[Tuple[str, dict], str]]:
    csv_text, manifest = _stream_pair(ck)
    lines = csv_text.splitlines()
    header = lines[0].split(",")
    sel_names = {"op0", "op1", "op2"} | {f"xo_{d}" for d in "nesw"} \
        | {f"rf{r}" for r in range(int(manifest["RF"]))}
    op_cols = [i for i, c in enumerate(header) if c in sel_names]
    sites = [(r, c) for r in range(1, len(lines))
             for c in op_cols if lines[r].split(",")[c] != "none"]
    if not sites:
        return None
    r, c = rng.choice(sites)
    rec = lines[r].split(",")
    old = rec[c]
    rec[c] = rng.choice([f"reg{int(manifest['RF']) + 5}", "fu3", "warp"])
    lines[r] = ",".join(rec)
    return (("\n".join(lines) + "\n", manifest),
            f"{header[c]} {old!r} -> {rec[c]!r}")


def _mut_stream_opcode(ck, rng) -> Optional[Tuple[Tuple[str, dict], str]]:
    csv_text, manifest = _stream_pair(ck)
    lines = csv_text.splitlines()
    header = lines[0].split(",")
    oc = header.index("opcode")
    r = _pick_row(lines, rng, lambda rec: rec[oc] != "nop")
    if r is None:
        return None
    rec = lines[r].split(",")
    old = rec[oc]
    rec[oc] = "frob"
    lines[r] = ",".join(rec)
    return (("\n".join(lines) + "\n", manifest), f"opcode {old!r} -> 'frob'")


def _mut_stream_tstart(ck, rng) -> Optional[Tuple[Tuple[str, dict], str]]:
    csv_text, manifest = _stream_pair(ck)
    lines = csv_text.splitlines()
    header = lines[0].split(",")
    oc, tc = header.index("opcode"), header.index("tstart")
    r = _pick_row(lines, rng, lambda rec: rec[oc] != "nop")
    if r is None:
        return None
    rec = lines[r].split(",")
    old = int(rec[tc])
    # +1 knocks the window off its II slot; with II == 1 that stays legal,
    # so push it before the schedule instead
    rec[tc] = str(old + 1 if int(manifest["II"]) > 1 else -(old + 1))
    lines[r] = ",".join(rec)
    return (("\n".join(lines) + "\n", manifest),
            f"tstart {old} -> {rec[tc]}")


def _mut_stream_bank(ck, rng) -> Optional[Tuple[Tuple[str, dict], str]]:
    csv_text, manifest = _stream_pair(ck)
    lines = csv_text.splitlines()
    header = lines[0].split(",")
    oc, mc = header.index("opcode"), header.index("mem_off")
    r = _pick_row(lines, rng, lambda rec: rec[oc] in ("load", "store"))
    if r is None:
        return None
    rec = lines[r].split(",")
    old = int(rec[mc])
    rec[mc] = str(old + rng.randrange(1, 4))
    lines[r] = ",".join(rec)
    return (("\n".join(lines) + "\n", manifest),
            f"mem_off {old} -> {rec[mc]}")


_MUTATORS: Dict[str, Callable] = {
    "mux_select": _mut_mux_select,
    "store_window": _mut_store_window,
    "bank_clobber": _mut_bank_clobber,
    "rf_overcommit": _mut_rf_overcommit,
    "load_hazard": _mut_load_hazard,
    "opcode_clobber": _mut_opcode_clobber,
    "livein_clobber": _mut_livein_clobber,
    "nbr_clobber": _mut_nbr_clobber,
    "fu_alias": _mut_fu_alias,
    "route_alias": _mut_route_alias,
    "reg_clobber": _mut_reg_clobber,
    "op_unsupported": _mut_op_unsupported,
    "node_eject": _mut_node_eject,
    "stream_truncate": _mut_stream_truncate,
    "stream_select": _mut_stream_select,
    "stream_opcode": _mut_stream_opcode,
    "stream_tstart": _mut_stream_tstart,
    "stream_bank": _mut_stream_bank,
}


def mutate_one(ck, cls: str, seed: int = 0, index: int = 0):
    """One seeded mutant of ``ck`` for mutation class ``cls``; returns
    (mutated artifact, description) or None when the kernel offers no
    site for this class (no loads, II == 1, ...)."""
    rng = random.Random(f"{seed}:{ck.name}:{cls}:{index}")
    return _MUTATORS[cls](ck, rng)


def _check_mutant(ck, layer: str, artifact) -> List[Diagnostic]:
    if layer == "config":
        return errors(check_config(artifact, ck.arch))
    if layer == "mapping":
        return errors(check_mapping(artifact))
    csv_text, manifest = artifact
    return errors(check_stream(csv_text, manifest,
                               rf_write_ports=ck.arch.rf_write_ports))


def _probe_dead(ck, layer: str, artifact, seeds=(0, 1),
                device=None) -> bool:
    """True iff the mutant is execution-equivalent to the original over
    the probe seeds (a dead lane) — the only acceptable excuse for a
    checker miss.  Config mutants simulate on ``device`` (``None``: the
    CUDA card); stream mutants run through the host interpreter."""
    try:
        if layer == "config":
            from ..core.simulator import simulate
            for seed in seeds:
                banks = ck.random_banks(seed)
                ref = simulate(ck.cfg, banks, ck.invocations, ck.mapped_iters,
                               device=device)
                got = simulate(artifact, banks, ck.invocations,
                               ck.mapped_iters, device=device)
                for k in ref:
                    if not np.array_equal(np.asarray(ref[k]),
                                          np.asarray(got[k])):
                        return False
            return True
        if layer == "stream":
            from ..isa.interp import interpret, parse_stream
            from ..isa.encode import manifest_dict, to_csv
            orig = parse_stream(to_csv(ck.cfg), manifest_dict(ck.cfg, ck.name))
            mut = parse_stream(*artifact)
            for seed in seeds:
                banks = ck.random_banks(seed)
                ref = interpret(orig, banks, ck.invocations, ck.mapped_iters)
                got = interpret(mut, banks, ck.invocations, ck.mapped_iters)
                for k in ref:
                    if not np.array_equal(np.asarray(ref[k]),
                                          np.asarray(got[k])):
                        return False
            return True
        # mapping layer: regenerate the config; identical bytes mean the
        # corruption never reaches an executable artifact
        from ..core.config_gen import generate_config
        cfg = generate_config(artifact, ck.layout)
        return cfg.to_json() == ck.cfg.to_json()
    except Exception:
        # the mutant does not even execute/regenerate: visibly corrupt,
        # hence a live miss
        return False


def run_corpus(cks, seed: int = 0, per_class: int = 2,
               probe_dead: bool = True, device=None) -> CorpusReport:
    """The full corpus over ``cks``: ``per_class`` seeded mutants of every
    class for every kernel (classes without a site on a kernel are
    skipped, not counted).  Dead-mutant probes simulate on ``device``
    (``None``: the CUDA card)."""
    report = CorpusReport()
    for ck in cks:
        for cls in CLASSES:
            layer, intended = CLASSES[cls]
            for i in range(per_class):
                made = mutate_one(ck, cls, seed=seed, index=i)
                if made is None:
                    break
                artifact, desc = made
                fired = [d.rule for d in _check_mutant(ck, layer, artifact)]
                caught = intended in fired
                dead = None
                if not caught and probe_dead:
                    dead = _probe_dead(ck, layer, artifact, device=device)
                report.outcomes.append(MutationOutcome(
                    kernel=ck.name, cls=cls, layer=layer,
                    intended_rule=intended, description=desc,
                    caught=caught, fired=fired, dead=dead))
    return report


def mutation_gate(cks, seed: int = 0, per_class: int = 2,
                  min_score: float = MIN_SCORE,
                  device=None) -> CorpusReport:
    """Run the corpus and enforce the acceptance bar: score >=
    ``min_score``, every class caught at least once by its intended rule,
    and no live (simulator-visible) miss.  Probes simulate on ``device``
    (``None``: the CUDA card).  Raises AssertionError with the offending
    outcomes; returns the report."""
    report = run_corpus(cks, seed=seed, per_class=per_class, device=device)
    problems: List[str] = []
    if report.score < min_score:
        problems.append(f"mutation score {report.score:.3f} < {min_score}")
    produced = {o.cls for o in report.outcomes}
    for cls in produced:
        if not any(o.caught for o in report.outcomes if o.cls == cls):
            problems.append(f"class {cls!r} never caught by its intended "
                            f"rule {CLASSES[cls][1]}")
    for o in report.live_misses:
        problems.append(f"LIVE MISS {o.kernel}/{o.cls}: {o.description} "
                        f"(fired: {sorted(set(o.fired))})")
    if problems:
        raise AssertionError("mutation gate failed:\n  " +
                             "\n  ".join(problems))
    return report
