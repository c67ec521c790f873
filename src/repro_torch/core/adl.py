"""Architecture Description Language (ADL) for CGRAs.

Analogue of Morpher's JSON ADL (paper Fig. 3 piece 2 / section III).  A
``CGRAArch`` captures everything the mapper, configuration generator and
simulator need:

  * an R x C grid of PEs, each with a functional unit (op set), a small
    routing register file, four registered crossbar output ports (N/E/S/W)
    and a live-in scalar register file pre-loaded by the host,
  * multi-banked data memories attached to boundary PEs via shared buses
    (one access port per bank per cycle),
  * datapath bit-width (the paper's target is 16-bit),
  * logical clustering (the 8x8 target = 4 clusters of 4x4, two 8 kB banks
    per cluster).

The ADL is (de)serializable to JSON so user-defined architectures can be
swapped in, mirroring Morpher's architecture-adaptive design.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Dict, FrozenSet, List, Optional, Tuple

from .dfg import Op, ALU_OPS, MEM_OPS

# Directions: index into the crossbar output ports of each PE.
DIRS = ("N", "E", "S", "W")
OPP = {"N": "S", "S": "N", "E": "W", "W": "E"}
DIR_IDX = {d: i for i, d in enumerate(DIRS)}


@dataclass(frozen=True)
class MemBank:
    id: int
    size_bytes: int
    # PEs (flat ids) that may issue LOAD/STORE to this bank (shared bus).
    pes: Tuple[int, ...]

    @property
    def words(self) -> int:
        return self.size_bytes // 2  # 16-bit words


@dataclass
class CGRAArch:
    name: str
    rows: int
    cols: int
    datapath_bits: int = 16
    regfile_size: int = 8          # routing registers per PE
    livein_regs: int = 4           # host-preloaded scalar registers per PE
    rf_write_ports: int = 2
    banks: List[MemBank] = field(default_factory=list)
    torus: bool = False
    # ops supported by every PE FU (homogeneous by default; heterogeneous
    # grids override per_pe_ops)
    fu_ops: FrozenSet[str] = frozenset(o.value for o in (ALU_OPS | MEM_OPS |
                                                         {Op.CONST, Op.LIVEIN}))
    per_pe_ops: Dict[int, FrozenSet[str]] = field(default_factory=dict)
    clusters: List[List[int]] = field(default_factory=list)

    # ------------------------------------------------------------- topology
    @property
    def n_pes(self) -> int:
        return self.rows * self.cols

    def pe_id(self, r: int, c: int) -> int:
        return r * self.cols + c

    def pe_rc(self, p: int) -> Tuple[int, int]:
        return divmod(p, self.cols)

    def neighbor(self, p: int, d: str) -> Optional[int]:
        r, c = self.pe_rc(p)
        if d == "N":
            r -= 1
        elif d == "S":
            r += 1
        elif d == "E":
            c += 1
        elif d == "W":
            c -= 1
        if self.torus:
            r %= self.rows
            c %= self.cols
        elif not (0 <= r < self.rows and 0 <= c < self.cols):
            return None
        return self.pe_id(r, c)

    def neighbors(self, p: int) -> List[Tuple[str, int]]:
        out = []
        for d in DIRS:
            q = self.neighbor(p, d)
            if q is not None:
                out.append((d, q))
        return out

    def manhattan(self, p: int, q: int) -> int:
        pr, pc = self.pe_rc(p)
        qr, qc = self.pe_rc(q)
        return abs(pr - qr) + abs(pc - qc)

    # --------------------------------------------------------------- memory
    @property
    def mem_pes(self) -> FrozenSet[int]:
        s: set = set()
        for b in self.banks:
            s.update(b.pes)
        return frozenset(s)

    def bank(self, bank_id: int) -> MemBank:
        """The bank with ``MemBank.id == bank_id``.  Banks are identified by
        their declared id everywhere (layout placements, ``bank<id>`` memory
        images, mapper bus constraints), never by list position — a user ADL
        may declare banks in any order.

        The id map is memoized against the identity of ``self.banks`` (the
        mapper calls this in placement inner loops); rebinding the list —
        how tests and programmatic edits mutate an arch — invalidates it.
        """
        cached = self.__dict__.get("_bank_by_id")
        if cached is None or cached[0] is not self.banks:
            cached = (self.banks, {b.id: b for b in self.banks})
            self.__dict__["_bank_by_id"] = cached
        try:
            return cached[1][bank_id]
        except KeyError:
            raise KeyError(f"{self.name}: no memory bank with id "
                           f"{bank_id}") from None

    def banks_of_pe(self, p: int) -> List[int]:
        return [b.id for b in self.banks if p in b.pes]

    def pes_of_bank(self, bank_id: int) -> Tuple[int, ...]:
        return self.bank(bank_id).pes

    def supports(self, p: int, op: Op) -> bool:
        ops = self.per_pe_ops.get(p, self.fu_ops)
        if op in MEM_OPS and p not in self.mem_pes:
            return False
        return op.value in ops

    # --------------------------------------------------------- serialization
    def to_json(self) -> str:
        d = asdict(self)
        d["fu_ops"] = sorted(self.fu_ops)
        d["per_pe_ops"] = {str(k): sorted(v) for k, v in self.per_pe_ops.items()}
        d["banks"] = [{"id": b.id, "size_bytes": b.size_bytes,
                       "pes": list(b.pes)} for b in self.banks]
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "CGRAArch":
        """Deserialize (and validate) an ADL JSON architecture.

        Validation happens here so malformed user ADL files
        (``edge_deploy.py --arch-file``, DSE inputs) fail loudly at load
        time instead of flowing into the mapper as opaque errors."""
        d = json.loads(s)
        banks = [MemBank(b["id"], b["size_bytes"], tuple(b["pes"]))
                 for b in d.pop("banks")]
        d["fu_ops"] = frozenset(d["fu_ops"])
        d["per_pe_ops"] = {int(k): frozenset(v)
                           for k, v in d.pop("per_pe_ops", {}).items()}
        arch = CGRAArch(banks=banks, **d)
        arch.validate()
        return arch

    def validate(self) -> None:
        """Raises ValueError on an inconsistent architecture (real errors,
        not asserts: this guards untrusted user ADL files, e.g.
        ``edge_deploy.py --arch-file``, and must survive ``python -O``)."""
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError(f"{self.name}: grid {self.rows}x{self.cols} "
                             f"must be positive")
        if self.torus and (self.rows < 2 or self.cols < 2):
            # a 1-wide torus wraps a PE's N/S (or E/W) wires back onto
            # itself: neighbor() would return the PE as its own neighbour,
            # an out-of-range reference the router cannot represent (today
            # this only surfaces deep in config generation)
            raise ValueError(f"{self.name}: torus grid {self.rows}x"
                             f"{self.cols} wraps a PE onto itself; tori "
                             f"need rows >= 2 and cols >= 2")
        seen_ids: set = set()
        for b in self.banks:
            if b.id in seen_ids:
                raise ValueError(f"{self.name}: duplicate memory bank id "
                                 f"{b.id}")
            seen_ids.add(b.id)
            if b.size_bytes <= 0 or b.size_bytes % 2:
                # a zero/odd-sized bank collapses to 0 words: its derived
                # word interval is empty and its global offset aliases the
                # next bank's in every SimConfig built on this arch
                raise ValueError(f"{self.name}: bank {b.id} size_bytes "
                                 f"{b.size_bytes} must be a positive "
                                 f"multiple of 2 (16-bit words), else its "
                                 f"word offsets overlap the next bank's")
            if len(set(b.pes)) != len(b.pes):
                raise ValueError(f"{self.name}: bank {b.id} lists a PE "
                                 f"more than once on its bus: {b.pes}")
            for p in b.pes:
                if not 0 <= p < self.n_pes:
                    raise ValueError(f"{self.name}: bank {b.id} references "
                                     f"PE {p} outside the {self.n_pes}-PE grid")
        if self.regfile_size < 1 or self.livein_regs < 0:
            raise ValueError(f"{self.name}: regfile_size must be >= 1 and "
                             f"livein_regs >= 0")
        for ci, cluster in enumerate(self.clusters):
            for p in cluster:
                if not 0 <= p < self.n_pes:
                    raise ValueError(
                        f"{self.name}: cluster {ci} references PE {p} "
                        f"outside the {self.n_pes}-PE grid")
        for p in self.per_pe_ops:
            if not 0 <= p < self.n_pes:
                raise ValueError(
                    f"{self.name}: per_pe_ops references PE {p} outside "
                    f"the {self.n_pes}-PE grid")


# ----------------------------------------------------------- stock designs
def cluster_4x4(bank_kb: int = 8, regfile: int = 8,
                name: str = "morpher-cluster-4x4") -> CGRAArch:
    """One cluster of the paper's target: 4x4 PEs, two 8 kB banks, memory
    access from the left and right boundary columns (shared bus per bank)."""
    rows = cols = 4
    left = tuple(r * cols + 0 for r in range(rows))
    right = tuple(r * cols + (cols - 1) for r in range(rows))
    arch = CGRAArch(
        name=name, rows=rows, cols=cols, datapath_bits=16,
        regfile_size=regfile,
        banks=[MemBank(0, bank_kb * 1024, left),
               MemBank(1, bank_kb * 1024, right)],
        clusters=[list(range(16))],
    )
    arch.validate()
    return arch


def morpher_8x8(bank_kb: int = 8) -> CGRAArch:
    """The paper's full target CGRA: 8x8 PEs = 4 logical clusters of 4x4,
    8 data memories on the left/right boundary PEs (2 banks per cluster)."""
    rows = cols = 8
    banks: List[MemBank] = []
    clusters: List[List[int]] = []
    bid = 0
    for cr in range(2):
        for cc in range(2):
            pes = [ (cr * 4 + r) * cols + (cc * 4 + c)
                    for r in range(4) for c in range(4) ]
            clusters.append(pes)
            # the cluster's boundary column that coincides with the chip
            # boundary hosts its two banks
            col = 0 if cc == 0 else cols - 1
            side = tuple((cr * 4 + r) * cols + col for r in range(4))
            banks.append(MemBank(bid, bank_kb * 1024, side[:2]))
            banks.append(MemBank(bid + 1, bank_kb * 1024, side[2:]))
            bid += 2
    arch = CGRAArch(name="morpher-8x8", rows=rows, cols=cols,
                    datapath_bits=16, banks=banks, clusters=clusters)
    arch.validate()
    return arch
