"""Parameterized CGRA architecture generator for design-space sweeps.

An :class:`ArchPoint` is one coordinate of the ADL design space the paper
calls architecture-adaptivity: grid size, torus vs mesh interconnect,
routing register-file size, memory bank count/size/placement, and
heterogeneous per-PE op sets.  ``ArchPoint.build()`` materializes the
coordinate as a validated :class:`~repro_torch.core.adl.CGRAArch` with a
deterministic name, so a sweep is reproducible from its space name alone
and every (variant, kernel) compile is a stable content-addressed cache
key.

Bank placement follows the paper's target family: data memories sit on
the left/right boundary columns behind shared buses (one access port per
bank per cycle).  ``banks_per_col=2`` splits each boundary column into a
top-half and bottom-half bank — more aggregate ports, same capacity
knob.  Bank ids are assigned so that id 0 is always a left-column bank
and id 1 a right-column bank, matching the kernel library's layout hints
(accumulator/weight arrays vs streamed inputs on opposite buses).

Heterogeneity (``het``) — the compute-provisioning axis (how much FU
capability each tile carries; the register-file size is the routing-
provisioning axis — together the compute-vs-communication trade of
"Aligned Compute and Communication Provisioning for CGRAs",
arXiv 2412.08137):
  none     homogeneous FUs (every PE has the full op set)
  alulite  interior PEs keep only the arithmetic core (add/sub/mul/
           shl/shr + const/livein); compare/select/bitwise logic — the
           induction-chain machinery of coalesced kernels — is restricted
           to the boundary columns, modeling cheap ALU-lite interior
           tiles.  (Memory ops are always boundary-only: LOAD/STORE must
           reach a bank bus regardless of the op set.)
  mulring  interior PEs drop the multiplier (everything else stays):
           multiplies ride a ring of full-FU boundary tiles, modeling
           the area-dominant multiplier being provisioned only where
           operands stream in.
  checker  checkerboard interiors: alternating interior PEs are ALU-lite
           (by ``(row + col)`` parity), the rest keep the full set —
           half-way compute provisioning between ``none`` and
           ``alulite``.

The search operators at the bottom (``axis_domains`` / ``mutate`` /
``crossover`` / ``point_valid``) treat the knobs as genes over the
domains a candidate universe spans — the seeded evolutionary driver in
:mod:`repro_torch.dse.search` is built on them.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Sequence, Tuple

from ..core.adl import CGRAArch, MemBank
from ..core.dfg import ALU_OPS, MEM_OPS, Op

# the arithmetic core every PE keeps under "alulite" heterogeneity
LITE_OPS = frozenset(o.value for o in (Op.ADD, Op.SUB, Op.MUL, Op.SHL,
                                       Op.SHR, Op.CONST, Op.LIVEIN))
# the homogeneous full FU op set (CGRAArch's default)
FULL_OPS = frozenset(o.value for o in (ALU_OPS | MEM_OPS
                                       | {Op.CONST, Op.LIVEIN}))
# "mulring": interior tiles keep everything but the multiplier
NOMUL_OPS = FULL_OPS - frozenset((Op.MUL.value,))

HET_KINDS = ("none", "alulite", "mulring", "checker")


@dataclass(frozen=True)
class ArchPoint:
    """One coordinate of the CGRA design space (see module docstring)."""
    rows: int
    cols: int
    torus: bool = False
    regfile_size: int = 8
    bank_kb: int = 8
    banks_per_col: int = 1
    het: str = "none"

    @property
    def name(self) -> str:
        """Deterministic variant name — the checkpoint / report / cache
        identity of this point."""
        topo = "torus" if self.torus else "mesh"
        n_banks = 2 * self.banks_per_col
        s = (f"dse-{self.rows}x{self.cols}-{topo}-rf{self.regfile_size}"
             f"-b{n_banks}x{self.bank_kb}k")
        if self.het != "none":
            s += f"-{self.het}"
        return s

    def to_json_dict(self) -> Dict:
        return asdict(self)

    @staticmethod
    def from_json_dict(d: Dict) -> "ArchPoint":
        return ArchPoint(**d)

    def build(self) -> CGRAArch:
        """Materialize (and validate) the CGRAArch for this point."""
        rows, cols = self.rows, self.cols
        if cols < 2:
            raise ValueError(f"{self.name}: need >= 2 columns for "
                             f"left/right boundary memory buses")
        if self.banks_per_col not in (1, 2):
            raise ValueError(f"{self.name}: banks_per_col must be 1 or 2")
        if self.banks_per_col == 2 and rows < 2:
            raise ValueError(f"{self.name}: banks_per_col=2 needs >= 2 rows")
        if self.het not in HET_KINDS:
            raise ValueError(f"{self.name}: unknown het kind {self.het!r} "
                             f"(choose from {HET_KINDS})")

        left = [r * cols + 0 for r in range(rows)]
        right = [r * cols + (cols - 1) for r in range(rows)]
        size = self.bank_kb * 1024
        banks: List[MemBank] = []
        if self.banks_per_col == 1:
            banks = [MemBank(0, size, tuple(left)),
                     MemBank(1, size, tuple(right))]
        else:
            half = rows // 2
            banks = [MemBank(0, size, tuple(left[:half])),
                     MemBank(1, size, tuple(right[:half])),
                     MemBank(2, size, tuple(left[half:])),
                     MemBank(3, size, tuple(right[half:]))]

        # logical clustering: tile 4x4 clusters when the grid allows more
        # than one (the paper's 8x8 = 4 clusters), else one cluster
        if rows % 4 == 0 and cols % 4 == 0 and rows * cols > 16:
            clusters = [[(cr * 4 + r) * cols + (cc * 4 + c)
                         for r in range(4) for c in range(4)]
                        for cr in range(rows // 4) for cc in range(cols // 4)]
        else:
            clusters = [list(range(rows * cols))]

        per_pe_ops: Dict[int, frozenset] = {}
        if self.het != "none":
            boundary = set(left) | set(right)
            interior = [p for p in range(rows * cols) if p not in boundary]
            if self.het == "alulite":
                per_pe_ops = {p: LITE_OPS for p in interior}
            elif self.het == "mulring":
                per_pe_ops = {p: NOMUL_OPS for p in interior}
            else:  # checker
                per_pe_ops = {p: LITE_OPS for p in interior
                              if (p // cols + p % cols) % 2 == 1}

        arch = CGRAArch(name=self.name, rows=rows, cols=cols,
                        datapath_bits=16, regfile_size=self.regfile_size,
                        banks=banks, torus=self.torus,
                        per_pe_ops=per_pe_ops, clusters=clusters)
        arch.validate()
        return arch


# ------------------------------------------------------------------ spaces
def tiny_space() -> List[ArchPoint]:
    """Four variants for CI smoke — a strict subset of ``small`` so the
    smoke BENCH rows stay comparable against the committed small-sweep
    baseline."""
    return [
        ArchPoint(4, 4),
        ArchPoint(4, 4, torus=True),
        ArchPoint(4, 4, regfile_size=4),
        ArchPoint(4, 4, banks_per_col=2, bank_kb=4),
    ]


def small_space() -> List[ArchPoint]:
    """The default sweep: 20 variants spanning every knob, centered on
    grids the whole kernel library maps onto comfortably (the 4x4
    cluster family, 4x8, 8x8), plus aggressive stretch points — 2x2 and
    2x4 grids, ALU-lite interiors, small register files — where some
    kernels legitimately fail to map within ``ii_max`` (the sweep driver
    records those as per-kernel statuses and drops the variant from the
    Pareto candidate set)."""
    pts = list(tiny_space())
    pts += [
        ArchPoint(4, 4, regfile_size=16),
        ArchPoint(4, 4, torus=True, regfile_size=4),
        ArchPoint(4, 4, torus=True, regfile_size=16),
        ArchPoint(4, 4, torus=True, banks_per_col=2, bank_kb=4),
        ArchPoint(4, 4, banks_per_col=2),
        ArchPoint(4, 4, torus=True, banks_per_col=2),
        ArchPoint(4, 4, regfile_size=16, banks_per_col=2, bank_kb=4),
        ArchPoint(4, 4, torus=True, regfile_size=16, banks_per_col=2,
                  bank_kb=4),
        ArchPoint(4, 8),
        ArchPoint(4, 8, torus=True),
        ArchPoint(8, 8),
        ArchPoint(8, 8, torus=True),
        # stretch points: minimal grids and heterogeneous interiors
        ArchPoint(2, 2),
        ArchPoint(2, 4),
        ArchPoint(4, 4, het="alulite"),
        ArchPoint(4, 4, torus=True, het="alulite"),
    ]
    return pts


def full_space() -> List[ArchPoint]:
    """The exhaustive grid: every knob combination over 2x2..8x8 grids.
    Deterministic enumeration order; infeasible/unmappable points are
    sweep results ("unmapped"), not errors."""
    pts: List[ArchPoint] = []
    for rows, cols in ((2, 2), (2, 4), (4, 4), (4, 8), (6, 6), (8, 8)):
        for torus in (False, True):
            for rf in (4, 8, 16):
                for bank_kb, bpc in ((8, 1), (4, 2), (8, 2)):
                    for het in ("none", "alulite"):
                        if het == "alulite" and cols <= 2:
                            continue  # no interior PEs to restrict
                        pts.append(ArchPoint(rows, cols, torus=torus,
                                             regfile_size=rf,
                                             bank_kb=bank_kb,
                                             banks_per_col=bpc, het=het))
    return pts


def wide_space() -> List[ArchPoint]:
    """The widened search universe (~500 points): the ``full`` grid plus
    a big-single-bank provisioning option (16 kB x 1 per column) and the
    two heterogeneity kinds beyond ALU-lite (``mulring``, ``checker``).
    Deliberately too large to sweep exhaustively in CI — the seeded
    search driver (:mod:`repro_torch.dse.search`) is how it gets explored.
    ``full_space()`` is a strict subset (same validity rule, superset
    axes), so exhaustive baselines stay comparable."""
    pts: List[ArchPoint] = []
    for rows, cols in ((2, 2), (2, 4), (4, 4), (4, 8), (6, 6), (8, 8)):
        for torus in (False, True):
            for rf in (4, 8, 16):
                for bank_kb, bpc in ((8, 1), (4, 2), (8, 2), (16, 1)):
                    for het in HET_KINDS:
                        p = ArchPoint(rows, cols, torus=torus,
                                      regfile_size=rf, bank_kb=bank_kb,
                                      banks_per_col=bpc, het=het)
                        if point_valid(p):
                            pts.append(p)
    return pts


SPACE_NAMES = ("tiny", "small", "full", "wide")


def get_space(name: str) -> List[ArchPoint]:
    try:
        return {"tiny": tiny_space, "small": small_space,
                "full": full_space, "wide": wide_space}[name]()
    except KeyError:
        raise ValueError(f"unknown space {name!r} (choose from "
                         f"{SPACE_NAMES})") from None


# -------------------------------------------------------- search operators
# the knob axes a point decomposes into (grid and bank move as pairs: a
# row count without its column count — or a bank size without its port
# count — is not a meaningful half-gene)
AXES = ("grid", "torus", "regfile_size", "bank", "het")


def genes(p: ArchPoint) -> Dict[str, object]:
    """Decompose a point into its knob genes, keyed by ``AXES``."""
    return {"grid": (p.rows, p.cols), "torus": p.torus,
            "regfile_size": p.regfile_size,
            "bank": (p.bank_kb, p.banks_per_col), "het": p.het}


def from_genes(g: Dict[str, object]) -> ArchPoint:
    """Reassemble an :class:`ArchPoint` from a gene dict."""
    rows, cols = g["grid"]
    bank_kb, bpc = g["bank"]
    return ArchPoint(rows, cols, torus=bool(g["torus"]),
                     regfile_size=int(g["regfile_size"]),
                     bank_kb=int(bank_kb), banks_per_col=int(bpc),
                     het=str(g["het"]))


def point_valid(p: ArchPoint) -> bool:
    """Structural validity of a point — the same rules ``build()``
    enforces, plus "heterogeneity needs interior PEs" (``cols > 2``),
    which ``full_space``/``wide_space`` enumeration also applies.  Search
    operators cross and mutate genes freely and discard what fails
    here."""
    if p.cols < 2 or p.rows < 1 or p.banks_per_col not in (1, 2):
        return False
    if p.banks_per_col == 2 and p.rows < 2:
        return False
    if p.het not in HET_KINDS:
        return False
    if p.het != "none" and p.cols <= 2:
        return False
    return True


def axis_domains(points: Sequence[ArchPoint]) -> Dict[str, List]:
    """Per-axis value domains spanned by a candidate universe, in
    deterministic order — the gene pool the search operators draw from.
    Crossing domain values can produce combinations absent from the
    input list; that widening is intentional (``point_valid`` is the only
    fence)."""
    pts = list(points)
    return {
        "grid": sorted({(p.rows, p.cols) for p in pts}),
        "torus": sorted({p.torus for p in pts}),
        "regfile_size": sorted({p.regfile_size for p in pts}),
        "bank": sorted({(p.bank_kb, p.banks_per_col) for p in pts}),
        "het": sorted({p.het for p in pts}, key=HET_KINDS.index),
    }


def mutate(rng, p: ArchPoint, domains: Dict[str, List],
           rate: float = 0.25) -> ArchPoint:
    """Seeded point mutation: each knob independently resamples from its
    domain with probability ``rate`` (at least one knob always moves);
    invalid gene combinations redraw (bounded), falling back to the
    parent.  Deterministic for a given ``rng`` state."""
    for _ in range(8):
        g = genes(p)
        moved = False
        for axis in AXES:
            dom = domains.get(axis, [])
            if len(dom) > 1 and rng.random() < rate:
                g[axis] = dom[rng.randrange(len(dom))]
                moved = True
        if not moved:
            movable = [ax for ax in AXES if len(domains.get(ax, [])) > 1]
            if not movable:
                return p
            ax = movable[rng.randrange(len(movable))]
            dom = domains[ax]
            g[ax] = dom[rng.randrange(len(dom))]
        q = from_genes(g)
        if q != p and point_valid(q):
            return q
    return p


def crossover(rng, a: ArchPoint, b: ArchPoint) -> ArchPoint:
    """Seeded uniform crossover: each knob comes from either parent with
    equal probability; an invalid child falls back to parent ``a``.
    Deterministic for a given ``rng`` state."""
    ga, gb = genes(a), genes(b)
    g = {axis: (ga[axis] if rng.random() < 0.5 else gb[axis])
         for axis in AXES}
    q = from_genes(g)
    return q if point_valid(q) else a
