"""Multi-bank data-layout generation (paper Fig. 3, piece 4, second half).

Variables of the mapped loop kernel are allocated to the on-chip memory
banks of the target CGRA.  Each array gets (bank, base) — bank-local word
addressing — subject to bank capacity; the DFG builder folds ``base`` into
the address arithmetic, and LOAD/STORE nodes are constrained by the mapper
to PEs that can reach the assigned bank over the shared bus.

Banks are identified by their declared ``MemBank.id`` throughout (the
``bank`` field of a :class:`Placement`, the ``bank<id>`` memory-image
names, the simulator's bank offsets), never by position in
``CGRAArch.banks`` — user ADL files may declare banks in any order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from .adl import CGRAArch


@dataclass(frozen=True)
class ArrayDecl:
    name: str
    words: int
    bank_pref: Optional[int] = None   # preferred bank (balance hint)


@dataclass(frozen=True)
class Placement:
    name: str
    words: int
    bank: int
    base: int   # word offset within the bank

    @property
    def bank_array(self) -> str:
        return f"bank{self.bank}"


@dataclass
class DataLayout:
    arch: CGRAArch
    placements: Dict[str, Placement]

    def bank_words(self, bank: int) -> int:
        return self.arch.bank(bank).words

    def bank_image_size(self) -> Dict[int, int]:
        """{bank id: words} in bank declaration order."""
        return {b.id: b.words for b in self.arch.banks}

    def addr(self, name: str, flat_index: int) -> int:
        p = self.placements[name]
        assert 0 <= flat_index < p.words, (name, flat_index, p.words)
        return p.base + flat_index

    # --------------------------------------------------------- serialization
    def to_json_dict(self) -> dict:
        """Placements only; the arch is serialized separately (ADL JSON)."""
        return {"placements": {name: [p.words, p.bank, p.base]
                               for name, p in sorted(self.placements.items())}}

    @staticmethod
    def from_json_dict(d: dict, arch: CGRAArch) -> "DataLayout":
        return DataLayout(arch, {
            name: Placement(name, words, bank, base)
            for name, (words, bank, base) in d["placements"].items()})


def assign_layout(arch: CGRAArch, arrays: Sequence[ArrayDecl],
                  banks: Optional[Sequence[int]] = None) -> DataLayout:
    """Greedy capacity-aware allocation honouring bank preferences.

    Arrays with an explicit ``bank_pref`` go there (error if they overflow);
    the rest are placed largest-first onto the emptiest bank.  ``banks``
    holds bank *ids* (``MemBank.id``, default: every bank in declaration
    order); ``bank_pref`` is a *position* into that sequence — an
    arch-agnostic balance hint ("first bank", "second bank") that kernel
    builders can use without knowing the target's id scheme.  The resolved
    :class:`Placement` always records the bank id.
    """
    banks = list(banks if banks is not None else (b.id for b in arch.banks))
    used = {b: 0 for b in banks}
    placements: Dict[str, Placement] = {}

    def place(a: ArrayDecl, b: int) -> None:
        cap = arch.bank(b).words
        if used[b] + a.words > cap:
            raise ValueError(
                f"array {a.name} ({a.words} words) overflows bank {b} "
                f"({cap - used[b]} free)")
        placements[a.name] = Placement(a.name, a.words, b, used[b])
        used[b] += a.words

    for a in arrays:
        if a.bank_pref is not None:
            if not 0 <= a.bank_pref < len(banks):
                raise ValueError(
                    f"array {a.name}: bank_pref {a.bank_pref} out of range "
                    f"for {len(banks)} usable banks")
            place(a, banks[a.bank_pref])
    for a in sorted([a for a in arrays if a.bank_pref is None],
                    key=lambda a: -a.words):
        b = min(banks, key=lambda b: used[b])
        place(a, b)
    return DataLayout(arch, placements)
