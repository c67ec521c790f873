"""Structured diagnostics for the static legality checker.

Every rule the checker can fire lives in the :data:`RULES` catalog — one
stable id per structural/temporal property, grouped by the artifact layer
it audits (``MAP-*`` over :class:`~repro_torch.core.mapper.Mapping`, ``CFG-*``
over :class:`~repro_torch.core.config_gen.SimConfig`, ``STR-*`` over the
exported ``instructions.csv`` / manifest family).  Rule ids are part of
the public contract: tests pin them, the mutation corpus asserts each
corruption class trips its intended id, and generator errors
(``ConfigConflict`` / ``StreamError``) reference them so static
diagnostics and dynamic failures read the same way.

Diagnostics are plain frozen records with a canonical sort order, so a
report assembled from them is byte-deterministic by construction (no
wall-clock, no RNG, no iteration-order dependence).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

ERROR = "error"
WARNING = "warning"

# rule id -> one-line description (the README rule-catalog table renders
# from this mapping; keep descriptions single-line and self-contained)
RULES: Dict[str, str] = {
    # ---------------------------------------------- mapping legality (a)
    "MAP-NODE-RANGE": "DFG node unplaced, or placed outside the PE grid / "
                      "at a negative schedule time",
    "MAP-OP-SUPPORT": "node op unsupported by its PE's functional unit "
                      "(per_pe_ops interiors, memory-bus membership)",
    "MAP-FU-OVERLAP": "two nodes share one FU issue slot or FU output "
                      "register (resource, II-slot) cell",
    "MAP-ROUTE-CONT": "route endpoints/steps inconsistent with the "
                      "placement or schedule times (incl. unrouted edges)",
    "MAP-ROUTE-ADJ": "route hops between physically non-adjacent PEs",
    "MAP-ROUTE-OVERLAP": "two value instances occupy one routing resource "
                         "(crossbar port, register slot, or RF write ports "
                         "over capacity)",
    "MAP-REG-RANGE": "register-resident route step without a register "
                     "assignment, or assignment outside the register file",
    "MAP-BANK-BUS": "memory node bound to an unknown bank or placed on a "
                    "PE that is not on the bank's shared bus",
    "MAP-BANK-PORT": "two memory nodes access one bank in the same II "
                     "slot (one access port per bank per cycle)",
    "MAP-LIREG": "live-in register assignment missing, out of range, or "
                 "over the per-PE live-in register count",
    # ----------------------------------------- config/timing legality (b)
    "CFG-SHAPE": "SimConfig dimensions/planes inconsistent with the "
                 "architecture (II/P/RF/LI/bits, plane shapes, depth)",
    "CFG-OPC-RANGE": "FU opcode outside the opcode table",
    "CFG-MUX-RANGE": "mux select kind/index out of range for the fabric, "
                     "or a read through a missing neighbour wire",
    "CFG-RF-WPORTS": "register-file writes in one (slot, pe) exceed "
                     "rf_write_ports",
    "CFG-LOAD-HAZARD": "result-producing op scheduled in a load's shadow "
                       "slot (the completing load clobbers the FU output "
                       "register)",
    "CFG-STORE-WINDOW": "validity window inconsistent: tstart residue "
                        "differs from the II slot, or lies outside the "
                        "schedule depth",
    "CFG-BANK-RANGE": "memory binding (mem_off, mem_words) does not match "
                      "a declared bank, or bank offsets disagree with the "
                      "ADL",
    "CFG-BANK-PORT": "two memory ops bound to one bank in the same II "
                     "slot",
    "CFG-LIVEIN": "live-in register read without a host initialization, "
                  "or assignment out of range / double-booked",
    "CFG-NBR": "neighbour table disagrees with the ADL topology",
    # ----------------------------------------------- stream legality (c)
    "STR-PARSE": "CSV/manifest malformed: format version, header, record "
                 "count (truncation), duplicate or out-of-range records",
    "STR-OPC": "unknown opcode mnemonic",
    "STR-SEL-RANGE": "mux select unparseable, out of range, or reading a "
                     "missing neighbour wire",
    "STR-RF-WPORTS": "register-file writebacks in one record exceed "
                     "rf_write_ports",
    "STR-LOAD-HAZARD": "result-producing mnemonic in a load's shadow slot",
    "STR-STORE-WINDOW": "tstart residue differs from the record's slot, or "
                        "lies outside the schedule depth",
    "STR-BANK-RANGE": "memory binding does not match a bank derivable "
                      "from the manifest offsets",
    "STR-BANK-PORT": "two memory ops bound to one bank in the same II "
                     "slot",
    "STR-LIVEIN": "live-in select reads a register the manifest never "
                  "initializes",
}


@dataclass(frozen=True)
class Diagnostic:
    """One checker finding: a rule id, a severity, the (slot, pe)/node
    locus it anchors to, and a human-readable message."""
    rule: str
    severity: str            # ERROR | WARNING
    locus: str               # "slot2/pe5", "node7", "route(3->9#0)", ...
    message: str

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")

    def __str__(self) -> str:
        return f"[{self.rule}] {self.locus}: {self.message}"

    def to_json_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "locus": self.locus, "message": self.message}

    @property
    def sort_key(self):
        return (self.rule, self.locus, self.message)


def cell_locus(slot: int, pe: int) -> str:
    """The canonical (slot, pe) locus spelling — shared with the enriched
    ``ConfigConflict`` / ``StreamError`` messages so generator errors and
    checker diagnostics read the same way."""
    return f"slot{slot}/pe{pe}"


def sort_diagnostics(diags: List[Diagnostic]) -> List[Diagnostic]:
    """Canonical report order (stable, content-only)."""
    return sorted(diags, key=lambda d: d.sort_key)
