"""repro_torch.check — static legality checking for compiled CGRA artifacts.

Proves an artifact structurally and temporally legal *without running
it*, across all three toolchain layers:

* :func:`check_mapping` — placement, routing adjacency/continuity,
  (resource, II-slot) exclusivity over a re-derived occupancy map;
* :func:`check_config` — mux-select ranges, RF write ports, load-pipeline
  hazards, validity windows, bank bindings, live-in initialization;
* :func:`check_stream` — the same temporal facts re-derived from the raw
  ``instructions.csv`` / manifest text (an independent auditor of
  ``isa.encode``);
* :func:`check_kernel` / :func:`assert_clean` — all layers over one
  ``CompiledKernel``; clean artifacts are diagnostic-free (the
  ``MORPHER_CHECK=1`` contract).

The checker is pure — no simulation, no RNG, no wall clock — and its
reports are byte-deterministic (:mod:`repro_torch.check.report`).  The seeded
corruption harness that proves the rules have teeth lives in
:mod:`repro_torch.check.mutate`; the CLI in ``python -m repro_torch.check``.
"""
from .config import check_config
from .diagnostics import Diagnostic, ERROR, RULES, WARNING
from .mapping import check_mapping
from .report import (LAYERS, REPORT_SCHEMA, assert_clean, check_kernel,
                     errors, report_dict, report_json)
from .stream import check_stream

__all__ = [
    "Diagnostic", "RULES", "ERROR", "WARNING", "LAYERS", "REPORT_SCHEMA",
    "check_mapping", "check_config", "check_stream", "check_kernel",
    "assert_clean", "errors", "report_dict", "report_json",
]
