"""Whole-artifact checking and the byte-deterministic ``check_report.json``.

:func:`check_kernel` runs all three layers over one
:class:`~repro_torch.core.toolchain.CompiledKernel` — mapping, config, and the
in-memory encoding of its instruction stream — and is pure: no
simulation, no RNG, no wall clock, no filesystem reads.  Reports built
from it serialize with sorted keys and compact separators, so two runs
over the same artifacts produce byte-identical files (the CI
``check-smoke`` job ``cmp``'s them).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence

from .config import check_config
from .diagnostics import Diagnostic, ERROR, RULES
from .mapping import check_mapping
from .stream import check_stream

REPORT_SCHEMA = 1

LAYERS = ("mapping", "config", "stream")


def check_kernel(ck, layers: Sequence[str] = LAYERS) -> List[Diagnostic]:
    """All static diagnostics for one compiled kernel, in canonical order
    (mapping first, then config, then stream; sorted within each layer)."""
    diags: List[Diagnostic] = []
    if "mapping" in layers:
        diags += check_mapping(ck.mapping)
    if "config" in layers:
        diags += check_config(ck.cfg, ck.arch)
    if "stream" in layers:
        from ..isa.encode import manifest_dict, to_csv
        try:
            csv_text = to_csv(ck.cfg)
            manifest = manifest_dict(ck.cfg, ck.name)
        except Exception as e:
            # a config too corrupt to even encode (e.g. an opcode with no
            # mnemonic) has no stream to audit; report the encode failure
            # rather than crash — the config layer names the root cause
            diags.append(Diagnostic(
                rule="STR-PARSE", severity=ERROR, locus="stream",
                message=f"instruction stream cannot be encoded: {e}"))
        else:
            diags += check_stream(csv_text, manifest,
                                  rf_write_ports=ck.arch.rf_write_ports)
    return diags


def errors(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def assert_clean(ck) -> None:
    """The MORPHER_CHECK=1 contract: a clean compiled artifact is
    diagnostic-free.  Raises ``AssertionError`` naming every rule that
    fired."""
    found = errors(check_kernel(ck))
    if found:
        listing = "\n".join(f"  {d}" for d in found[:20])
        more = "" if len(found) <= 20 else f"\n  ... and {len(found) - 20} more"
        raise AssertionError(
            f"static check: {ck.name} has {len(found)} diagnostic(s):\n"
            f"{listing}{more}")


def report_dict(per_kernel: "Dict[str, dict]") -> dict:
    """Assemble the ``check_report.json`` payload.

    ``per_kernel`` maps a report key (kernel name, or ``arch/kernel``) to
    ``{"II": int, "cache_key": str, "diagnostics": [Diagnostic, ...]}``.
    """
    kernels = {}
    total = 0
    for key in sorted(per_kernel):
        entry = per_kernel[key]
        diags = entry["diagnostics"]
        total += len(errors(diags))
        kernels[key] = {
            "II": entry.get("II"),
            "cache_key": entry.get("cache_key"),
            "n_diagnostics": len(diags),
            "diagnostics": [d.to_json_dict() for d in diags],
        }
    return {
        "schema": REPORT_SCHEMA,
        "rules": dict(RULES),
        "kernels": kernels,
        "n_kernels": len(kernels),
        "n_errors": total,
        "clean": total == 0,
    }


def report_json(per_kernel: "Dict[str, dict]") -> str:
    return json.dumps(report_dict(per_kernel), sort_keys=True,
                      separators=(",", ":")) + "\n"
