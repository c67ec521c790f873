"""Modulo Routing Resource Graph (MRRG) — resources and the time-extended
router (paper Fig. 2c; Mei et al. DRESC / Rau iterative modulo scheduling).

The CGRA is modelled as a set of per-cycle-slot resources (II slots):

  ('fu',    pe, slot)        capacity 1  -- functional-unit issue slot
  ('fuout', pe, slot)        capacity 1  -- result register becomes readable
  ('xo',    pe, dir, slot)   capacity 1  -- registered crossbar output port
  ('regpool', pe, slot)      capacity R  -- values resident in the PE's RF
  ('wr',    pe, slot)        capacity W  -- RF write ports
  ('bank',  bank, slot)      capacity 1  -- memory-bank access port (shared bus)
  ('lireg', pe)              capacity L  -- host-preloaded live-in registers

A *value instance* is identified by (value_id, abs_time): the same value at
the same absolute time occupying a resource twice is one physical copy
(free fan-out sharing); the same value at two absolute times that alias the
same modulo slot would be two concurrently-live copies and is rejected —
this is exactly the MRRG modulo constraint.

Values travel through the time-extended graph via two state kinds:
  F (fresh): readable this cycle from the producing FU's output register or
             from an inbound crossbar wire — ephemeral, 1 cycle only.
  R (reg):   resident in the PE's register file (held <= II consecutive
             cycles so the periodic schedule stays single-register).

This module is the typed façade over the packed implementation in
``router.py``: resource keys stay the tuples above at the API surface, but
occupancy and the BFS run over flat integer ids (see the router module for
the packing scheme).  Route production is bit-identical to the historical
dict-of-tuples router.
"""
from __future__ import annotations

from .router import (F, Inst, Key, R, Route, RouterTables, Usage,
                     commit_route, release_route, route_value, router_tables)

__all__ = ["F", "R", "Key", "Inst", "Route", "RouterTables", "Usage",
           "commit_route", "release_route", "route_value", "router_tables"]
