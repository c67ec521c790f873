"""Cycle-accurate functional CGRA simulator in PyTorch (paper Fig. 3 piece 8).

The port of ``repro.core.simulator``.  It executes the configuration
bitstreams exactly as the RTL control memories would:

  * every cycle, every PE reads its slot-(t mod II) configuration,
  * operand muxes select from {4 inbound crossbar wires, register file,
    own FU output register, immediate, live-in register},
  * the FU executes (two's-complement datapath of ``bits``), LOADs have a
    2-cycle latency through a pipeline register, STOREs commit at end of
    cycle gated by the control module's iteration-validity window
    (prologue/epilogue predication),
  * crossbar output registers and RF writes update from the same
    start-of-cycle snapshot (fully synchronous design).

All PEs and all memory images of a batch are vectorized; the cycle loop
and the invocation loop are plain Python loops of eager torch ops on
``device`` (``None``: the CUDA card).  Three entry points share one body:

  * ``simulate`` — one memory image;
  * ``simulate_batch`` — many seeds / test vectors of one compiled kernel
    in one batched cycle loop, through the process-wide runner cache
    (``simcache``), with the JAX package's signatures (the batch padded
    to its bucket, the cycle loop at the kernel's exact count);
  * ``simulate_multi`` — many *configurations* sharing a shape bucket
    (``stack_signature``): the config planes gain a leading batch-row axis
    and ride alongside the memory images.

The host-side compilation of a configuration into slot planes
(``_host_planes``, ``_port_gather_idx``, ``_state_layout``,
``_stack_planes``) is the JAX package's numpy code, unchanged.  The cycle
body keeps its semantics op for op — one flat gather of every mux port
from the start-of-cycle state, the ALU, the 2-cycle load pipeline, stores
through the store-lane table only — and leaves out, per II slot, the work
that slot's configuration cannot do: an ALU op no lane of the slot holds,
a load or a store where the slot has none, operand forcing after its last
forced cycle.  Those facts are read from the planes on the host, so the
result is bit-identical while the launches per cycle drop.

A 16-bit datapath runs natively in int16 (torch integer arithmetic wraps
mod 2^16, which *is* the datapath's wrap); other widths use int32 carriers
with an explicit ``_wrap`` (identity at 32 bits).  Memory images keep the
JAX package's dtypes: int16 at 16 bits, else int32.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import simcache
from .config_gen import (KIND_FUOUT, KIND_IMM, KIND_IN_E, KIND_IN_N,
                         KIND_IN_S, KIND_IN_W, KIND_LIREG, KIND_NONE,
                         KIND_REG, OPC, OPC_LOAD, OPC_NONE, OPC_PASS,
                         OPC_STORE, SimConfig, narrowed_planes)
from .dfg import Op

# xo-port index a reader consults on its neighbour: OPP of (N,E,S,W)
_OPP_IDX = np.array([2, 3, 0, 1], dtype=np.int32)


def _dp_dtype(bits: int) -> torch.dtype:
    """Datapath carrier dtype: int16 when the datapath is 16 bits wide
    (native wraparound), else int32 with an explicit ``_wrap``."""
    return torch.int16 if bits == 16 else torch.int32


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap to ``bits``.  Where the carrier is exactly
    ``bits`` wide (int16 at 16, int32 at 32) torch's own overflow is the
    wrap; below that the constants stay within 32 signed bits."""
    if bits == 8 * x.element_size():
        return x
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


# the ALU, one function per opcode (the JAX package's ``_alu`` where-chain,
# split so a slot computes only the opcodes it holds); results are wrapped
# by the caller
def _cmp(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return r.to(like.dtype)


_ALU = {
    OPC_PASS: lambda a, b, c, bits: a,
    OPC[Op.ADD]: lambda a, b, c, bits: a + b,
    OPC[Op.SUB]: lambda a, b, c, bits: a - b,
    OPC[Op.MUL]: lambda a, b, c, bits: a * b,
    OPC[Op.SHL]: lambda a, b, c, bits: a << (b & (bits - 1)),
    OPC[Op.SHR]: lambda a, b, c, bits: a >> (b & (bits - 1)),
    OPC[Op.AND]: lambda a, b, c, bits: a & b,
    OPC[Op.OR]: lambda a, b, c, bits: a | b,
    OPC[Op.XOR]: lambda a, b, c, bits: a ^ b,
    OPC[Op.CMPGE]: lambda a, b, c, bits: _cmp(a >= b, a),
    OPC[Op.CMPEQ]: lambda a, b, c, bits: _cmp(a == b, a),
    OPC[Op.CMPLT]: lambda a, b, c, bits: _cmp(a < b, a),
    OPC[Op.SELECT]: lambda a, b, c, bits: torch.where(a != 0, b, c),
}

# an opcode outside the table (a corrupt config) computes 0, as the JAX
# package's where-chain does: it runs as this pseudo-op
_ZERO_OP = -1
_ALU[_ZERO_OP] = lambda a, b, c, bits: torch.zeros_like(a)

# configuration planes indexed by the II slot.  ``port_idx`` maps every
# mux port (operands + RF writes + crossbar writes, [II,P,3+RF+4]) to its
# gather index into the flat start-of-cycle state vector; ``rf_mask``/
# ``xo_mask`` flag which write ports are configured; ``store_lanes`` lists
# the (padded, -1-terminated) PE indices whose slot holds a STORE.
_SLOT_PLANES = ("op", "imm", "port_idx", "rf_mask", "xo_mask",
                "force_before", "force_val", "mem_off", "mem_words",
                "valid_start", "store_lanes")

# cap on the bytes of the tabulated store gate (one bool per store lane
# and cycle, [n_cycles, S] for one config, [n_cycles, B, S] for a stacked
# group): a simulation whose gate table fits tabulates every cycle's gate
# up front (host-side, with per-cycle "any lane / every lane on" flags
# that let gated-off and steady-state cycles skip the gating ops); past
# it, as a stacked group of full-size kernels over thousands of rows
# reaches, the gate is derived from the slot planes each cycle (identical
# numerics, O(II) memory, about 3 more launches a store cycle).
_TILE_BYTES_LIMIT = 64 << 20

# debug switch for tests: check, at every store commit, that no two
# gated-on lanes of one memory image share an address (duplicate scatter
# indices are then only the scratch word, written with its own value)
_CHECK_STORES = False


def _state_layout(P: int, RF: int, LI: int):
    """Section offsets of the flat per-cycle state vector the mux fabric
    gathers from: [ xo (P*4) | regs (P*RF) | fu (P) | imm (P) |
    li (P*LI) | zero (1) ] — the trailing cell is a constant 0 every
    unconfigured (KIND_NONE) port reads."""
    xo_off = 0
    reg_off = xo_off + P * 4
    fu_off = reg_off + P * RF
    imm_off = fu_off + P
    li_off = imm_off + P
    zero_off = li_off + P * LI
    return xo_off, reg_off, fu_off, imm_off, li_off, zero_off


def _port_gather_idx(kind: np.ndarray, idx: np.ndarray, cfg: SimConfig,
                     LI: int, rf_pad: int) -> np.ndarray:
    """Host-side compilation of one mux bank ([II,P,K] kind/idx planes)
    into flat state-vector gather indices — the per-kind select chain of
    the mux fabric becomes pure data, so the body resolves every port of
    every bank with a single gather.

    ``rf_pad >= cfg.RF`` is the register-file width of the runner's
    state layout (``simulate_multi`` pads the group to one RF bucket so
    differently-provisioned fabrics share a runner); reads still clip to
    the config's own RF, so padded rows are never addressed."""
    P, RF = cfg.P, cfg.RF
    xo_off, reg_off, fu_off, imm_off, li_off, zero_off = \
        _state_layout(P, rf_pad, LI)
    II, _, K = kind.shape
    pe = np.arange(P)[None, :, None]
    nbr = np.asarray(cfg.nbr_idx)                          # [P,4]
    out = np.full(kind.shape, zero_off, dtype=np.int64)    # KIND_NONE -> 0
    for d, kind_in in enumerate((KIND_IN_N, KIND_IN_E, KIND_IN_S,
                                 KIND_IN_W)):
        # inbound wire: neighbour's opposite-facing crossbar port
        sel = kind == kind_in
        val = nbr[:, d][None, :, None] * 4 + _OPP_IDX[d] + xo_off
        out = np.where(sel, np.broadcast_to(val, kind.shape), out)
    out = np.where(kind == KIND_REG,
                   reg_off + pe * rf_pad + np.clip(idx, 0, RF - 1), out)
    out = np.where(kind == KIND_FUOUT, fu_off + pe, out)
    out = np.where(kind == KIND_IMM, imm_off + pe, out)
    out = np.where(kind == KIND_LIREG,
                   li_off + pe * LI + np.clip(idx, 0, LI - 1), out)
    return out.astype(np.int16 if zero_off <= np.iinfo(np.int16).max
                      else np.int32)


def _host_planes(cfg: SimConfig,
                 rf_pad: int = 0) -> Dict[str, np.ndarray]:
    """Host-side compilation of a SimConfig into the simulator's slot
    planes (numpy), cached on the SimConfig (keyed by the RF width the
    runner will use; 0 / cfg.RF is the plain single-config layout).

    Starting from the dtype-narrowed planes, the three mux banks are
    compiled into one ``port_idx`` gather plane over the flat state
    vector, write masks replace the RF/crossbar kind tests, and the
    per-slot store-lane table is derived from the opcode plane (see
    ``_SLOT_PLANES``).  With ``rf_pad > cfg.RF`` the RF write-port bank
    pads to ``rf_pad`` ports with unconfigured (KIND_NONE, mask-off)
    lanes and the state layout stretches to match — the padded register
    rows are never written or read, which is what lets fabrics with
    different register-file provisioning stack into one runner
    bit-exactly.

    The cache means a SimConfig is frozen once simulated — and that is
    enforced: building the cache marks the numpy planes read-only, so a
    later in-place edit raises instead of silently diverging from the
    compiled copies.  Anyone editing a config by hand (tests injecting
    faults) must do so before the first run or delete ``_np_planes``/
    ``_torch_planes`` and restore ``.flags.writeable``.
    """
    R = rf_pad or cfg.RF
    assert R >= cfg.RF, "rf_pad must not shrink the register file"
    by_rf = getattr(cfg, "_np_planes", None)
    if by_rf is None:
        by_rf = cfg._np_planes = {}
    cached = by_rf.get(R)
    if cached is None:
        p = narrowed_planes(cfg)
        II, P, LI = cfg.II, cfg.P, max(1, cfg.LI)
        lanes = [np.nonzero(np.asarray(cfg.op)[s] == OPC_STORE)[0]
                 for s in range(II)]
        S = max(1, max((len(l) for l in lanes), default=0))
        store_lanes = np.full((II, S), -1, dtype=np.int8 if P <= 127
                              else np.int16)
        for s, l in enumerate(lanes):
            store_lanes[s, :len(l)] = l
        rf_kind = np.asarray(p["rf_kind"])
        rf_idx = np.asarray(p["rf_idx"])
        if R > cfg.RF:                   # pad write-port bank: dead lanes
            pad = ((0, 0), (0, 0), (0, R - cfg.RF))
            rf_kind = np.pad(rf_kind, pad, constant_values=KIND_NONE)
            rf_idx = np.pad(rf_idx, pad, constant_values=0)
        kind_all = np.concatenate(
            [p["src_kind"], rf_kind, p["xo_kind"]], axis=2)
        idx_all = np.concatenate(
            [p["src_idx"], rf_idx, p["xo_idx"]], axis=2)
        cached = {
            "op": np.asarray(p["op"]), "imm": np.asarray(p["imm"]),
            "port_idx": _port_gather_idx(kind_all, idx_all, cfg, LI, R),
            "rf_mask": rf_kind != KIND_NONE,
            "xo_mask": np.asarray(p["xo_kind"]) != KIND_NONE,
            "force_before": np.asarray(p["force_before"]),
            "force_val": np.asarray(p["force_val"]),
            "mem_off": np.asarray(p["mem_off"]),
            "mem_words": np.asarray(p["mem_words"]),
            "valid_start": np.asarray(p["valid_start"]),
            "store_lanes": store_lanes,
        }
        for k in SimConfig._ARRAY_DTYPES:
            arr = getattr(cfg, k)
            if isinstance(arr, np.ndarray):
                arr.flags.writeable = False
        by_rf[R] = cached
    return cached


# ------------------------------------------------------- device planes
def _state_remap(P: int, RF: int, LI: int) -> np.ndarray:
    """Map from the JAX package's state layout (``_state_layout``) to the
    body's own, where each PE's register file and crossbar outputs sit
    side by side ([ wr = (regs RF | xo 4) per PE | fu | imm | li | zero ])
    so both write banks update with one select.  fu, imm, li and zero keep
    their offsets."""
    xo_off, reg_off, fu_off, _, _, zero_off = _state_layout(P, RF, LI)
    remap = np.arange(zero_off + 1, dtype=np.int64)
    i = np.arange(P * 4)
    remap[xo_off + i] = (i // 4) * (RF + 4) + RF + i % 4
    i = np.arange(P * RF)
    remap[reg_off + i] = (i // RF) * (RF + 4) + i % RF
    assert fu_off == P * (RF + 4)
    return remap


class _Slot:
    """One II slot's planes on the device, with the host-side facts about
    them that decide which ops a cycle of this slot runs."""

    def __init__(self, pl: Dict[str, np.ndarray], *, P: int, RF: int,
                 LI: int, bits: int, multi: bool, dev: torch.device):
        t = functools.partial(torch.as_tensor, device=dev)
        op = pl["op"].astype(np.int64)                     # [P] | [B,P]
        op = np.where(np.isin(op, [*_ALU, OPC_NONE, OPC_LOAD, OPC_STORE]),
                      op, _ZERO_OP)
        self.alu_ops = sorted(int(o) for o in np.unique(op) if o in _ALU)
        alu_lane = np.isin(op, self.alu_ops)
        self.alu_mask = t(alu_lane)
        # position of each lane's opcode among the slot's ALU ops
        idx = np.zeros(op.shape, dtype=np.int64)
        for i, o in enumerate(self.alu_ops):
            idx[op == o] = i
        self.alu_idx = t(idx[None])                        # [1,(B,)P]
        is_load = op == OPC_LOAD
        self.has_load = bool(is_load.any())
        self.is_load = t(is_load)
        K = pl["port_idx"].shape[-1]
        pidx = _state_remap(P, RF, LI)[pl["port_idx"].astype(np.int64)]
        self.pidx = t(pidx.reshape(-1 if multi else 1, P * K))
        self.imm = t(pl["imm"].astype(_np_dt(bits)))
        fb = pl["force_before"].astype(np.int64)
        self.fb_max = int(fb.max()) if fb.size else 0
        self.force_before = t(fb)
        self.force_val = t(pl["force_val"].astype(_np_dt(bits)))
        wmask = np.concatenate([pl["rf_mask"], pl["xo_mask"]], axis=-1)
        self.has_write = bool(wmask.any())
        self.wmask = t(wmask)
        # memory ports: only LOAD/STORE lanes use their address, and each
        # of those has a bank (mem_words > 0), so clipping into [0,
        # max(words-1, 0)] is exact wherever it matters
        is_store = op == OPC_STORE
        words = pl["mem_words"].astype(np.int64)
        assert (words[is_load | is_store] > 0).all(), \
            "a LOAD/STORE lane without a bank"
        self.mem_off = pl["mem_off"].astype(np.int64)
        hi = np.maximum(words - 1, 0)
        cdt = _np_dt(bits) if hi.max(initial=0) <= np.iinfo(
            _np_dt(bits)).max else np.int32
        self.addr_dt = torch.int16 if cdt == np.int16 else torch.int32
        self.addr_lo = t(np.zeros_like(hi).astype(cdt))
        self.addr_hi = t(hi.astype(cdt))
        # store lanes: single-config slots keep only their live lanes;
        # stacked ones keep the [B,S] table, dead lanes (-1) never gated
        sl = pl["store_lanes"].astype(np.int64)
        vs = pl["valid_start"].astype(np.int64)
        if multi:
            slc = np.clip(sl, 0, P - 1)
            lane_vs = np.where(sl >= 0, np.take_along_axis(vs, slc, axis=1),
                               _NEVER)
        else:
            slc = sl[sl >= 0]
            lane_vs = vs[slc]
        self.has_store = bool((sl >= 0).any())
        self.store_lanes = t(slc)
        self.lane_vs = lane_vs                              # host, int64
        self.multi = multi


# valid-start of a dead (padded) store lane: its window never opens
_NEVER = 1 << 60


def _np_dt(bits: int):
    return np.int16 if bits == 16 else np.int32


class _Planes:
    """Every slot of one configuration (or one stacked group) on one
    device: the device-side form of ``_host_planes``."""

    def __init__(self, planes: Dict[str, np.ndarray], *, II: int, P: int,
                 RF: int, LI: int, bits: int, multi: bool,
                 dev: torch.device):
        self.II = II
        self.multi = multi
        pick = (lambda k, s: planes[k][:, s]) if multi else \
            (lambda k, s: planes[k][s])
        self.slots = [
            _Slot({k: pick(k, s) for k in _SLOT_PLANES}, P=P, RF=RF, LI=LI,
                  bits=bits, multi=multi, dev=dev)
            for s in range(II)]


def _device_planes(cfg: SimConfig, dev: torch.device) -> _Planes:
    """``_host_planes(cfg)`` on ``dev``, cached on the SimConfig per
    device (``cfg._torch_planes``), so repeated runs/verifies skip the
    host-side compilation and the transfer."""
    by_dev = getattr(cfg, "_torch_planes", None)
    if by_dev is None:
        by_dev = cfg._torch_planes = {}
    cached = by_dev.get(dev)
    if cached is None:
        cached = by_dev[dev] = _Planes(
            _host_planes(cfg), II=cfg.II, P=cfg.P, RF=cfg.RF,
            LI=max(1, cfg.LI), bits=cfg.bits, multi=False, dev=dev)
    return cached


# ------------------------------------------------------------------ body
class _Gates:
    """The store gate of every cycle, per slot: ``table[s][r]`` is the
    gate of cycle ``s + r*II`` on the device, ``any_on``/``all_on`` its
    host-side summary."""

    def __init__(self, c: _Planes, n_iters: int, n_cycles: int,
                 dev: torch.device):
        II = c.II
        self.table, self.any_on, self.all_on = [], [], []
        for s, sp in enumerate(c.slots):
            ts = np.arange(s, n_cycles, II, dtype=np.int64)
            shape = (len(ts),) + (1,) * sp.lane_vs.ndim
            tt = ts.reshape(shape)
            g = (sp.lane_vs <= tt) & (tt < sp.lane_vs + n_iters * II)
            flat = g.reshape(len(ts), -1)
            self.any_on.append(flat.any(axis=1).tolist())
            self.all_on.append(flat.all(axis=1).tolist())
            self.table.append(torch.as_tensor(g, device=dev))


def _gate_bytes(c: _Planes, n_cycles: int) -> int:
    """Bytes of ``_Gates``' table for ``n_cycles``: one bool per store
    lane (of every row, when stacked) and cycle."""
    return sum(len(range(s, n_cycles, c.II)) * sp.lane_vs.size
               for s, sp in enumerate(c.slots))


def _sim_body(c: _Planes, mem0: torch.Tensor, li_stack: torch.Tensor, *,
              II: int, P: int, RF: int, bits: int, n_iters: int,
              n_cycles: int, cfg_batched: bool = False) -> torch.Tensor:
    """A batch of memory images through all invocations.

    ``mem0``: [batch, words] initial images on the device (batch=1 is the
    sequential path).  Per batch row the computation is op-for-op the
    JAX package's ``_sim_body``, so results are bit-identical per element.

    ``cfg_batched=True`` is the multi-architecture variant: every config
    plane carries a leading batch-row axis (one config per memory image;
    ``li_stack`` is ``[n_inv, B, P, LI]``), so one cycle loop simulates
    many *different* fabrics sharing the static shape tuple.
    """
    B, W = mem0.shape
    dev = mem0.device
    LI = li_stack.shape[-1]
    dt = _dp_dtype(bits)
    K = 3 + RF + 4
    row_off = torch.arange(B, device=dev, dtype=torch.int64)[:, None] * W
    scratch = row_off + (W - 1)                           # [B,1] per row
    mem = mem0.reshape(-1).clone()
    pretile = _gate_bytes(c, n_cycles) <= _TILE_BYTES_LIMIT
    gates = _Gates(c, n_iters, n_cycles, dev) if pretile else None
    # per-call forms of the slot planes: memory bases per image row, and
    # the gather index over the whole batch
    base = [row_off + torch.as_tensor(sp.mem_off, device=dev)
            for sp in c.slots]
    pidx = [sp.pidx.expand(B, -1) for sp in c.slots]
    alu_idx = [sp.alu_idx.expand(1, B, P) for sp in c.slots]
    if not pretile:
        lane_vs = [torch.as_tensor(sp.lane_vs, device=dev)
                   for sp in c.slots]
        lane_ve = [v + n_iters * II for v in lane_vs]
    zero_cell = torch.zeros((B, 1), dtype=dt, device=dev)

    def store(s: int, t: int, sp: _Slot, gaddr: torch.Tensor,
              b: torch.Tensor) -> None:
        gate = None
        if gates is not None:
            r = t // II
            if not gates.any_on[s][r]:
                return                    # every lane gated off: no-op
            if not gates.all_on[s][r]:
                gate = gates.table[s][r]
        else:
            gate = (lane_vs[s] <= t) & (lane_ve[s] > t)
        if sp.multi:
            st_addr = torch.gather(gaddr, 1, sp.store_lanes)
            st_val = torch.gather(b, 1, sp.store_lanes)
        else:
            st_addr = gaddr.index_select(1, sp.store_lanes)
            st_val = b.index_select(1, sp.store_lanes)
        if gate is not None:
            # gated-off lanes write the scratch word's own value back
            st_addr = torch.where(gate, st_addr, scratch)
            st_val = torch.where(gate, st_val, mem.take(scratch))
        if _CHECK_STORES:
            _check_store_addresses(st_addr, gate, scratch, t)
        mem.index_put_((st_addr.reshape(-1),), st_val.reshape(-1))

    for inv in range(li_stack.shape[0]):
        li = li_stack[inv].to(dt)
        li_flat = li.reshape(B, P * LI) if cfg_batched else \
            li.reshape(1, P * LI).expand(B, -1)
        wr = torch.zeros((B, P, RF + 4), dtype=dt, device=dev)
        fu = torch.zeros((B, P), dtype=dt, device=dev)
        ldp = torch.zeros((B, P), dtype=dt, device=dev)
        fl: Optional[torch.Tensor] = None      # last cycle's LOAD lanes
        for t in range(n_cycles):
            s = t % II
            sp = c.slots[s]
            imm = sp.imm if cfg_batched else sp.imm.expand(B, P)
            # the whole mux fabric (operand + RF-write + crossbar-write
            # ports) resolves as one gather from the start-of-cycle state
            state = torch.cat([wr.view(B, -1), fu, imm, li_flat,
                               zero_cell], dim=1)
            v = torch.gather(state, 1, pidx[s]).view(B, P, K)
            ops = v[:, :, :3]
            if t < sp.fb_max:
                ops = torch.where(sp.force_before > t, sp.force_val, ops)
            a, b, p3 = ops[:, :, 0], ops[:, :, 1], ops[:, :, 2]

            res = fu
            if sp.alu_ops:
                outs = [_ALU[o](a, b, p3, bits) for o in sp.alu_ops]
                r = outs[0] if len(outs) == 1 else torch.gather(
                    torch.stack(outs), 0, alu_idx[s])[0]
                res = torch.where(sp.alu_mask, _wrap(r, bits), fu)
            fu_next = res if fl is None else torch.where(fl, ldp, res)

            if sp.has_load or sp.has_store:
                gaddr = base[s] + torch.clamp(a.to(sp.addr_dt), sp.addr_lo,
                                              sp.addr_hi)
                if sp.has_load:
                    ldp = torch.where(sp.is_load, mem.take(gaddr), ldp)
                if sp.has_store:
                    store(s, t, sp, gaddr, b)
            fl = sp.is_load if sp.has_load else None

            # register-file and crossbar writes from the resolved ports
            if sp.has_write:
                wr = torch.where(sp.wmask, v[:, :, 3:], wr)
            fu = fu_next
    return mem.view(B, W)


def _check_store_addresses(st_addr: torch.Tensor,
                           gate: Optional[torch.Tensor],
                           scratch: torch.Tensor, t: int) -> None:
    """Within one cycle, no two gated-on lanes of a memory image may share
    an address, and a gated-off lane writes only the scratch word."""
    addr = st_addr.cpu().numpy()
    on = np.ones(addr.shape, bool) if gate is None else \
        np.broadcast_to(gate.cpu().numpy(), addr.shape)
    scr = scratch.cpu().numpy()[:, 0]
    for row in range(addr.shape[0]):
        live = addr[row][on[row]]
        assert len(np.unique(live)) == len(live), \
            f"cycle {t}: two stores to one word in image {row}: {live}"
        assert (addr[row][~on[row]] == scr[row]).all()


def _runner(sig: simcache.SimSignature):
    """The cached object for one batched-simulator signature: the body
    bound to the signature's static values.  The cycle count is the
    caller's: an eager loop gains nothing from the signature's bucketed
    count, so it runs the exact one (``n_cycles=``)."""
    return functools.partial(_sim_body, II=sig.II, P=sig.P, RF=sig.RF,
                             bits=sig.bits, n_iters=sig.n_iters,
                             cfg_batched=sig.multi)


def _banks_to_mem(cfg: SimConfig, banks: Dict[str, np.ndarray]) -> np.ndarray:
    mem = np.zeros(cfg.total_words,
                   dtype=np.int16 if cfg.bits == 16 else np.int32)
    for bid, off in cfg.bank_offsets.items():
        img = banks[f"bank{bid}"]
        mem[off:off + len(img)] = img
    return mem


def _mem_to_banks(cfg: SimConfig, mem: np.ndarray,
                  banks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"bank{bid}": mem[off:off + len(banks[f"bank{bid}"])]
            for bid, off in cfg.bank_offsets.items()}


def _to_host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def simulate(cfg: SimConfig, banks: Dict[str, np.ndarray],
             invocations, n_iters: int,
             liveins_builder=None, device=None) -> Dict[str, np.ndarray]:
    """Run the mapped kernel for every invocation and return final banks.

    banks: {"bank<i>": int array} initial memory images.
    invocations: list of {livein name: value} dicts (host outer loops).
    device: where the cycle loop runs (``None``: the CUDA card).
    """
    dev = resolve_device(device)
    mem = _banks_to_mem(cfg, banks)
    if not len(invocations):
        # nothing to run: the final image is the initial image
        return _mem_to_banks(cfg, mem, banks)

    li_stack = np.stack([cfg.livein_array(inv) for inv in invocations])
    out = _sim_body(
        _device_planes(cfg, dev), torch.as_tensor(mem[None, :], device=dev),
        torch.as_tensor(li_stack, device=dev),
        II=cfg.II, P=cfg.P, RF=cfg.RF, bits=cfg.bits,
        n_iters=n_iters, n_cycles=cfg.n_cycles(n_iters))
    return _mem_to_banks(cfg, _to_host(out)[0], banks)


def simulate_batch(cfg: SimConfig, banks_batch: List[Dict[str, np.ndarray]],
                   invocations, n_iters: int,
                   device=None) -> List[Dict[str, np.ndarray]]:
    """Run the same mapped kernel over a batch of initial memory images.

    All images share one configuration and invocation schedule (the batch
    axis is seeds / test vectors, not kernels), so the whole batch is one
    batched cycle loop: per-element results are bit-identical to
    ``simulate`` on that element.  The runner comes from the process-wide
    shape-bucketed cache (``simcache``): batch is rounded up to a power of
    two (padded images are simulated and dropped).  The signature carries
    the bucketed cycle count, as the JAX package's does, but the loop runs
    the kernel's exact ``cfg.n_cycles(n_iters)``.
    """
    dev = resolve_device(device)
    B = len(banks_batch)
    if B == 0:
        return []
    mem = np.stack([_banks_to_mem(cfg, banks) for banks in banks_batch])
    if not len(invocations):
        return [_mem_to_banks(cfg, mem[i], banks_batch[i]) for i in range(B)]

    li_stack = np.stack([cfg.livein_array(inv) for inv in invocations])
    sig = simcache.SimSignature(
        II=cfg.II, P=cfg.P, RF=cfg.RF, bits=cfg.bits, n_iters=n_iters,
        n_cycles=simcache.bucket_cycles(cfg.n_cycles(n_iters)),
        batch=simcache.bucket_batch(B))
    if sig.batch > B:  # pad to the bucket; padded rows are masked out below
        mem = np.concatenate(
            [mem, np.repeat(mem[-1:], sig.batch - B, axis=0)])
    fn = simcache.get(sig, lambda: _runner(sig))
    out = _to_host(fn(_device_planes(cfg, dev),
                      torch.as_tensor(mem, device=dev),
                      torch.as_tensor(li_stack, device=dev),
                      n_cycles=cfg.n_cycles(n_iters)))
    return [_mem_to_banks(cfg, out[i], banks_batch[i]) for i in range(B)]


# ------------------------------------------------- multi-architecture batch
def stack_signature(cfg: SimConfig, n_iters: int,
                    n_invocations: int) -> Tuple[int, ...]:
    """The shape bucket a (config, schedule) pair simulates in.

    Configs agreeing on this tuple can be stacked into one multi-arch
    cycle loop (``simulate_multi``).  The cycle count enters bucketed, so
    near-miss schedule depths stack too (padded cycles are store-gated
    no-ops); the register-file width enters bucketed
    (``simcache.bucket_rf``), so fabrics differing only in RF provisioning
    stack too — each config's planes pad to the bucket with dead write
    ports, and its own reads never index past its real RF.
    """
    return (cfg.II, cfg.P, simcache.bucket_rf(cfg.RF), cfg.bits,
            max(1, cfg.LI), n_iters, n_invocations,
            simcache.bucket_cycles(cfg.n_cycles(n_iters)))


def _stack_planes(per: List[Dict[str, np.ndarray]],
                  reps: List[int]) -> Dict[str, np.ndarray]:
    """Stack per-config host planes into ``[B, II, ...]`` rows, repeating
    each config for its memory-image count.  Store-lane tables pad to the
    group-wide lane count with -1 (dead lanes); value planes promote to
    the group's common dtype — both value-preserving, so stacked rows
    decode exactly as their single-config originals."""
    S = max(p["store_lanes"].shape[1] for p in per)
    out: Dict[str, np.ndarray] = {}
    for k in per[0]:
        arrs = []
        for p, rep in zip(per, reps):
            a = p[k]
            if k == "store_lanes" and a.shape[1] < S:
                a = np.concatenate(
                    [a, np.full((a.shape[0], S - a.shape[1]), -1,
                                dtype=a.dtype)], axis=1)
            arrs.append(np.repeat(a[None], rep, axis=0))
        dtype = np.result_type(*(a.dtype for a in arrs))
        out[k] = np.concatenate([a.astype(dtype, copy=False)
                                 for a in arrs], axis=0)
    return out


# stacked-plane device cache: the multi-arch analogue of the per-config
# ``_torch_planes`` memo.  Keyed by config identities and the device (the
# cached tuple holds strong refs, so an id can never be recycled while its
# key is live); bounded FIFO keeps one search's worth of groups.
_STACK_PLANES_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_STACK_PLANES_MAX = 32


def _stacked_device_planes(cfgs: Tuple[SimConfig, ...],
                           reps: Tuple[int, ...], pad: int, rf_pad: int,
                           dev: torch.device) -> _Planes:
    key = (tuple(id(c) for c in cfgs), reps, pad, rf_pad, dev)
    hit = _STACK_PLANES_CACHE.get(key)
    if hit is not None:
        _STACK_PLANES_CACHE.move_to_end(key)
        return hit[1]
    planes = _stack_planes([_host_planes(c, rf_pad) for c in cfgs],
                           list(reps))
    if pad:  # pad to the batch bucket by repeating the last config row
        planes = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                  for k, v in planes.items()}
    c0 = cfgs[0]
    dp = _Planes(planes, II=c0.II, P=c0.P, RF=rf_pad, LI=max(1, c0.LI),
                 bits=c0.bits, multi=True, dev=dev)
    _STACK_PLANES_CACHE[key] = (cfgs, dp)
    while len(_STACK_PLANES_CACHE) > _STACK_PLANES_MAX:
        _STACK_PLANES_CACHE.popitem(last=False)
    return dp


def simulate_multi(items: Sequence[Tuple[SimConfig,
                                         List[Dict[str, np.ndarray]],
                                         List[Dict[str, int]]]],
                   n_iters: int,
                   device=None) -> List[List[Dict[str, np.ndarray]]]:
    """Simulate many *configurations* in one batched cycle loop.

    ``items``: a list of ``(cfg, banks_batch, invocations)`` triples — all
    sharing one :func:`stack_signature` — e.g. the same kernel compiled
    onto many candidate fabrics of a design-space search, each with its
    own seed batch.  Config planes are stacked along the batch axis next
    to the memory images; per (config, image) element the result is
    bit-identical to ``simulate_batch`` on that config alone.

    Memory rows pad to the group's widest image (each config addresses
    only its own ``total_words``; the shared scratch word sits at the
    padded row end), the batch rounds up to its bucket
    (``simcache.bucket_rows``), and every config's register file pads to
    the group's RF bucket (``simcache.bucket_rf``) with dead write ports.
    The loop runs the deepest config's exact cycle count; the shallower
    ones' extra cycles are store-gated no-ops.
    Returns one list of final-banks dicts per item, in item order.
    """
    dev = resolve_device(device)
    items = [(cfg, list(bb), list(inv)) for cfg, bb, inv in items]
    out: List[List[Dict[str, np.ndarray]]] = [[] for _ in items]
    live = [i for i, (_, bb, _inv) in enumerate(items) if bb]
    if not live:
        return out
    sigs = sorted({stack_signature(items[i][0], n_iters, len(items[i][2]))
                   for i in live})
    if len(sigs) != 1:
        raise ValueError(
            f"simulate_multi: items span {len(sigs)} shape buckets "
            f"{sigs}; stack only configs sharing one stack_signature")
    II, P, RF, bits, LI, _, n_inv, n_cycles = sigs[0]
    if n_inv == 0:
        # nothing to run: final images are the initial images
        for i in live:
            cfg, bb, _ = items[i]
            out[i] = [_mem_to_banks(cfg, _banks_to_mem(cfg, b), b)
                      for b in bb]
        return out
    if len(live) == 1:
        # a group of one is the plain batched path (shares its runner
        # with every non-stacked caller)
        i = live[0]
        cfg, bb, inv = items[i]
        out[i] = simulate_batch(cfg, bb, inv, n_iters, device=dev)
        return out

    reps = [len(items[i][1]) for i in live]
    B = sum(reps)
    W = max(items[i][0].total_words for i in live)
    mem = np.zeros((B, W), dtype=np.int16 if bits == 16 else np.int32)
    row = 0
    for i in live:
        cfg, bb, _ = items[i]
        for b in bb:
            mem[row, :cfg.total_words] = _banks_to_mem(cfg, b)
            row += 1
    li = np.concatenate(
        [np.repeat(np.stack([items[i][0].livein_array(inv)
                             for inv in items[i][2]])[:, None],
                   rep, axis=1)
         for i, rep in zip(live, reps)], axis=1)       # [n_inv,B,P,LI]
    sig = simcache.SimSignature(
        II=II, P=P, RF=RF, bits=bits, n_iters=n_iters, n_cycles=n_cycles,
        batch=simcache.bucket_rows(B), LI=LI, multi=True)
    pad = sig.batch - B
    if pad:  # pad to the bucket by repeating the last row everywhere
        mem = np.concatenate([mem, np.repeat(mem[-1:], pad, axis=0)])
        li = np.concatenate([li, np.repeat(li[:, -1:], pad, axis=1)],
                            axis=1)
    planes = _stacked_device_planes(tuple(items[i][0] for i in live),
                                    tuple(reps), pad, RF, dev)
    fn = simcache.get(sig, lambda: _runner(sig))
    depth = max(items[i][0].n_cycles(n_iters) for i in live)
    res = _to_host(fn(planes, torch.as_tensor(mem, device=dev),
                      torch.as_tensor(li, device=dev), n_cycles=depth))
    row = 0
    for i in live:
        cfg, bb, _ = items[i]
        out[i] = []
        for b in bb:
            out[i].append(_mem_to_banks(cfg, res[row], b))
            row += 1
    return out
