"""Batched DFG reference execution in PyTorch (the fast oracle).

The port of ``repro.core.refexec``.  ``DFG.reference_execute`` is the
verification oracle of the paper's IV-C flow: sequential, non-pipelined
dataflow execution of the mapped loop.  Here the same program runs as a
double loop — over invocations, then over loop iterations — with every
node value a ``[batch]`` int32 vector on ``device`` and the bank images
one flat buffer.  Node semantics mirror the interpreter op for op: values
wrap to the datapath width after every node, out-of-range loads read 0,
out-of-range stores drop (they scatter into a dump cell that is never
read back), and loop-carried operands read their ``init`` value for the
first ``dist`` iterations.

Values the host already knows stay Python ints: constants, live-ins (one
value per invocation, wrapped with ``dfg.wrap`` on the host), a
loop-carried read in the iterations before its producer has run, and any
ALU node whose operands are all such ints (computed with the same wrap).
The iteration counter is a host int too, so the "first ``dist``
iterations" rule is a host branch and the history a list of the last
values; only work on the seed batch launches anything.

The lowered node plan (topological order, operand bindings, history
depths) is cached on the DFG instance (``_torch_refexec_cache``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .dfg import DFG, Op, wrap

Value = Union[int, torch.Tensor]


def _host_alu(op: Op, a: int, b: int, c: int, bits: int) -> int:
    """One ALU node on host ints, wrapped like the tensor path."""
    if op == Op.ADD:
        r = a + b
    elif op == Op.SUB:
        r = a - b
    elif op == Op.MUL:
        r = a * b
    elif op == Op.SHL:
        r = a << (b & (bits - 1))
    elif op == Op.SHR:
        r = a >> (b & (bits - 1))
    elif op == Op.AND:
        r = a & b
    elif op == Op.OR:
        r = a | b
    elif op == Op.XOR:
        r = a ^ b
    elif op == Op.CMPGE:
        r = int(a >= b)
    elif op == Op.CMPEQ:
        r = int(a == b)
    elif op == Op.CMPLT:
        r = int(a < b)
    elif op == Op.SELECT:
        r = b if a != 0 else c
    else:
        raise NotImplementedError(op)
    return wrap(r, bits)


def _tensor_alu(op: Op, a: Value, b: Value, c: Value, bits: int,
                like: torch.Tensor) -> Value:
    """One ALU node with at least one tensor operand.  Operands are
    already wrapped, so only the ops that can leave the range (add, sub,
    mul, shl) wrap their result; bitwise ops, right shifts, compares and
    selects of in-range values stay in range."""
    if op == Op.SELECT:
        if not isinstance(a, torch.Tensor):
            return b if a != 0 else c
        if not isinstance(b, torch.Tensor):
            b = torch.full_like(like, b)
        return torch.where(a != 0, b, c)
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, a)
    if op == Op.CMPGE:
        return (a >= b).to(torch.int32)
    if op == Op.CMPEQ:
        return (a == b).to(torch.int32)
    if op == Op.CMPLT:
        return (a < b).to(torch.int32)
    if op == Op.SHR:
        return a >> (b & (bits - 1))
    if op == Op.AND:
        return a & b
    if op == Op.OR:
        return a | b
    if op == Op.XOR:
        return a ^ b
    if op == Op.ADD:
        r = a + b
    elif op == Op.SUB:
        r = a - b
    elif op == Op.MUL:
        r = a * b
    elif op == Op.SHL:
        r = a << (b & (bits - 1))
    else:
        raise NotImplementedError(op)
    if bits >= 32:             # int32 overflow is the 32-bit wrap
        return r
    half = 1 << (bits - 1)
    return ((r + half) & ((1 << bits) - 1)) - half


def _plan(dfg: DFG):
    """The node program: (vid, node) in topological order and the history
    depth each producer needs for its loop-carried readers."""
    cache = getattr(dfg, "_torch_refexec_cache", None)
    if cache is None:
        order = dfg.topo_order()
        nodes = [dfg.nodes[vid] for vid in order]
        maxdist = {vid: 0 for vid in order}
        for n in nodes:
            for o in n.operands:
                maxdist[o.src] = max(maxdist[o.src], o.dist)
        cache = dfg._torch_refexec_cache = (list(zip(order, nodes)),
                                            maxdist)
    return cache


def reference_execute_torch(dfg: DFG, n_iters: int,
                            init_banks: Dict[str, np.ndarray],
                            invocations: Sequence[Dict[str, int]],
                            bits: int, device=None) -> Dict[str, np.ndarray]:
    """Fold batched DFG reference execution over all invocations on
    ``device`` (``None``: the CUDA card).

    init_banks: name -> [batch, words] int arrays; returns a fresh dict of
    the same shape (int64), bit-identical per row to folding
    ``DFG.reference_execute`` over the invocations.
    """
    dev = resolve_device(device)
    prog, maxdist = _plan(dfg)
    names = sorted(init_banks)
    banks: Tuple[Tuple[str, int], ...] = tuple(
        (k, int(np.asarray(init_banks[k]).shape[1])) for k in names)
    B = int(np.asarray(init_banks[names[0]]).shape[0]) if names else 1

    off: Dict[str, int] = {}
    tot = 0
    for name, w in banks:
        off[name] = tot
        tot += w
    dump = tot                 # one never-read cell for dropped stores
    stride = tot + 1
    widths = dict(banks)

    mem0 = np.zeros((B, stride), dtype=np.int32)
    for k, w in banks:
        mem0[:, off[k]:off[k] + w] = np.asarray(init_banks[k])
    mem = torch.as_tensor(mem0.reshape(-1), device=dev)
    row = torch.arange(B, device=dev, dtype=torch.int64) * stride
    like = torch.zeros(B, dtype=torch.int32, device=dev)

    for inv in invocations:
        hist: Dict[int, List[Value]] = {vid: [] for vid, d in maxdist.items()
                                        if d}

        def read(o, cur) -> Value:
            if o.dist == 0:
                return cur[o.src]
            h = hist[o.src]
            if len(h) < o.dist:        # iteration < dist: the init value
                return wrap(o.init, bits)
            return h[-o.dist]

        for _it in range(n_iters):
            cur: Dict[int, Value] = {}
            for vid, n in prog:
                if n.op == Op.CONST:
                    cur[vid] = wrap(n.imm, bits)
                elif n.op == Op.LIVEIN:
                    cur[vid] = wrap(inv[n.livein], bits)
                elif n.op == Op.LOAD:
                    addr = read(n.operands[0], cur)
                    w = widths[n.array]
                    if isinstance(addr, int):
                        cur[vid] = (mem.take(row + off[n.array] + addr)
                                    if 0 <= addr < w else 0)
                    else:
                        ok = (addr >= 0) & (addr < w)
                        fidx = row + off[n.array] + addr.clamp(0, w - 1)
                        cur[vid] = torch.where(ok, mem.take(fidx), 0)
                elif n.op == Op.STORE:
                    addr = read(n.operands[0], cur)
                    val = read(n.operands[1], cur)
                    w = widths[n.array]
                    if isinstance(addr, int):
                        fidx = row + (off[n.array] + addr
                                      if 0 <= addr < w else dump)
                    else:
                        ok = (addr >= 0) & (addr < w)
                        fidx = row + torch.where(
                            ok, off[n.array] + addr.clamp(0, w - 1), dump)
                    if isinstance(val, int):
                        val = torch.full_like(like, val)
                    mem.index_put_((fidx,), val)
                    cur[vid] = 0
                else:
                    ops = [read(o, cur) for o in n.operands]
                    a = ops[0]
                    b = ops[1] if len(ops) > 1 else 0
                    c = ops[2] if len(ops) > 2 else 0
                    if any(isinstance(x, torch.Tensor) for x in (a, b, c)):
                        cur[vid] = _tensor_alu(n.op, a, b, c, bits, like)
                    else:
                        cur[vid] = _host_alu(n.op, a, b, c, bits)
            for vid, h in hist.items():
                h.append(cur[vid])
                if len(h) > maxdist[vid]:
                    del h[0]

    out = mem.view(B, stride).cpu().numpy()
    return {k: out[:, off[k]:off[k] + w].astype(np.int64) for k, w in banks}
