"""Trace-based kernel DSL: the Pallas-style front end over the DFG IR.

Users write the body of the *mapped* loop level as restricted Python over a
:class:`KernelContext` — loads/stores through :class:`ArrayRef` handles,
arithmetic on :class:`TracedValue` operands, induction variables through
``ctx.counter`` / ``ctx.wrapping_counter`` / ``ctx.gated_counter`` — and the
tracer lowers it to the existing :class:`~repro_torch.core.dfg.DFG`:

    def body(ctx):
        X, Y = ctx.arrays("X", "Y")
        n = ctx.counter(stop=N - 1, name="n")
        Y[n] = X[n] * 3

    dfg = trace(body, name="triple", layout=layout)

Tracing rules (what "restricted Python" means):

  * Plain Python ints stay compile-time: ``k1 * K + k2`` over ints emits no
    nodes; an int only materializes as a CONST node when it meets a traced
    value (constants and live-ins are CSE-cached, like the LLVM pass).
  * ``tv + 0`` / ``tv - 0`` fold away — so base offsets of bank-resident
    arrays and zero unroll offsets cost nothing, exactly as a hand-built
    DFG would elide them.
  * Python ``for`` loops over ``range`` are compile-time unrolling; the
    :func:`unroll` helper is the declarative spelling of the same thing.
  * Loop-carried scalar state is declared through the counter primitives
    (which patch the self-referential ``dist=1`` operands), and carried
    memory recurrences through ``ctx.loop_carried(store, load)``.

The tracer emits nodes in Python evaluation order, so a DSL kernel written
in the shape of its loop body produces the *same canonical DFG* as the
hand-built ``DFGBuilder`` wiring it replaces (``DFG.canonical_dict`` — node
names are cosmetic and excluded).  That is the front-end contract the
legacy Table-I kernels are pinned to in ``tests/test_frontend.py``.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Union

from ..core.dfg import DFG, DFGBuilder, Node, Op, Operand
from ..core.layout import DataLayout


class TraceError(TypeError):
    """A DSL kernel stepped outside the restricted-Python subset."""


IntOrTraced = Union[int, "TracedValue"]


class TracedValue:
    """A scalar SSA value inside a traced kernel body.

    Wraps one DFG node id; arithmetic operators emit new nodes on the
    owning context.  Comparisons return traced 0/1 values (CMPGE/CMPEQ/
    CMPLT), not Python bools — use them only as SELECT conditions.
    """
    __slots__ = ("ctx", "id")

    def __init__(self, ctx: "KernelContext", nid: int):
        self.ctx = ctx
        self.id = nid

    def __repr__(self) -> str:
        n = self.ctx._b.dfg.nodes[self.id]
        return f"<traced {n.op.value}#{self.id}>"

    def __bool__(self) -> bool:
        raise TraceError(
            "traced values have no compile-time truth value; use select() "
            "for data-dependent choices (Python `if` over traced values "
            "would un-trace the branch)")

    def __hash__(self):
        return hash((id(self.ctx), self.id))

    # ---------------------------------------------------------- arithmetic
    def __add__(self, o: IntOrTraced) -> "TracedValue":
        if isinstance(o, int) and o == 0:
            return self
        return self.ctx._node(Op.ADD, (self, o))

    def __radd__(self, o: int) -> "TracedValue":
        if o == 0:
            return self
        return self.ctx._node(Op.ADD, (o, self))

    def __sub__(self, o: IntOrTraced) -> "TracedValue":
        if isinstance(o, int) and o == 0:
            return self
        return self.ctx._node(Op.SUB, (self, o))

    def __rsub__(self, o: int) -> "TracedValue":
        return self.ctx._node(Op.SUB, (o, self))

    def __mul__(self, o: IntOrTraced) -> "TracedValue":
        if isinstance(o, int) and o == 1:
            return self
        return self.ctx._node(Op.MUL, (self, o))

    def __rmul__(self, o: int) -> "TracedValue":
        if o == 1:
            return self
        return self.ctx._node(Op.MUL, (o, self))

    def __lshift__(self, o: IntOrTraced) -> "TracedValue":
        return self.ctx._node(Op.SHL, (self, o))

    def __rshift__(self, o: IntOrTraced) -> "TracedValue":
        return self.ctx._node(Op.SHR, (self, o))

    def __and__(self, o: IntOrTraced) -> "TracedValue":
        return self.ctx._node(Op.AND, (self, o))

    def __or__(self, o: IntOrTraced) -> "TracedValue":
        return self.ctx._node(Op.OR, (self, o))

    def __xor__(self, o: IntOrTraced) -> "TracedValue":
        return self.ctx._node(Op.XOR, (self, o))

    # -------------------------------------------------------- comparisons
    def __ge__(self, o: IntOrTraced) -> "TracedValue":
        return self.ctx._node(Op.CMPGE, (self, o))

    def __lt__(self, o: IntOrTraced) -> "TracedValue":
        return self.ctx._node(Op.CMPLT, (self, o))

    def __eq__(self, o: IntOrTraced) -> "TracedValue":  # type: ignore[override]
        return self.ctx._node(Op.CMPEQ, (self, o))

    def __ne__(self, o):  # pragma: no cover - guard
        raise TraceError("!= is not a CGRA op; use (a == b) ^ 1")


class ArrayRef:
    """Bank-resident array handle: Pallas-``Ref``-style load/store sugar.

    ``arr[idx]`` loads, ``arr[idx] = val`` stores; ``idx`` is a flat index
    into the array (int or traced) and the data layout's base offset is
    folded into the address exactly once.  For hand-scheduled address reuse
    (unrolled bodies), ``arr.addr(idx)`` returns the based address value
    and ``arr.at`` / ``arr.store_at`` operate on raw addresses.
    """
    __slots__ = ("ctx", "name", "_placement")

    def __init__(self, ctx: "KernelContext", name: str):
        self.ctx = ctx
        if ctx.layout is None or name not in ctx.layout.placements:
            raise TraceError(f"array {name!r} is not in the kernel's data "
                             f"layout")
        self.name = name
        self._placement = ctx.layout.placements[name]

    @property
    def bank_array(self) -> str:
        return self._placement.bank_array

    @property
    def words(self) -> int:
        return self._placement.words

    def addr(self, index: IntOrTraced) -> TracedValue:
        """Based bank-local address of ``index`` (base folded in once)."""
        base = self._placement.base
        if isinstance(index, int):
            return self.ctx.const(base + index)
        if not isinstance(index, TracedValue):
            raise TraceError(f"array index must be int or traced value, "
                             f"got {type(index).__name__}")
        return index + base if base else index

    def at(self, addr: IntOrTraced, name: str = "") -> TracedValue:
        """LOAD at a raw (already based) address."""
        return self.ctx._node(Op.LOAD, (addr,), array=self.bank_array,
                              name=name)

    def store_at(self, addr: IntOrTraced, val: IntOrTraced,
                 name: str = "") -> TracedValue:
        """STORE at a raw (already based) address; returns the store node
        (feed it to ``ctx.loop_carried`` for carried recurrences)."""
        return self.ctx._node(Op.STORE, (addr, val), array=self.bank_array,
                              name=name)

    def __getitem__(self, index: IntOrTraced) -> TracedValue:
        return self.at(self.addr(index))

    def __setitem__(self, index: IntOrTraced, val: IntOrTraced) -> None:
        self.store_at(self.addr(index), val)


class KernelContext:
    """The tracing context handed to a DSL kernel body.

    Wraps a :class:`DFGBuilder`; every primitive emits IR nodes in call
    order.  ``layout`` (a :class:`DataLayout`) gives ``ctx.array`` handles
    their bank placement.
    """

    def __init__(self, name: str, layout: Optional[DataLayout] = None):
        self._b = DFGBuilder(name)
        self.layout = layout

    # ------------------------------------------------------------- plumbing
    def _coerce(self, v: IntOrTraced) -> int:
        """Value -> node id, materializing ints as cached CONSTs."""
        if isinstance(v, TracedValue):
            if v.ctx is not self:
                raise TraceError("traced value belongs to another kernel "
                                 "context")
            return v.id
        if isinstance(v, int) and not isinstance(v, bool):
            return self._b.const(v)
        raise TraceError(f"expected int or traced value, got "
                         f"{type(v).__name__} ({v!r})")

    def _node(self, op: Op, operands: Sequence[IntOrTraced] = (),
              **kw) -> TracedValue:
        # inlined DFGBuilder._add: one Operand construction per edge (this
        # is the tracer's per-node hot path)
        # operands coerce FIRST (an int may materialize a fresh CONST node),
        # then the op itself takes the next id — the emission order every
        # hand-built listing uses
        ops = tuple([Operand(self._coerce(o)) for o in operands])
        b = self._b
        nid = b._next
        b._next = nid + 1
        b.dfg.nodes[nid] = Node(nid, op, ops, **kw)
        return TracedValue(self, nid)

    def emit(self, op: Op, *operands: IntOrTraced,
             name: str = "") -> TracedValue:
        """Emit one ALU node (the escape hatch under the operator sugar)."""
        return self._node(op, operands, name=name)

    # ------------------------------------------------------------ leaves
    def const(self, v: int, name: str = "") -> TracedValue:
        """Compile-time immediate (CSE-cached CONST node)."""
        if not isinstance(v, int) or isinstance(v, bool):
            raise TraceError(f"const expects an int, got {type(v).__name__}")
        return TracedValue(self, self._b.const(v, name=name))

    def livein(self, name: str) -> TracedValue:
        """Host-preloaded outer-loop iteration variable (cached)."""
        return TracedValue(self, self._b.livein(name))

    def array(self, name: str) -> ArrayRef:
        return ArrayRef(self, name)

    def arrays(self, *names: str) -> List[ArrayRef]:
        return [ArrayRef(self, n) for n in names]

    # --------------------------------------------------- loop-carried state
    def counter(self, step: IntOrTraced = 1, *, init: Optional[int] = None,
                stop: Optional[IntOrTraced] = None,
                name: str = "") -> TracedValue:
        """Mapped-loop induction variable: ``k += step`` each iteration.

        ``init`` is the carried register's preload (default ``-step`` so
        iteration 0 observes 0; explicit for traced steps).  ``stop``
        additionally emits the loop's exit guard ``k >= stop`` (the branch
        the compiler's DFG pass would keep for the trip count).
        """
        if init is None:
            if not isinstance(step, int):
                raise TraceError("counter(init=...) is required when the "
                                 "step is a traced value")
            init = -step
        stepv = self._coerce(step)
        k = self._b.add(Operand(0, 0), stepv, name=name)
        self._b.dfg.nodes[k].operands = (Operand(k, dist=1, init=init),
                                         Operand(stepv))
        kv = TracedValue(self, k)
        if stop is not None:
            self.emit(Op.CMPGE, kv, stop, name="exit")
        return kv

    def wrapping_counter(self, step: IntOrTraced, stop: IntOrTraced, *,
                         init: int = 0, advance: Optional[TracedValue] = None,
                         name: str = ""):
        """One level of a coalesced loop nest: a counter that wraps to 0 at
        ``stop``.  Returns ``(value, wrapped)`` where ``wrapped`` is the
        0/1 carry into the next-outer level.

        Innermost levels advance every iteration (``advance=None``); outer
        levels advance only when the inner carry fires (``advance=carry``).
        """
        stepv = self._coerce(step)
        nid = self._b.add(Operand(0, 0), stepv, name=f"{name}new")
        new = TracedValue(self, nid)
        wrap = self.emit(Op.CMPGE, new, stop, name=f"{name}wrap")
        if advance is None:
            val = self.select(wrap, self.const(0), new, name=name)
        else:
            sel = self.select(wrap, self.const(0), new, name=f"{name}sel")
            vid = self._b.select(advance.id, sel.id, Operand(0, 0), name=name)
            self._b.dfg.nodes[vid].operands = (
                Operand(advance.id), Operand(sel.id),
                Operand(vid, dist=1, init=init))
            val = TracedValue(self, vid)
        self._b.dfg.nodes[nid].operands = (Operand(val.id, dist=1, init=init),
                                           Operand(stepv))
        return val, wrap

    def gated_counter(self, step: IntOrTraced, advance: TracedValue, *,
                      init: int = 0, name: str = "") -> TracedValue:
        """Outermost coalesced level: counts ``+step`` only on the cycles
        where ``advance`` is 1 (no wrap of its own)."""
        stepv = self._coerce(step)
        nid = self._b.add(Operand(0, 0), stepv, name=f"{name}new")
        vid = self._b.select(advance.id, nid, Operand(0, 0), name=name)
        self._b.dfg.nodes[nid].operands = (Operand(vid, dist=1, init=init),
                                           Operand(stepv))
        self._b.dfg.nodes[vid].operands = (
            Operand(advance.id), Operand(nid),
            Operand(vid, dist=1, init=init))
        return TracedValue(self, vid)

    def coalesce(self, *levels, name_prefix: str = ""):
        """Coalesce a loop nest into one mapped loop (Listing 4/5 idiom).

        ``levels`` are ``(trip, step)`` (or bare ``trip``) pairs ordered
        outermost-first; returns the induction values in the same order.
        The innermost level wraps every iteration; each outer level
        advances on the inner carry, the outermost never wraps.
        """
        lv = [(l, 1) if isinstance(l, int) else tuple(l) for l in levels]
        if len(lv) < 2:
            raise TraceError("coalesce needs at least two loop levels")
        # materialize consts up front in the canonical Listing-4 order:
        # inner step, inner stop, outer wrapping stops (inner->outer),
        # then 0 and 1
        self._coerce(lv[-1][1])
        self._coerce(lv[-1][0])
        for trip, _step in reversed(lv[1:-1]):
            self._coerce(trip)
        self.const(0)
        self.const(1)
        vals: List[TracedValue] = []
        carry: Optional[TracedValue] = None
        for depth, (trip, step) in enumerate(reversed(lv[1:])):
            v, wrap = self.wrapping_counter(
                step, trip, init=-step if depth == 0 else 0, advance=carry)
            carry = wrap if carry is None else self.emit(Op.AND, carry, wrap,
                                                         name="carry")
            vals.append(v)
        vals.append(self.gated_counter(lv[0][1], carry))
        return tuple(reversed(vals))

    def loop_carried(self, store: TracedValue, load: TracedValue,
                     dist: int = 1) -> None:
        """Declare the carried memory recurrence store -> next-iter load
        (the output-stationary accumulator ordering edge)."""
        self._b.mem_dep(store.id, load.id, dist=dist)

    # ------------------------------------------------------------ helpers
    def select(self, cond: TracedValue, a: IntOrTraced, b: IntOrTraced,
               name: str = "") -> TracedValue:
        """``a if cond else b`` as a predicated SELECT node."""
        return self._node(Op.SELECT, (cond, a, b), name=name)

    def treesum(self, values: Iterable[IntOrTraced]) -> TracedValue:
        """Balanced pairwise reduction of unrolled partial products."""
        vals = [v if isinstance(v, TracedValue) else self.const(v)
                for v in values]
        if not vals:
            raise TraceError("treesum of no values")
        while len(vals) > 1:
            nxt = [self.emit(Op.ADD, vals[t], vals[t + 1])
                   for t in range(0, len(vals) - 1, 2)]
            if len(vals) % 2:
                nxt.append(vals[-1])
            vals = nxt
        return vals[0]

    def accumulate(self, arr: ArrayRef, addr: IntOrTraced,
                   val: IntOrTraced, name: str = "o") -> TracedValue:
        """Read-modify-write ``arr[addr] += val`` with the loop-carried
        store->load ordering edge (output-stationary accumulator)."""
        old = arr.at(addr, name=f"{name}val")
        acc = self.emit(Op.ADD, old, val, name="acc")
        st = arr.store_at(addr, acc, name=f"{name}st")
        self.loop_carried(st, old)
        return st

    def relu(self, v: TracedValue) -> TracedValue:
        """max(v, 0) via CMPGE + SELECT (the fused-epilogue idiom)."""
        ge = self.emit(Op.CMPGE, v, self.const(0))
        return self.select(ge, v, self.const(0), name="relu")

    def clamp(self, v: TracedValue, lo: int, hi: int) -> TracedValue:
        """Saturate v into [lo, hi] (requantization epilogues)."""
        chi, clo = self.const(hi), self.const(lo)
        over = self.emit(Op.CMPGE, v, chi)
        v = self.select(over, chi, v)
        under = self.emit(Op.CMPLT, v, clo)
        return self.select(under, clo, v, name="clamp")

    # -------------------------------------------------------------- finish
    def build(self) -> DFG:
        return self._b.build()


def unroll(n: int) -> range:
    """Compile-time unroll marker: iterate the traced body ``n`` times.

    Python loops over the result are fully unrolled into the DFG — this is
    the declarative spelling of ``range(n)`` inside a kernel body.
    """
    if not isinstance(n, int) or n < 1:
        raise TraceError(f"unroll expects a positive int, got {n!r}")
    return range(n)


def trace(body: Callable[[KernelContext], None], *, name: str,
          layout: Optional[DataLayout] = None) -> DFG:
    """Run ``body`` under a fresh tracing context and return the lowered,
    validated DFG."""
    ctx = KernelContext(name, layout)
    body(ctx)
    return ctx.build()
