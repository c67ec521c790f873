"""Batched serving engine: continuous-batching style decode loop (PyTorch
port of ``repro.serve.engine``).

Slots hold independent requests; each engine step decodes one token for
every slot.  Prefill admits new requests into free slots.  The engine
optionally carries an *execution model* that advances ``clock_s``, the
modeled wall clock the traffic harness schedules arrivals against.

Caches are written in place.  Admission writes a prefilled slot by the
reference's rule: batch on axis 1, and a sequence axis only where the
prefill's shape differs from the cache's.  For the transformer that writes
a prompt's K/V into positions ``[0, plen)`` of its slot, and decode
assigns each new position, so a recycled slot never sees the previous
request's K/V (every position below ``lengths`` is rewritten before it is
read).  An rwkv6 state has no sequence axis, so admission overwrites the
slot's whole state.

Every step decodes all ``batch`` slots from inputs the engine keeps in
place (tokens, positions, lengths), into caches that never move, so every
step has the same shapes and the same tensors.  On a CUDA device the
first ``EAGER_STEPS`` steps run eagerly, which loads the kernels and the
library handles; the next step records ``Model.decode`` and the argmax
of its logits as one CUDA graph, and that step and every later one
replay it: one launch a step where the host issued one per operation.
The graph lives as long as the engine.  A CPU engine always runs
eagerly.  ``eager_steps`` and ``graph_replays`` count the two kinds of
step.  The kernels' launch counters (``launches``, ``launches_by_route``)
and cost notes are kept by Python, so they count the eager steps and the
recording, and not the replays, which run no Python: a profiler's trace
of the card counts the replayed kernels.  Prefill always runs eagerly:
its lengths vary.

With ``repro_torch.spans`` on, ``admit`` records ``engine.admit`` (its
``rid`` and prompt ``tokens``) over ``model.prefill``,
``engine.admit.merge`` and ``engine.admit.readback``; ``step`` records
``engine.step`` (``active`` slots of ``batch``, ``graph`` 1 for a
replayed step, else 0) over ``engine.step.inputs``, ``model.decode``
(the replay, or the eager step's launches), ``engine.step.readback`` and
``engine.step.finish``.  The models' ``block.*`` and ``model.head``
spans appear on eager steps and at the recording only.  The readbacks
are where the host waits for the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import spans
from ..device import DeviceLike, resolve_device
from ..models.zoo import Model, cache_tensors

# Eager steps before a CUDA engine records its decode step as a graph.
EAGER_STEPS = 2


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    truncated: bool = False


class Engine:
    def __init__(self, model: Model, params: Any, batch: int, max_len: int,
                 exec_model: Optional[Any] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.exec_model = exec_model
        self.clock_s = 0.0           # modeled time (advances only if exec_model)
        self.caches = model.init_cache(batch, max_len)
        self.lengths = np.zeros((batch,), np.int32)
        self.last_tok = np.zeros((batch,), np.int32)
        self.slots: List[Optional[Request]] = [None] * batch
        # A step's tokens, positions and lengths, staged on the host
        # (pinned for a card) and copied into the same device tensors
        # every step; the step's argmax lands in ``_next``.
        pin = self.device.type == "cuda"
        self._staged = (torch.zeros((batch, 1), dtype=torch.int64,
                                    pin_memory=pin),
                        torch.zeros((batch, 1), dtype=torch.int64,
                                    pin_memory=pin),
                        torch.zeros((batch,), dtype=torch.int32,
                                    pin_memory=pin))
        self.inputs = tuple(torch.zeros(t.shape, dtype=t.dtype,
                                        device=self.device)
                            for t in self._staged)
        self._next = torch.zeros((batch,), dtype=torch.int64,
                                 device=self.device)
        self.logits: Optional[torch.Tensor] = None  # the last step's
        self.eager_steps = 0
        self.graph_replays = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    # -------------------------------------------------------------- slots
    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def has_free_slot(self) -> bool:
        return any(s is None for s in self.slots)

    def advance_clock(self, t: float) -> None:
        """Idle until modeled time ``t`` (never runs the clock backward)."""
        self.clock_s = max(self.clock_s, t)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---------------------------------------------------------- admission
    def admit(self, req: Request, truncate: bool = False) -> bool:
        """Prefill ``req`` into a free slot.  Returns False when every
        slot is busy (the caller queues and retries).

        A prompt needing ``>= max_len`` positions (one must stay free for
        decode) is truncated to its last ``max_len - 1`` tokens when
        ``truncate=True``, and rejected with ValueError otherwise."""
        limit = self.max_len - 1
        if len(req.prompt) > limit:
            if not truncate:
                raise ValueError(
                    f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                    f"cannot fit max_len={self.max_len} (needs <= {limit} "
                    f"to leave a decode position); pass truncate=True to "
                    f"keep the last {limit} tokens")
            req.prompt = np.asarray(req.prompt[-limit:])
            req.truncated = True
        for i, s in enumerate(self.slots):
            if s is None:
                with (spans.span("engine.admit", rid=req.rid,
                                 tokens=len(req.prompt))
                      if spans.ON else spans.OFF):
                    self._prefill(i, req)
                return True
        return False

    def _prefill(self, i: int, req: Request) -> None:
        """Batch-1 prefill of ``req`` into slot ``i`` (production would
        batch)."""
        self.slots[i] = req
        plen = len(req.prompt)
        toks = self._tensor(np.asarray(req.prompt, np.int64)[None])
        with (spans.span("model.prefill", tokens=plen)
              if spans.ON else spans.OFF):
            logits, caches = self.model.prefill(
                self.params, toks, self._tensor(np.asarray([plen])))
        with spans.span("engine.admit.merge") if spans.ON else spans.OFF:
            self._merge_cache(i, caches)
        self.lengths[i] = plen
        with (spans.span("engine.admit.readback")
              if spans.ON else spans.OFF):
            self.last_tok[i] = int(logits[0, -1].argmax())
        if self.exec_model is not None:
            self.clock_s += self.exec_model.prefill_s(plen)

    def _merge_cache(self, slot: int, caches: Any) -> None:
        for full, new in zip(cache_tensors(self.caches),
                             cache_tensors(caches)):
            idx = [slice(None)] * new.ndim
            idx[1] = slot
            seq = [ax for ax in range(2, new.ndim)
                   if new.shape[ax] != full.shape[ax]]
            if seq:
                idx[seq[0]] = slice(0, new.shape[seq[0]])
            full[tuple(idx)] = new[:, 0]

    # --------------------------------------------------------------- step
    def step(self) -> Dict[int, int]:
        """One decode step for all active slots; returns {rid: token}.
        Finished requests free their slot so admission under slot
        pressure recycles capacity."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return {}
        graph = self.device.type == "cuda" and \
            self.eager_steps >= EAGER_STEPS
        with (spans.span("engine.step", active=len(active),
                         batch=self.batch, graph=int(graph))
              if spans.ON else spans.OFF):
            with spans.span("engine.step.inputs") if spans.ON else spans.OFF:
                self._stage_inputs()
            with spans.span("model.decode") if spans.ON else spans.OFF:
                if graph:
                    self._replay()
                else:
                    self.logits, self.caches = self._decode()
                    self.eager_steps += 1
            if self.exec_model is not None:
                self.clock_s += self.exec_model.decode_step_s(len(active))
            with (spans.span("engine.step.readback")
                  if spans.ON else spans.OFF):
                nxt = self._next.cpu().numpy()
            with spans.span("engine.step.finish") if spans.ON else spans.OFF:
                return self._finish(active, nxt)

    def _stage_inputs(self) -> None:
        """Copies the step's tokens, positions and lengths into
        ``inputs``, asynchronously from pinned memory on a card: the last
        step's readback has waited for the copy that read them before."""
        toks, pos, lens = self._staged
        toks.numpy()[:, 0] = self.last_tok
        pos.numpy()[:, 0] = self.lengths
        lens.numpy()[:] = self.lengths + 1
        for dst, src in zip(self.inputs, self._staged):
            dst.copy_(src, non_blocking=True)

    def _decode(self):
        """``Model.decode`` on ``inputs``, the next tokens into ``_next``;
        returns (logits, caches)."""
        logits, caches = self.model.decode(self.params, self.caches,
                                           *self.inputs)
        torch.argmax(logits[:, -1], -1, out=self._next)
        return logits, caches

    def _replay(self) -> None:
        """The step as a replay of the recorded graph, recorded first if
        there is none."""
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.graph_replays += 1

    def _capture(self) -> None:
        """Records ``_decode`` as a CUDA graph; runs nothing on the card.
        Keeps the graph's logits as ``logits``.  Raises if the model's
        decode returned caches other than the ones it was given: a replay
        could not keep them."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, caches = self._decode()
        if any(a is not b for a, b in zip(cache_tensors(caches),
                                          cache_tensors(self.caches))):
            raise RuntimeError(f"{self.model.cfg.name}: decode returned "
                               f"new caches; a CUDA graph needs them "
                               f"written in place")
        self._graph, self.logits = graph, logits

    def _finish(self, active: List[int], nxt: np.ndarray) -> Dict[int, int]:
        """Each active slot takes its token; a finished request frees its
        slot."""
        out: Dict[int, int] = {}
        for i in active:
            req = self.slots[i]
            tok = int(nxt[i])
            req.out.append(tok)
            out[req.rid] = tok
            self.lengths[i] += 1
            self.last_tok[i] = tok
            if len(req.out) >= req.max_new or self.lengths[i] >= self.max_len:
                req.done = True
                self.slots[i] = None
                self.lengths[i] = 0
                self.last_tok[i] = 0
        return out
