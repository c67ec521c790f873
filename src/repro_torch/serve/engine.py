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

With ``repro_torch.spans`` on, ``admit`` records ``engine.admit`` (its
``rid`` and prompt ``tokens``) over ``model.prefill``,
``engine.admit.merge`` and ``engine.admit.readback``; ``step`` records
``engine.step`` (``active`` slots of ``batch``) over
``engine.step.inputs``, ``model.decode``, ``engine.step.readback`` and
``engine.step.finish``.  The readbacks are where the host waits for the
card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import spans
from ..device import DeviceLike, resolve_device
from ..models.zoo import Model, cache_tensors


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
        with (spans.span("engine.step", active=len(active),
                         batch=self.batch)
              if spans.ON else spans.OFF):
            with spans.span("engine.step.inputs") if spans.ON else spans.OFF:
                toks = self._tensor(self.last_tok[:, None].astype(np.int64))
                pos = self._tensor(self.lengths[:, None].astype(np.int64))
                lens = self._tensor(self.lengths + 1)
            with spans.span("model.decode") if spans.ON else spans.OFF:
                logits, self.caches = self.model.decode(
                    self.params, self.caches, toks, pos, lens)
            if self.exec_model is not None:
                self.clock_s += self.exec_model.decode_step_s(len(active))
            with (spans.span("engine.step.readback")
                  if spans.ON else spans.OFF):
                nxt = logits[:, -1].argmax(-1).cpu().numpy()
            with spans.span("engine.step.finish") if spans.ON else spans.OFF:
                return self._finish(active, nxt)

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
