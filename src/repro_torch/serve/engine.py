"""Batched serving engine: continuous-batching style decode loop (PyTorch
port of ``repro.serve.engine``).

Slots hold independent requests; each engine step decodes one token for
every slot.  Prefill admits new requests into free slots.  The engine
optionally carries an *execution model* that advances ``clock_s``, the
modeled wall clock the traffic harness schedules arrivals against.

The KV cache is written in place: prefill copies a prompt's K/V into its
slot and decode assigns each new position, so a recycled slot never sees
the previous request's K/V (every position below ``lengths`` is rewritten
before it is read).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.zoo import Model


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
                self.slots[i] = req
                # prefill this slot (batch-1 prefill; production would batch)
                plen = len(req.prompt)
                toks = self._tensor(np.asarray(req.prompt, np.int64)[None])
                logits, caches = self.model.prefill(
                    self.params, toks, self._tensor(np.asarray([plen])))
                for full, new in zip(self.caches["dense"], caches["dense"]):
                    full[:, i, :, :plen] = new[:, 0]
                self.lengths[i] = plen
                self.last_tok[i] = int(logits[0, -1].argmax())
                if self.exec_model is not None:
                    self.clock_s += self.exec_model.prefill_s(plen)
                return True
        return False

    # --------------------------------------------------------------- step
    def step(self) -> Dict[int, int]:
        """One decode step for all active slots; returns {rid: token}.
        Finished requests free their slot so admission under slot
        pressure recycles capacity."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return {}
        toks = self._tensor(self.last_tok[:, None].astype(np.int64))
        pos = self._tensor(self.lengths[:, None].astype(np.int64))
        lens = self._tensor(self.lengths + 1)
        logits, self.caches = self.model.decode(self.params, self.caches,
                                                toks, pos, lens)
        if self.exec_model is not None:
            self.clock_s += self.exec_model.decode_step_s(len(active))
        nxt = logits[:, -1].argmax(-1).cpu().numpy()
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
