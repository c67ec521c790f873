"""The one traffic generator: every mix is a data file of parameters
(``workloads/<cell>.json``, key ``traffic``) that this module reads.

Serving mixes are closed loops of ``clients`` clients, each sending its
next request as soon as the last one completes.  Lengths come from a fixed
grid of one value a client, spread over the stated distribution (the
value at each stratum's middle quantile).  Client ``c``'s ``j``-th request
takes prompt stratum ``(a_c + j * stride) mod clients``, so any few
consecutive requests of one client spread over the whole range, and at
every ``j`` the clients together hold every stratum once.  Where each
client starts (``a_c``) is a fixed permutation (``SCHEDULE_SEED``): every
run seed serves the same sizes in the same order, so a window's work does
not move with the seed, and the seed draws the token ids (and, in the
drivers, the weights).

Seeds are any non-negative whole number; numpy's ``SeedSequence`` takes
them at full width.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

PROMPT_STRIDE = 23      # odd, so coprime with a power-of-two grid
OUTPUT_STRIDE = 41
SCHEDULE_SEED = 0       # the clients' starting strata, the same every run


def grid(spec: Dict, strata: int) -> List[int]:
    """The ``strata`` lengths of ``spec`` (``{"dist": "uniform" |
    "loguniform", "lo", "hi"}``, inclusive), at the middle quantile of each
    stratum, rounded to whole tokens."""
    lo, hi = float(spec["lo"]), float(spec["hi"])
    qs = [(i + 0.5) / strata for i in range(strata)]
    if spec["dist"] == "uniform":
        vals = [lo + q * (hi - lo) for q in qs]
    elif spec["dist"] == "loguniform":
        vals = [math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(round(v)) for v in vals]


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) % (1 << 63) for k in key])


@dataclass
class ServeRequest:
    client: int
    index: int            # the client's j-th request
    prompt: np.ndarray    # int64 ids
    n_out: int            # output tokens, the prefill's first one included


class ClosedLoop:
    """The requests of a closed-loop serving mix for one seed."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        self.clients = int(traffic["clients"])
        self.prompts = grid(traffic["prompt"], self.clients)
        self.outputs = grid(traffic["output"], self.clients)
        self.vocab = vocab
        self.seed = seed
        rng = _rng(SCHEDULE_SEED, 0)
        self.prompt_start = rng.permutation(self.clients)
        self.output_start = rng.permutation(self.clients)
        self.sent = [0] * self.clients

    def request(self, client: int, index: int) -> ServeRequest:
        p = (self.prompt_start[client] + index * PROMPT_STRIDE) % self.clients
        o = (self.output_start[client] + index * OUTPUT_STRIDE) % self.clients
        ids = _rng(self.seed, 1, client, index).integers(
            0, self.vocab, size=self.prompts[p], dtype=np.int64)
        return ServeRequest(client, index, ids, self.outputs[o])

    def next(self, client: int) -> ServeRequest:
        """The client's next request."""
        req = self.request(client, self.sent[client])
        self.sent[client] += 1
        return req

