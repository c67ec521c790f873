"""Serving cells: closed-loop clients over ``repro_torch.serve.engine.
Engine`` (``admit`` -> ``Model.prefill``, ``step`` -> ``Model.decode``).

One loop iteration admits every waiting request (each a batch-1
prefill, as the engine does it), then runs one decode step for every
slot.  A client sends its next request when its last one completes, at
the end of that step.  Warm-up admits every client and runs
``warmup_steps`` steps, so completions are staggered before the window
opens; the window opens and closes at step boundaries.

Times are host-clock ns (``time.time_ns()``); every admit and step ends
with its tokens on the host, so a token's time is when a client would
have it.

Correctness: once the window has closed and the engine is freed, a
sample of the requests finished inside it, drawn from the seed with the
longest among them, goes through the plain reference: one float32
forward over each prompt and its served tokens, on the weights drawn again
in the served dtype.  The number compared, ``served_logit_gap``, is the
widest gap by which a served token's logit lies below the reference's best
at its position.

A traced run turns the program's own spans (``repro_torch.spans``) on in
its window, for the host's own times with no profiler running
(``run.window_program_spans``), and in the profiled stretch, to put the
card's idle time under them (``run.program_spans``).  Its window reports
no end-to-end metric.  The profiler slows each launch of a graph from
tens of microseconds to milliseconds, and once it has run in a process
it leaves CUPTI attached, so no stretch after it reads the host's times.
An untraced run turns no span on.
"""
from __future__ import annotations

import collections
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from chipbench import harness, traffic
from chipbench.drivers import common
from chipbench.reference.plain import CONTROL, FLOAT32, strict_float32
from chipbench.trace import Profiler, Recorder

TRACE_SECONDS = 3       # the profiled stretch after a traced run's window


def tiny_traffic(cell: Dict) -> Dict:
    """``cell`` at the tests' CPU size: 4 clients, prompts of 8-40 tokens,
    outputs of 4-12, 3 requests checked."""
    tr = cell["traffic"]
    tr.update(clients=4, max_len=64, warmup_steps=6)
    tr["prompt"] = dict(tr["prompt"], lo=8, hi=40)
    tr["output"] = dict(tr["output"], lo=4, hi=12)
    cell["check"]["requests"] = 3
    return cell


@dataclass
class Served:
    """One request as its client sees it."""
    rid: int
    req: traffic.ServeRequest
    t_sent: int
    engine_req: object = None
    t_first: Optional[int] = None
    t_done: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    times: List[int] = field(default_factory=list)

    @property
    def gaps(self) -> List[tuple]:
        """(end time, ns) of each gap between consecutive tokens."""
        return [(b, b - a) for a, b in zip(self.times, self.times[1:])]


class Server:
    def __init__(self, engine, loop: traffic.ClosedLoop, rec: Recorder):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.engine = engine
        self.loop = loop
        self.rec = rec
        self.pending: collections.deque = collections.deque()
        self.active: Dict[int, Served] = {}
        self.served: List[Served] = []

    def send(self, client: int, t: int) -> None:
        req = self.loop.next(client)
        s = Served(len(self.served), req, t)
        s.engine_req = self.Request(rid=s.rid, prompt=req.prompt,
                                    max_new=req.n_out - 1)
        self.served.append(s)
        self.pending.append(s)

    def start(self) -> None:
        t = time.time_ns()
        for c in range(self.loop.clients):
            self.send(c, t)

    def iterate(self) -> None:
        eng = self.engine
        while self.pending:
            s = self.pending[0]
            span = self.rec.open("prefill", tokens=len(s.req.prompt))
            ok = eng.admit(s.engine_req)
            self.rec.close(span)
            if not ok:
                break
            self.pending.popleft()
            slot = next(i for i, r in enumerate(eng.slots)
                        if r is s.engine_req)
            s.tokens.append(int(eng.last_tok[slot]))
            s.times.append(span.t1)
            s.t_first = span.t1
            self.active[s.rid] = s
        busy = [i for i, r in enumerate(eng.slots) if r is not None]
        span = self.rec.open(
            "decode_step", active=len(busy), batch=eng.batch,
            ctx_all=int((eng.lengths.astype(np.int64) + 1).sum()),
            ctx_active=int(sum(int(eng.lengths[i]) + 1 for i in busy)))
        out = eng.step()
        self.rec.close(span)
        for rid, tok in out.items():
            s = self.active[rid]
            s.tokens.append(int(tok))
            s.times.append(span.t1)
            if s.engine_req.done:
                s.t_done = span.t1
                del self.active[rid]
                self.send(s.req.client, span.t1)

    def run_steps(self, n: int) -> None:
        for _ in range(n):
            self.iterate()

    def run_until(self, t_end: int) -> None:
        while time.time_ns() < t_end:
            self.iterate()


def setup(run: harness.Run):
    """The engine on the seed's weights, its clients started and warmed
    up.  Returns the server."""
    from repro_torch.serve.engine import Engine
    tr = run.cell["traffic"]
    mcfg, model, params = common.build(run)
    engine = Engine(model, params, batch=int(tr["clients"]),
                    max_len=int(tr["max_len"]), device=run.device)
    rec = Recorder()
    server = Server(engine, traffic.ClosedLoop(tr, mcfg.vocab, run.seed),
                    rec)
    server.start()
    server.run_steps(int(tr["warmup_steps"]))
    common.sync(run.device)
    return server


def window(run: harness.Run, server: Server, seconds: float) -> None:
    """The measured window, then (traced runs) the profiled stretch; a
    traced run serves both with the program's spans on."""
    run.peak_bytes = common.peak_bytes(run.device)
    common.reset_peak(run.device)
    w0 = time.time_ns()
    if run.trace:
        _with_spans(server, w0 + int(seconds * 1e9))
    else:
        server.run_until(w0 + int(seconds * 1e9))
    run.window = (w0, time.time_ns())
    _report_window(run, server.rec.spans)
    run.window_peak_bytes = common.peak_bytes(run.device)
    if run.trace:
        from repro_torch import spans
        run.window_program_spans = spans.take()
        with Profiler(server.rec) as prof:
            _with_spans(server, time.time_ns() + TRACE_SECONDS * 10**9)
        run.stretch = prof.stretch
        run.program_spans = spans.take()
    run.peak_bytes = max(run.peak_bytes, common.peak_bytes(run.device))
    run.spans = server.rec.spans
    run.requests = server.served
    run.attempted = sum(1 for s in server.served if run.in_window(s.t_first))
    run.failed = 0


def _with_spans(server: Server, t_end: int) -> None:
    """Serves until ``t_end`` with the program's spans on."""
    from repro_torch import spans
    spans.enable()
    try:
        server.run_until(t_end)
    finally:
        spans.disable()


def _report_window(run, spans) -> None:
    steps = [s for s in spans if s.name == "decode_step"
             and run.in_window(s.t1)]
    pre = [s for s in spans if s.name == "prefill" and run.in_window(s.t1)]
    print(f"chipbench: window {run.window_s:.3f} s: {len(steps)} decode "
          f"steps ({sum(s.t1 - s.t0 for s in steps) / 1e9:.3f} s), "
          f"{len(pre)} prefills ({sum(s.t1 - s.t0 for s in pre) / 1e9:.3f} "
          f"s)", file=sys.stderr)


def sample(run: harness.Run, served: List[Served], k: int) -> List[Served]:
    """``k`` requests finished inside the window, drawn from the seed,
    the one with the most served tokens always among them."""
    done = [s for s in served if run.in_window(s.t_done)]
    if len(done) <= k:
        return done
    longest = max(done, key=lambda s: (len(s.tokens), len(s.req.prompt)))
    rest = [s for s in done if s is not longest]
    rng = np.random.default_rng([run.seed % (1 << 63), 3])
    pick = rng.choice(len(rest), size=k - 1, replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def gaps(run: harness.Run, chosen: List[Served], ref_weights,
         precisions=(FLOAT32,)) -> Dict[str, float]:
    """For each sampled request, the float32 reference's logits at every
    served position: ``served`` is the widest gap of a served token below
    the reference's best; for each lower precision, the widest gap of the
    token that precision puts first (the control)."""
    ref = harness.reference(run.cfg)
    out = {"served": 0.0}
    out.update({p.name: 0.0 for p in precisions if p is not FLOAT32})
    with torch.no_grad(), strict_float32():
        for s in chosen:
            plen = len(s.req.prompt)
            seq = np.concatenate([s.req.prompt,
                                  np.asarray(s.tokens[:-1], np.int64)])
            ids = torch.from_numpy(seq)[None].to(run.device)
            pos = torch.arange(plen - 1, plen - 1 + len(s.tokens),
                               device=run.device)
            want = torch.tensor(s.tokens, device=run.device)
            ref32 = ref.logits(ref_weights, run.cfg, ids, FLOAT32, pos)[0]
            best = ref32.max(-1).values
            got = ref32.gather(-1, want[:, None])[:, 0]
            out["served"] = max(out["served"], float((best - got).max()))
            for p in precisions:
                if p is FLOAT32:
                    continue
                low = ref.logits(ref_weights, run.cfg, ids, p, pos)[0]
                first = ref32.gather(-1, low.argmax(-1)[:, None])[:, 0]
                out[p.name] = max(out[p.name], float((best - first).max()))
                del low
            del ref32
    return out


def check(run: harness.Run, server: Server,
          precisions=(FLOAT32,)) -> Dict[str, float]:
    """Frees the engine, then reads the sampled requests' gaps, and the
    card's peak allocation from the engine's release to the last gap."""
    chosen = sample(run, server.served, int(run.cell["check"]["requests"]))
    server.engine = None
    common.free(run.device)
    common.reset_peak(run.device)
    readings = gaps(run, chosen, common.reference_weights(run), precisions)
    readings["check_peak_bytes"] = common.peak_bytes(run.device)
    readings["requests"] = len(chosen)
    readings["tokens"] = sum(len(s.tokens) for s in chosen)
    return readings


def judged(run: harness.Run, value: float, requests: int) -> Dict:
    """The numbers compared, each beside the cell's limit, as
    ``harness.judge`` takes them."""
    limit = float(run.cell["check"]["limits"]["served_logit_gap"])
    return {"served_logit_gap": {
        "value": value if requests else float("nan"), "limit": limit}}


def calibrate(run: harness.Run) -> Dict:
    """One seed's readings for setting the limit: the program's gap and
    its control's (the reference one precision below the configuration's
    dtype, put in the program's place) over the same sampled requests,
    after a window of ``run.seconds``; each judged against the cell's
    limit as a run judges the program."""
    server = setup(run)
    window(run, server, run.seconds)
    control = CONTROL[run.cfg["model"].get("dtype", "bfloat16")]
    out = check(run, server, (FLOAT32, control))
    out["control"] = out.pop(control.name)
    out["correct"] = harness.judge(
        judged(run, out["served"], out["requests"]))
    out["control_correct"] = harness.judge(
        judged(run, out["control"], out["requests"]))
    return out


def run(run: harness.Run, t_start: float) -> None:
    server = setup(run)
    run.setup_s = time.time() - t_start
    window(run, server, run.seconds)
    readings = check(run, server)
    run.checks = judged(run, readings["served"], readings["requests"])
    print(f"chipbench: compared {readings['tokens']} served tokens of "
          f"{readings['requests']} requests; the check's peak "
          f"{readings['check_peak_bytes'] / 2**30:.3f} GiB", file=sys.stderr)
