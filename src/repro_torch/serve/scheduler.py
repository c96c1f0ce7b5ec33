"""Continuous-batching scheduler: a per-slot request state machine.

Port of `repro.serve.scheduler` for generate requests.  Each engine slot
cycles  free -> prefill -> decode -> recycled-on-eos :

  * **admit** — whenever a slot is free and the queue is non-empty, the
    oldest request (FIFO) is prefilled straight into the live batch;
  * **decode** — one `Engine.decode_step()` advances every busy slot one
    token; tokens are streamed per request via the `on_token` callback;
  * **recycle** — a slot whose request hits its EOS id or its token
    budget is reset and immediately eligible for the next admit.

The metric and span names are the JAX package's.  Eval, beam and best-of
requests (`submit_eval`, `submit_beam`, `submit_best_of`) come with
ROADMAP A4 and A5 and raise until then.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import obs

_UNSET = object()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]


@dataclasses.dataclass
class _Slot:
    """Book-keeping for one busy engine slot."""
    req: Request
    tokens: List[int]


class ContinuousScheduler:
    """FIFO continuous batching over a slot `Engine`.

    on_token(rid, token, done) fires for every generated token (the
    prefill's first token included) as soon as the host sees it.
    """

    def __init__(self, engine, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 on_token: Optional[Callable[[int, int, bool], None]] = None):
        self.engine = engine
        self.default_max_new = max_new_tokens
        self.default_eos = eos_id
        self.on_token = on_token
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: List[Optional[_Slot]] = [None] * engine.batch_size
        self.results: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self.decode_steps = 0
        self.slot_busy_steps = 0
        self.peak_active = 0
        self.tokens_emitted = 0          # decode-step emissions (no prefill)
        self.admit_order: List[int] = []
        self.ttft: Dict[int, float] = {}      # submit -> first token
        self.latency: Dict[int, float] = {}   # submit -> completion
        self.queue_wait: Dict[int, float] = {}  # submit -> admission
        self.tpot: Dict[int, float] = {}  # per-token time after the first
        self._submit_t: Dict[int, float] = {}
        self._first_t: Dict[int, float] = {}
        self.tracer = obs.get_tracer()
        reg = obs.get_registry()
        self._m_qdepth = reg.gauge("serve.queue_depth",
                                   "requests waiting for a slot")
        self._m_active = reg.gauge("serve.active_slots",
                                   "slots decoding a live request")
        self._m_ttft = reg.histogram("serve.ttft_s",
                                     "submit -> first token (queue incl.)")
        self._m_tpot = reg.histogram("serve.tpot_s",
                                     "per-token time after the first")
        self._m_qwait = reg.histogram("serve.queue_wait_s",
                                      "submit -> admission")
        self._m_latency = reg.histogram("serve.latency_s",
                                        "submit -> completion")
        self._m_tps = reg.histogram("serve.tokens_per_slot_step",
                                    "decode emissions per busy slot-step")
        self._m_tokens = reg.counter("serve.tokens_total",
                                     "decode tokens emitted")
        self._m_admitted = reg.counter("serve.requests_admitted_total")
        self._m_finished = reg.counter("serve.requests_finished_total")

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               eos_id=_UNSET) -> int:
        """Queue one request; returns its request id.  The submit time is
        stamped here: `ttft` and `latency` include the queue wait."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = (self.default_max_new if max_new_tokens is None
                   else max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if len(prompt) + max_new - 1 > self.engine.sc.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"the engine cache capacity max_len={self.engine.sc.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._submit_t[rid] = time.perf_counter()
        self.queue.append(Request(
            rid, prompt, max_new,
            self.default_eos if eos_id is _UNSET else eos_id))
        self._m_qdepth.set(len(self.queue))
        return rid

    def submit_eval(self, prompt, continuations) -> int:
        raise NotImplementedError("loglikelihood eval requests come with "
                                  "ROADMAP A4")

    def submit_beam(self, prompt, *, n_beams: int, **kw) -> int:
        raise NotImplementedError("beam-search requests come with "
                                  "ROADMAP A5")

    def submit_best_of(self, prompt, *, n: int, **kw) -> int:
        raise NotImplementedError("best-of-n requests come with ROADMAP A5")

    # -- state machine ------------------------------------------------------

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        total = self.decode_steps * self.engine.batch_size
        return self.slot_busy_steps / total if total else 0.0

    def _finish(self, idx: int):
        slot = self.slots[idx]
        rid = slot.req.rid
        self.results[rid] = np.asarray(slot.tokens, np.int32)
        t_end = time.perf_counter()
        t_sub = self._submit_t[rid]
        self.latency[rid] = t_end - t_sub
        n_tok = len(slot.tokens)
        if n_tok > 1:
            self.tpot[rid] = ((self.latency[rid] - self.ttft[rid])
                              / (n_tok - 1))
            self._m_tpot.observe(self.tpot[rid])
        self._m_latency.observe(self.latency[rid])
        self._m_finished.inc()
        t_first = self._first_t.get(rid, t_end)
        self.tracer.add_span("req.decode", t_first, t_end, cat="request",
                             rid=rid, tokens=n_tok)
        self.tracer.add_span("req", t_sub, t_end, rid=rid, tokens=n_tok)
        self.slots[idx] = None
        self.engine.reset_slot(idx)

    def _token_arrived(self, idx: int, tok: int) -> bool:
        """Record one token for slot `idx`; returns True when it's done."""
        slot = self.slots[idx]
        slot.tokens.append(tok)
        done = (len(slot.tokens) >= slot.req.max_new_tokens
                or (slot.req.eos_id is not None
                    and tok == slot.req.eos_id))
        if self.on_token is not None:
            self.on_token(slot.req.rid, tok, done)
        if done:
            self._finish(idx)
        return done

    def _admit(self):
        """Admit queued requests (strict FIFO) while a slot is free."""
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return
            req = self.queue.popleft()
            idx = free[0]
            t_admit = time.perf_counter()
            self.queue_wait[req.rid] = t_admit - self._submit_t[req.rid]
            first = self.engine.prefill_into_slot(idx, req.prompt)
            self.slots[idx] = _Slot(req, [])
            t_first = time.perf_counter()
            self.admit_order.append(req.rid)
            self.ttft[req.rid] = t_first - self._submit_t[req.rid]
            self._first_t[req.rid] = t_first
            self._m_qdepth.set(len(self.queue))
            self._m_admitted.inc()
            self._m_qwait.observe(self.queue_wait[req.rid])
            self._m_ttft.observe(self.ttft[req.rid])
            self.tracer.add_span("req.queue", self._submit_t[req.rid],
                                 t_admit, cat="request", rid=req.rid)
            self.tracer.add_span("req.prefill", t_admit, t_first,
                                 cat="request", rid=req.rid,
                                 prompt_len=len(req.prompt))
            self._token_arrived(idx, first)

    def step(self) -> int:
        """One scheduler tick: admit, then advance every busy slot by one
        engine step.  Returns the number of busy slots."""
        self._admit()
        self.peak_active = max(self.peak_active, self.active)
        busy = [i for i, s in enumerate(self.slots) if s is not None]
        self._m_active.set(len(busy))
        if not busy:
            return 0
        with self.tracer.span("sched.decode_step", cat="sched",
                              step=self.decode_steps, busy=len(busy)):
            toks, counts = self.engine.decode_step_multi()
        self.decode_steps += 1
        self.slot_busy_steps += len(busy)
        emitted0 = self.tokens_emitted
        for idx in busy:
            for j in range(int(counts[idx])):
                self.tokens_emitted += 1
                if self._token_arrived(idx, int(toks[idx, j])):
                    break
        step_toks = self.tokens_emitted - emitted0
        self._m_tokens.inc(step_toks)
        self._m_tps.observe(step_toks / len(busy))
        return len(busy)

    def run(self) -> Dict[int, np.ndarray]:
        """Drive the state machine until queue and slots are empty."""
        while self.queue or self.active:
            self.step()
        return dict(self.results)

    # -- reporting ----------------------------------------------------------

    @property
    def tokens_per_step(self) -> float:
        """Mean decode-step emissions across busy slots (prefill tokens
        excluded): 1.0 for the plain engine."""
        return self.tokens_emitted / self.slot_busy_steps \
            if self.slot_busy_steps else 0.0

    def stats(self) -> Dict[str, Any]:
        """JSON-serializable run report with p50/p95/p99 latencies."""
        def _summ(d):
            vals = list(d.values())
            if not vals:
                return {"mean": 0.0, "max": 0.0,
                        "p50": 0.0, "p95": 0.0, "p99": 0.0}
            h = obs.Histogram("summ")
            for v in vals:
                h.observe(v)
            return {"mean": float(np.mean(vals)),
                    "max": float(np.max(vals)),
                    "p50": h.quantile(0.50),
                    "p95": h.quantile(0.95),
                    "p99": h.quantile(0.99)}

        return {
            "requests": len(self.results),
            "decode_steps": self.decode_steps,
            "occupancy": self.occupancy,
            "peak_active": self.peak_active,
            "tokens_emitted": self.tokens_emitted,
            "tokens_per_step": self.tokens_per_step,
            "ttft_s": _summ(self.ttft),
            "latency_s": _summ(self.latency),
            "queue_wait_s": _summ(self.queue_wait),
            "tpot_s": _summ(self.tpot),
        }
