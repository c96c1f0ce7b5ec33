"""Continuous-batching scheduler: a per-slot request state machine.

Port of `repro.serve.scheduler` for generate requests.  Each engine slot
cycles  free -> prefill -> decode -> recycled-on-eos :

  * **admit** — whenever a slot is free and the queue is non-empty, the
    oldest request (FIFO) is prefilled straight into the live batch;
  * **decode** — one `Engine.decode_step()` advances every busy slot one
    token; tokens are streamed per request via the `on_token` callback;
  * **recycle** — a slot whose request hits its EOS id or its token
    budget is reset and immediately eligible for the next admit.

On a paged engine an admit that finds the block pool dry
(`PoolExhausted`) puts the request back at the queue head and stops
admission for the tick: running slots keep decoding and free blocks as
they finish.  A request that cannot fit even with nothing running
raises.

A speculative engine's step emits 1..K+1 tokens a slot
(`decode_step_multi`); the scheduler counts drafted and accepted tokens
(`acceptance_rate`, the ``spec.*`` counters).  On the plain one-token
engines it also serves the request modes of `serve/modes.py`:

  * loglikelihood eval (`submit_eval`): the continuations are scored
    synchronously at admission through `Engine.score_in_slot`;
  * constrained requests (`submit` with ``token_mask`` or ``mask_fn``):
    the slot's allowed set streams through the sampling kernel, and a
    ``mask_fn`` recomputes it after every token;
  * beam and best-of groups (`submit_beam`, `submit_best_of`): a group
    waits at the queue head for n free slots, and while any group is live
    one `Engine.decode_topk_step` (one `sample_topk` launch with its lse)
    advances every busy slot; plain slots take the best candidate.

The metric and span names are the JAX package's.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.serve import modes
from repro_torch.serve.kvpool import PoolExhausted

log = logging.getLogger("repro_torch.serve")

_UNSET = object()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    kind: str = "generate"          # | "eval" | "beam" | "best_of"
    frontend_embeds: Optional[Any] = None     # (1, F, d), frontend archs
    token_mask: Optional[np.ndarray] = None   # constrained decoding
    mask_fn: Optional[Callable[[List[int]], Any]] = None
    payload: Optional[Dict[str, Any]] = None  # kind-specific state


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
        # speculative-decoding counters (stay 0 for plain engines)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.eval_requests = 0
        self.eval_tokens_scored = 0
        # beam / best-of groups: the live groups by rid, their slots, and
        # the finished hypothesis sets
        self._groups: Dict[int, Any] = {}
        self._group_slots: Dict[int, Any] = {}
        self.hypotheses: Dict[int, List[Any]] = {}
        self.group_forks = 0
        self.group_pruned = 0
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
        self._m_exhausted = reg.counter(
            "serve.pool_exhausted_total",
            "admissions requeued because the block pool ran dry")
        self._m_drafted = reg.counter("spec.drafted_total")
        self._m_accepted = reg.counter("spec.accepted_total")
        self._m_eval_reqs = reg.counter("serve.eval_requests_total")
        self._m_eval_tokens = reg.counter(
            "serve.eval_tokens_scored_total",
            "continuation tokens loglikelihood-scored")
        self._m_groups = reg.counter("serve.beam_groups_total",
                                     "beam/best-of groups admitted")
        self._m_group_forks = reg.counter(
            "serve.beam_forks_total", "slot forks for beam/best-of")
        self._m_group_pruned = reg.counter(
            "serve.beam_pruned_total", "beams pruned or retired early")
        self._m_constrained = reg.counter(
            "serve.constrained_tokens_total",
            "tokens decoded under an allowed-token mask")
        self._exhausted_streak = 0

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               eos_id=_UNSET, frontend_embeds=None, token_mask=None,
               mask_fn: Optional[Callable[[List[int]], Any]] = None
               ) -> int:
        """Queue one request; returns its request id.  The submit time is
        stamped here: `ttft` and `latency` include the queue wait.

        `token_mask` constrains every sampled token to an allowed set (a
        (vocab_size,) bool mask or an id list, `Engine.set_slot_mask`);
        ``mask_fn(tokens_so_far) -> allowed`` recomputes the set after each
        emission (grammar decoding: the grammar state advances with the
        generated prefix).  The mask streams through the sampling kernel's
        vocab scan, so a disallowed token is never drawn.
        `frontend_embeds` (1, F, d) go ahead of the prompt on an arch
        with a frontend (`Engine.prefill_into_slot`)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = (self.default_max_new if max_new_tokens is None
                   else max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        budget = len(prompt) + max_new - 1          # cache entries needed
        # a speculative engine can overshoot the budget by up to K cache
        # entries mid-verify (rolled back, but they must fit)
        margin = int(getattr(self.engine, "spec_k", 0))
        if budget + margin > self.engine.sc.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new})"
                + (f" + spec margin ({margin})" if margin else "")
                + f" exceeds the engine cache capacity "
                f"max_len={self.engine.sc.max_len}")
        if token_mask is not None or mask_fn is not None:
            self._require_modes("constrained decoding")
            if self._groups or any(r.kind in ("beam", "best_of")
                                   for r in self.queue):
                # group steps advance through the UNMASKED top-k decode
                raise ValueError("constrained requests cannot run "
                                 "alongside beam/best-of groups")
        rid = self._next_rid
        self._next_rid += 1
        self._submit_t[rid] = time.perf_counter()
        self.queue.append(Request(
            rid, prompt, max_new,
            self.default_eos if eos_id is _UNSET else eos_id,
            frontend_embeds=frontend_embeds, token_mask=token_mask,
            mask_fn=mask_fn))
        self._m_qdepth.set(len(self.queue))
        return rid

    def _require_modes(self, what: str):
        if not getattr(self.engine, "supports_modes", False):
            raise NotImplementedError(
                f"{what} needs the plain one-token engines "
                f"({type(self.engine).__name__} does not support "
                "request modes)")

    def submit_eval(self, prompt, continuations,
                    frontend_embeds=None) -> int:
        """Queue one loglikelihood-eval request: score every continuation
        under `prompt` (lm-eval-style multiple choice).  ``results[rid]``
        becomes a list of per-token logprob arrays, one per continuation,
        in order.  On paged engines with the prefix cache the prompt
        forward runs once; later continuations replay it from the trie
        and prefill only their suffix."""
        self._require_modes("loglikelihood eval")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        conts = [np.asarray(c, np.int32).reshape(-1) for c in continuations]
        if not conts:
            raise ValueError("submit_eval needs >= 1 continuation")
        for c in conts:
            if c.size < 1:
                raise ValueError("empty continuation")
            if len(prompt) + c.size > self.engine.sc.max_len:
                raise ValueError(
                    f"prompt ({len(prompt)}) + continuation ({c.size}) "
                    f"exceeds max_len={self.engine.sc.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._submit_t[rid] = time.perf_counter()
        self.queue.append(Request(rid, prompt, 1, None, kind="eval",
                                  frontend_embeds=frontend_embeds,
                                  payload={"conts": conts, "scores": []}))
        self._m_qdepth.set(len(self.queue))
        return rid

    def _submit_group(self, kind: str, prompt, n: int, payload,
                      max_new_tokens, eos_id, frontend_embeds) -> int:
        self._require_modes(f"{kind} decoding")
        if self.engine.sc.temperature != 0.0:
            # plain requests sharing a tick with a group advance through
            # the group's top-k step, which takes the best candidate
            raise ValueError(
                "beam/best-of groups require sc.temperature == 0.0 "
                "(concurrent plain requests stay greedy); best-of "
                "sampling temperature is per-request")
        if self.engine._slot_masks or any(
                r.token_mask is not None or r.mask_fn is not None
                for r in self.queue):
            raise ValueError("beam/best-of groups cannot run alongside "
                             "constrained requests")
        if not 1 <= n <= self.engine.batch_size:
            raise ValueError(f"group width {n} outside "
                             f"[1, {self.engine.batch_size}]")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = (self.default_max_new if max_new_tokens is None
                   else max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new}")
        if len(prompt) + max_new - 1 > self.engine.sc.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"max_len={self.engine.sc.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._submit_t[rid] = time.perf_counter()
        self.queue.append(Request(
            rid, prompt, max_new,
            self.default_eos if eos_id is _UNSET else eos_id, kind=kind,
            frontend_embeds=frontend_embeds, payload=dict(payload, n=n)))
        self._m_qdepth.set(len(self.queue))
        return rid

    def submit_beam(self, prompt, *, n_beams: int,
                    max_new_tokens: Optional[int] = None,
                    eos_id=_UNSET, frontend_embeds=None) -> int:
        """Queue one beam-search request (`modes.BeamGroup`): `n_beams`
        sibling slots decode in the shared batch, forked copy-on-write on
        paged engines.  ``results[rid]`` is the best hypothesis' tokens,
        ``hypotheses[rid]`` the ranked top-n list."""
        return self._submit_group("beam", prompt, n_beams, {},
                                  max_new_tokens, eos_id, frontend_embeds)

    def submit_best_of(self, prompt, *, n: int, temperature: float = 1.0,
                       top_p: Optional[float] = None, seed: int = 0,
                       max_new_tokens: Optional[int] = None,
                       eos_id=_UNSET, frontend_embeds=None) -> int:
        """Queue one best-of-n request (`modes.BestOfGroup`): n independent
        samples at `temperature` from the engine's ``top_k`` survivors,
        ranked by cumulative logprob.  ``results[rid]`` is the best
        sample."""
        return self._submit_group(
            "best_of", prompt, n,
            {"temperature": temperature, "top_p": top_p, "seed": seed},
            max_new_tokens, eos_id, frontend_embeds)

    # -- state machine ------------------------------------------------------

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        total = self.decode_steps * self.engine.batch_size
        return self.slot_busy_steps / total if total else 0.0

    def _finish_request(self, rid: int, **span_kw) -> float:
        """Completion bookkeeping shared by every request kind; returns
        the completion time."""
        t_end = time.perf_counter()
        t_sub = self._submit_t[rid]
        self.latency[rid] = t_end - t_sub
        self._m_latency.observe(self.latency[rid])
        self._m_finished.inc()
        self.tracer.add_span("req", t_sub, t_end, rid=rid, **span_kw)
        return t_end

    def _finish(self, idx: int):
        slot = self.slots[idx]
        rid = slot.req.rid
        self.results[rid] = np.asarray(slot.tokens, np.int32)
        n_tok = len(slot.tokens)
        t_end = self._finish_request(rid, tokens=n_tok)
        if n_tok > 1:
            self.tpot[rid] = ((self.latency[rid] - self.ttft[rid])
                              / (n_tok - 1))
            self._m_tpot.observe(self.tpot[rid])
        t_first = self._first_t.get(rid, t_end)
        self.tracer.add_span("req.decode", t_first, t_end, cat="request",
                             rid=rid, tokens=n_tok)
        self.slots[idx] = None
        self.engine.reset_slot(idx)

    def _token_arrived(self, idx: int, tok: int) -> bool:
        """Record one token for slot `idx`; returns True when it's done."""
        slot = self.slots[idx]
        slot.tokens.append(tok)
        done = (len(slot.tokens) >= slot.req.max_new_tokens
                or (slot.req.eos_id is not None
                    and tok == slot.req.eos_id))
        if slot.req.token_mask is not None or slot.req.mask_fn is not None:
            self._m_constrained.inc()
            if not done and slot.req.mask_fn is not None:
                # advance the grammar: the allowed set of the NEXT token
                # depends on everything generated so far
                self.engine.set_slot_mask(
                    idx, slot.req.mask_fn(list(slot.tokens)))
        if self.on_token is not None:
            self.on_token(slot.req.rid, tok, done)
        if done:
            self._finish(idx)
        return done

    def _requeue_exhausted(self, req: Request):
        """`PoolExhausted` backpressure: the request goes BACK to the
        queue head (FIFO-with-requeue) and admission stops for this
        tick; if nothing is running either, the request can never fit
        and the error re-raises."""
        self._note_pool_exhausted(req)
        self.queue.appendleft(req)
        if self.active == 0:
            raise

    def _note_pool_exhausted(self, req: Request):
        """Count the requeue, and log the pool's state once a dry spell."""
        self._m_exhausted.inc()
        self._exhausted_streak += 1
        if self._exhausted_streak > 1:
            return
        ps = self.engine.paged_stats()
        pre = ps.get("prefix", {})
        log.warning(
            "pool exhausted admitting request %d (%d prompt tokens): "
            "requeued at queue head, %d running / %d queued; pool %d/%d "
            "blocks in use, %d free, trie holds %d resident blocks (%d "
            "evicted so far)", req.rid, len(req.prompt), self.active,
            len(self.queue) + 1, ps["used_blocks"], ps["pool_blocks"],
            ps["free_blocks"], pre.get("resident_blocks", 0),
            pre.get("evicted_blocks", 0))

    def _stamp_admit(self, req: Request, t_admit: float):
        """Admission bookkeeping shared by every request kind (the
        prefill, or for eval the whole scoring pass, just ran)."""
        self._exhausted_streak = 0
        self.admit_order.append(req.rid)
        t_first = time.perf_counter()
        self.ttft[req.rid] = t_first - self._submit_t[req.rid]
        self._first_t[req.rid] = t_first
        self._m_qdepth.set(len(self.queue))
        self._m_admitted.inc()
        self._m_qwait.observe(self.queue_wait[req.rid])
        self._m_ttft.observe(self.ttft[req.rid])
        self.tracer.add_span("req.queue", self._submit_t[req.rid], t_admit,
                             cat="request", rid=req.rid)
        self.tracer.add_span("req.prefill", t_admit, t_first, cat="request",
                             rid=req.rid, prompt_len=len(req.prompt))

    def _admit(self):
        """Admit queued requests (strict FIFO).  A generate or eval request
        needs one free slot, a beam / best-of group its full width n: the
        queue head waits until enough slots free up (no skip-ahead, so
        wide groups cannot starve)."""
        while self.queue:
            req = self.queue[0]
            free = [i for i, s in enumerate(self.slots) if s is None]
            need = (req.payload["n"] if req.kind in ("beam", "best_of")
                    else 1)
            if len(free) < need:
                return
            self.queue.popleft()
            t_admit = time.perf_counter()
            self.queue_wait[req.rid] = t_admit - self._submit_t[req.rid]
            try:
                if req.kind == "eval":
                    self._run_eval(req, free[0])
                elif req.kind == "generate":
                    first = self._prefill_generate(req, free[0])
                else:
                    group, used = self._prefill_group(req, free[:need])
            except PoolExhausted:
                self._requeue_exhausted(req)
                return
            self._stamp_admit(req, t_admit)
            if req.kind == "eval":
                self._finish_request(req.rid, conts=len(
                    req.payload["conts"]))
            elif req.kind == "generate":
                self.slots[free[0]] = _Slot(req, [])
                self._token_arrived(free[0], first)
            else:
                self._admit_group(group, used)

    def _prefill_generate(self, req: Request, idx: int) -> int:
        """A generate request's prefill (under its mask, if it has one);
        returns the first token.  A failed prefill clears the mask."""
        masked = req.token_mask is not None or req.mask_fn is not None
        if masked:
            self.engine.set_slot_mask(
                idx, req.token_mask if req.token_mask is not None
                else req.mask_fn([]))
        try:
            return self.engine.prefill_into_slot(
                idx, req.prompt, frontend_embeds=req.frontend_embeds)
        except BaseException:
            if masked:
                self.engine.set_slot_mask(idx, None)
            raise

    def _prefill_group(self, req: Request, slots: List[int]):
        """A group's admission: prefill into ``slots[0]`` and fork its first
        candidates (`modes.BeamGroup` / `BestOfGroup` ``admit``); returns
        the group and the slots it took."""
        p = req.payload
        if req.kind == "beam":
            g = modes.BeamGroup(req.rid, req.prompt, p["n"],
                                req.max_new_tokens, req.eos_id,
                                req.frontend_embeds)
        else:
            g = modes.BestOfGroup(req.rid, req.prompt, p["n"],
                                  req.max_new_tokens, req.eos_id,
                                  req.frontend_embeds,
                                  temperature=p["temperature"],
                                  top_k=self.engine.sc.top_k,
                                  top_p=p["top_p"], seed=p["seed"])
        g.req = req
        return g, g.admit(self.engine, slots)

    def _admit_group(self, g, used: List[int]):
        for s in used:
            self.slots[s] = _Slot(g.req, [])
            self._group_slots[s] = g
        self._m_groups.inc()
        if g.done:
            self._finalize_group(g)
        else:
            self._groups[g.rid] = g

    def _finalize_group(self, g):
        """Record a finished group: the best hypothesis under `results`,
        the ranked top n under `hypotheses`."""
        hyps = g.result()
        self.hypotheses[g.rid] = hyps
        best = hyps[0].tokens if hyps else []
        self.results[g.rid] = np.asarray(best, np.int32)
        self.group_forks += g.forks
        self.group_pruned += g.pruned
        self._m_group_forks.inc(g.forks)
        self._m_group_pruned.inc(g.pruned)
        self._groups.pop(g.rid, None)
        self._finish_request(g.rid, kind=g.kind, beams=g.n,
                             tokens=len(best))

    def _run_eval(self, req: Request, idx: int):
        """Score every continuation of an eval request through slot `idx`,
        synchronously (each scoring pass is a batch=1 prefill, the cost
        one admit already pays).  Partial scores survive a
        `PoolExhausted` requeue: the retry resumes at the first unscored
        continuation, and the earlier continuations' trie insertions make
        the retried prompt replay cheap."""
        conts = req.payload["conts"]
        scores = req.payload["scores"]
        with self.tracer.span("req.eval", cat="request", rid=req.rid,
                              conts=len(conts)):
            while len(scores) < len(conts):
                cont = conts[len(scores)]
                logp = self.engine.score_in_slot(idx, req.prompt, cont,
                                                 req.frontend_embeds)
                self.engine.reset_slot(idx)
                scores.append(logp)
                self.eval_tokens_scored += len(cont)
                self._m_eval_tokens.inc(len(cont))
        self.eval_requests += 1
        self._m_eval_reqs.inc()
        self.results[req.rid] = list(scores)

    def step(self) -> int:
        """One scheduler tick: admit, then advance every busy slot by one
        engine step: one token for plain engines, up to ``spec_k + 1`` for
        a speculative engine.  A slot that hits EOS or its budget
        mid-burst finishes there and the rest of its burst is dropped
        (its caches are reset).  Returns the number of busy slots."""
        self._admit()
        self.peak_active = max(self.peak_active, self.active)
        busy = [i for i, s in enumerate(self.slots) if s is not None]
        self._m_active.set(len(busy))
        if not busy:
            return 0
        if self._groups:
            return self._step_with_groups(busy)
        with self.tracer.span("sched.decode_step", cat="sched",
                              step=self.decode_steps, busy=len(busy)):
            toks, counts = self.engine.decode_step_multi()
        self.decode_steps += 1
        self.slot_busy_steps += len(busy)
        spec_k = int(getattr(self.engine, "spec_k", 0))
        emitted0 = self.tokens_emitted
        for idx in busy:
            n = int(counts[idx])
            for j in range(n):
                self.tokens_emitted += 1
                if self._token_arrived(idx, int(toks[idx, j])):
                    break
            if spec_k:
                self.spec_drafted += spec_k
                self.spec_accepted += n - 1   # the bonus token is no draft
                self._m_drafted.inc(spec_k)
                self._m_accepted.inc(n - 1)
        step_toks = self.tokens_emitted - emitted0
        self._m_tokens.inc(step_toks)
        self._m_tps.observe(step_toks / len(busy))
        return len(busy)

    def _step_with_groups(self, busy: List[int]) -> int:
        """One tick while beam / best-of groups are live: a single
        `decode_topk_step` advances EVERY busy slot (one vocab scan a row,
        its lse giving the candidates' logprobs).  Plain slots take the
        best candidate, the token their greedy decode gives; group slots
        hand their rows to the group's host-side selection (fork and
        prune through claim / release)."""
        k = max(g.k_cand for g in self._groups.values())
        with self.tracer.span("sched.decode_step", cat="sched",
                              step=self.decode_steps, busy=len(busy),
                              groups=len(self._groups)):
            vals, idxs, lse = self.engine.decode_topk_step(k)
        self.decode_steps += 1
        self.slot_busy_steps += len(busy)
        emitted0 = self.tokens_emitted
        for idx in busy:
            if idx in self._group_slots or self.slots[idx] is None:
                continue
            tok = int(idxs[idx, 0])
            self.engine.cur[idx] = tok
            self.tokens_emitted += 1
            self._token_arrived(idx, tok)

        for g in list(self._groups.values()):
            def claim(g=g):
                for i, s in enumerate(self.slots):
                    if s is None:
                        self.slots[i] = _Slot(g.req, [])
                        self._group_slots[i] = g
                        return i
                return None

            def release(s):
                self.slots[s] = None
                self._group_slots.pop(s, None)
                self.engine.reset_slot(s)

            self.tokens_emitted += g.step(self.engine, vals, idxs, lse,
                                          claim, release)
            if g.done:
                self._finalize_group(g)
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
    def acceptance_rate(self) -> float:
        """Accepted drafted tokens / drafted tokens (0.0 for plain)."""
        return self.spec_accepted / self.spec_drafted \
            if self.spec_drafted else 0.0

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

        out = {
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
        if self.eval_requests or self.hypotheses:
            out["modes"] = {
                "eval_requests": self.eval_requests,
                "eval_tokens_scored": self.eval_tokens_scored,
                "group_requests": len(self.hypotheses),
                "group_forks": self.group_forks,
                "group_pruned": self.group_pruned,
            }
        paged = getattr(self.engine, "paged_stats", None)
        if paged is not None:
            out["paged"] = paged()
        spec_k = int(getattr(self.engine, "spec_k", 0))
        if spec_k:
            out["spec"] = {
                "k": spec_k,
                # 'self' (the target's own MTP heads, one cache tree) or
                # 'sidecar' (a draft model and a second cache tree)
                "mode": getattr(self.engine, "spec_mode", "sidecar"),
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "acceptance_rate": round(self.acceptance_rate, 4),
            }
        return out
