"""Logits-free request modes on the serving primitives (port of
`repro.serve.modes`).

Beside loglikelihood eval (`Engine.score_in_slot`), two request shapes
beyond plain generation, built on the same streaming vocab scan; none
ever forms a (B, V) logits tensor:

  * **Best-of-n / beam search** — `BeamGroup` / `BestOfGroup` drive n
    sibling slots through the batched decode.  Each step's candidate
    logprobs come from the top-k kernel's ``return_lse`` output
    (``logp = vals - lse`` of one vocab scan, `Engine.decode_topk_step`);
    beam forks duplicate a slot through `Engine.fork_slot`, which on the
    paged engine is a `BlockPool.fork` refcount bump: sibling beams share
    every block copy-on-write until they diverge.
  * **Constrained decoding** — `Engine.set_slot_mask` pins a per-slot
    allowed-token set; the mask streams through the sampling kernel as an
    s8 (B, V) input (`sample_topk` ``allowed_mask``), scoring disallowed
    tokens -inf INSIDE the vocab scan, so no temperature or top-p setting
    can ever emit one.

The JAX package compiles these modes' forwards as jitted closures
(`ModeFns`); PyTorch runs eagerly, so their bodies are plain engine
methods here (`Engine.decode_topk_step`, `prefill_topk_into_slot`, the
masked prefill and decode).  Beam bookkeeping (cumulative logprobs,
hypothesis sets, slot forking and pruning) is host-side numpy on the
(B, k) kernel outputs, as in the reference: k is tiny, and the vocab
never leaves the kernel.  `BestOfGroup` draws with
``np.random.default_rng(seed)`` exactly as the reference does, so
best-of-n is token-exact against the JAX package on the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Hypothesis:
    """One finished beam: generated tokens + cumulative logprob."""
    tokens: List[int]
    logp: float


class _DecodeGroup:
    """n sibling slots decoding one request; the scheduler owns slot
    accounting through the `claim` / `release` callbacks and feeds each
    step's (vals, idxs, lse) rows from `Engine.decode_topk_step`."""

    kind = "group"

    def __init__(self, rid: int, prompt, n: int, max_new: int,
                 eos_id: Optional[int], frontend_embeds=None):
        if n < 1:
            raise ValueError(f"group width {n} < 1")
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.n = n
        self.max_new = max_new
        self.eos_id = eos_id
        self.frontend_embeds = frontend_embeds
        self.slots: List[int] = []
        self.cum: List[float] = []
        self.toks: List[List[int]] = []
        self.finished: List[Hypothesis] = []
        self.done = False
        self.forks = 0
        self.pruned = 0

    # -- shared machinery ---------------------------------------------------

    @property
    def k_cand(self) -> int:
        raise NotImplementedError

    def _finish(self, prev: List[int], tok: int, lp: float):
        self.finished.append(Hypothesis(prev + [tok], lp))

    def _spawn(self, engine, live: List[Tuple[float, int, int]],
               slot_of: Callable[[int], int],
               claim: Optional[Callable[[], Optional[int]]]):
        """Assign a slot to every selected (lp, parent, tok) candidate:
        the first child of a parent inherits its slot, later children
        fork.  ``claim() -> slot | None``; None drops the candidate (the
        scheduler had no free slot)."""
        new_slots, new_cum, new_toks = [], [], []
        taken = set()
        for lp, b, tok in live:
            src = slot_of(b)
            if b not in taken:
                s = src
                taken.add(b)
            else:
                s = claim() if claim is not None else None
                if s is None:
                    self.pruned += 1
                    continue
                engine.fork_slot(s, src)
                self.forks += 1
            engine.cur[s] = tok
            new_slots.append(s)
            new_cum.append(lp)
            new_toks.append((self.toks[b] if b >= 0 else []) + [tok])
        self.slots, self.cum, self.toks = new_slots, new_cum, new_toks

    def _adopt(self, engine, live: List[Tuple[float, int, int]],
               slots: List[int]) -> List[int]:
        """Admit-time `_spawn` of the first-token candidates (parent -1):
        the first adopts the prefilled ``slots[0]``, the rest fork its
        cache into the following slots (copy-on-write block shares on the
        paged engine).  Returns the slots occupied."""
        rest = iter(slots[1:])
        self._spawn(engine, live, lambda b: slots[0],
                    lambda: next(rest, None))
        self.done = not self.slots
        return list(self.slots)

    def _release_all(self, release):
        for s in self.slots:
            release(s)
        self.slots, self.cum, self.toks = [], [], []
        self.done = True

    def result(self) -> List[Hypothesis]:
        """Hypotheses sorted by cumulative logprob, best first (top n)."""
        return sorted(self.finished, key=lambda h: -h.logp)[:self.n]

    # -- interface the scheduler drives -------------------------------------

    def admit(self, engine, slots: List[int]) -> List[int]:
        """Prefill into ``slots[0]``, pick the first-token candidates, fork
        the extra beams.  Returns the slots actually occupied (a prefix
        of `slots`; fewer than n when candidates finish at once)."""
        raise NotImplementedError

    def step(self, engine, vals, idxs, lse, claim, release) -> int:
        """Advance one decode step from the (B, k) / (B,) kernel outputs.
        Returns the number of live tokens emitted; sets `self.done`."""
        raise NotImplementedError


class BeamGroup(_DecodeGroup):
    """Deterministic beam search, HF-style selection: each step ranks the
    ``live x 2n`` continuation candidates by cumulative logprob; EOS (or
    budget-capped) candidates retire to the hypothesis set, the best n
    survivors continue.  Terminates when no live beam can beat the n-th
    best finished hypothesis (per-token logprob increments are <= 0, so
    cumulative scores only fall)."""

    kind = "beam"

    @property
    def k_cand(self) -> int:
        # n == 1 is greedy: k = 1 keeps the decode step token-identical
        # to the plain engine's (same kernel, same plan)
        return 1 if self.n == 1 else 2 * self.n

    def _select(self, cand):
        """cand: [(cum_lp, parent_idx, tok)] sorted desc (parent -1 at
        admit time = empty prefix).  Retires EOS / budget candidates,
        returns up to n live survivors."""
        live = []
        for lp, b, tok in cand:
            if not np.isfinite(lp):
                continue
            prev = self.toks[b] if b >= 0 else []
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if hit_eos or len(prev) + 1 >= self.max_new:
                self._finish(prev, tok, lp)
                continue
            live.append((lp, b, tok))
            if len(live) == self.n:
                break
        return live

    def _beaten(self, live) -> bool:
        """True when the best live beam can no longer enter the top-n
        finished set (scores do not rise with length)."""
        if len(self.finished) < self.n:
            return False
        nth = sorted((h.logp for h in self.finished), reverse=True)[
            self.n - 1]
        return not live or live[0][0] <= nth

    def admit(self, engine, slots: List[int]) -> List[int]:
        vals, idxs, lse = engine.prefill_topk_into_slot(
            slots[0], self.prompt, self.k_cand,
            frontend_embeds=self.frontend_embeds)
        logp = vals - lse
        cand = [(float(logp[j]), -1, int(idxs[j]))
                for j in range(len(logp))]
        live = self._select(cand)
        return self._adopt(engine, [] if self._beaten(live) else live,
                           slots)

    def step(self, engine, vals, idxs, lse, claim, release) -> int:
        cand = []
        for b, s in enumerate(self.slots):
            row_lp = vals[s] - lse[s]
            for j in range(idxs.shape[1]):
                cand.append((self.cum[b] + float(row_lp[j]), b,
                             int(idxs[s, j])))
        cand.sort(key=lambda c: -c[0])
        live = self._select(cand)
        if not live or self._beaten(live):
            self.pruned += len(self.slots)
            self._release_all(release)
            return 0
        old_slots = list(self.slots)
        with_child = {b for _, b, _ in live}
        for b, s in enumerate(old_slots):
            if b not in with_child:
                release(s)
                self.pruned += 1
        self._spawn(engine, live, lambda b: old_slots[b], claim)
        self.done = not self.slots
        return len(self.slots)


class BestOfGroup(_DecodeGroup):
    """n independent temperature samples of one prompt, scored by true
    cumulative logprob (``vals - lse`` of each drawn token).  Sampling
    happens on the host over the (k,) survivor row (a numpy mirror of
    `sample_tokens`' top-k / top-p / temperature chain), so sibling chains
    draw different tokens from one shared kernel row."""

    kind = "best_of"

    def __init__(self, rid: int, prompt, n: int, max_new: int,
                 eos_id: Optional[int], frontend_embeds=None, *,
                 temperature: float = 1.0, top_k: int = 40,
                 top_p: Optional[float] = None, seed: int = 0):
        super().__init__(rid, prompt, n, max_new, eos_id, frontend_embeds)
        if temperature < 0.0:
            raise ValueError("best-of-n temperature must be >= 0")
        self.temperature = temperature
        self.top_p = top_p
        self._k = max(1, int(top_k)) if temperature > 0.0 else 1
        self._rng = np.random.default_rng(seed)

    @property
    def k_cand(self) -> int:
        return self._k

    def _draw(self, row_vals) -> int:
        """Sample a candidate index from one descending (k,) logit row."""
        z = np.asarray(row_vals, np.float64).copy()
        if self.temperature <= 0.0:
            return 0
        z /= self.temperature
        if self.top_p is not None and self.top_p < 1.0:
            zm = z - np.max(z[np.isfinite(z)])
            p = np.exp(zm, where=np.isfinite(zm), out=np.zeros_like(zm))
            p /= p.sum()
            keep = (np.cumsum(p) - p) < self.top_p   # rows sorted desc
            z[~keep] = -np.inf
        z -= np.max(z[np.isfinite(z)])
        p = np.exp(z, where=np.isfinite(z), out=np.zeros_like(z))
        p /= p.sum()
        return int(self._rng.choice(len(z), p=p))

    def _child(self, vals, idxs, lse) -> Tuple[float, int]:
        j = self._draw(vals)
        return float(vals[j] - lse), int(idxs[j])

    def admit(self, engine, slots: List[int]) -> List[int]:
        vals, idxs, lse = engine.prefill_topk_into_slot(
            slots[0], self.prompt, self.k_cand,
            frontend_embeds=self.frontend_embeds)
        live = []
        for _ in range(self.n):
            lp, tok = self._child(vals, idxs, lse)
            if (self.eos_id is not None and tok == self.eos_id) \
                    or self.max_new <= 1:
                self._finish([], tok, lp)
            else:
                live.append((lp, -1, tok))
        return self._adopt(engine, live, slots)

    def step(self, engine, vals, idxs, lse, claim, release) -> int:
        del claim
        keep_s, keep_c, keep_t = [], [], []
        emitted = 0
        for b, s in enumerate(self.slots):
            lp, tok = self._child(vals[s], idxs[s], lse[s])
            cum = self.cum[b] + lp
            toks = self.toks[b] + [tok]
            emitted += 1
            if (self.eos_id is not None and tok == self.eos_id) \
                    or len(toks) >= self.max_new:
                self.finished.append(Hypothesis(toks, cum))
                release(s)
                continue
            engine.cur[s] = tok
            keep_s.append(s)
            keep_c.append(cum)
            keep_t.append(toks)
        self.slots, self.cum, self.toks = keep_s, keep_c, keep_t
        self.done = not self.slots
        return emitted


# ---------------------------------------------------------------------------
# constrained-decoding mask helpers
# ---------------------------------------------------------------------------


def allowed_ids_mask(ids, vocab_size: int) -> np.ndarray:
    """(V,) uint8 allowed-token mask from an id list."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    if ids.size == 0:
        raise ValueError("empty allowed-token set")
    if (ids < 0).any() or (ids >= vocab_size).any():
        raise ValueError(f"allowed ids outside [0, {vocab_size})")
    mask = np.zeros((vocab_size,), np.uint8)
    mask[ids] = 1
    return mask


def parse_mask_spec(spec: str, vocab_size: int) -> np.ndarray:
    """CLI grammar-mask spec -> (V,) uint8 mask.

    ``"3,7,42"`` — an explicit id list; ``"range:lo-hi"`` — ids in
    [lo, hi); ``"even"`` / ``"odd"`` — parity subsets (toy grammars for
    benchmarks and tests).  A real grammar compiles to such a per-step set
    through `ContinuousScheduler.submit`'s `mask_fn`."""
    spec = spec.strip()
    if spec == "even":
        ids = np.arange(0, vocab_size, 2)
    elif spec == "odd":
        ids = np.arange(1, vocab_size, 2)
    elif spec.startswith("range:"):
        lo, hi = spec[len("range:"):].split("-", 1)
        ids = np.arange(max(int(lo), 0), min(int(hi), vocab_size))
    else:
        ids = np.array([int(t) for t in spec.split(",") if t.strip()],
                       np.int64)
    return allowed_ids_mask(ids, vocab_size)
