"""Speculative decoding: draft K tokens, verify them logits-free (port of
`repro.serve.spec`).

One engine step serves every slot up to K+1 tokens:

  1. **propose** — a draft proposes K tokens per slot: a small sidecar
     model through K single-token decode steps plus one catch-up step
     (`SpecEngine`), or the target's own MTP heads at the previous
     step's accepted position (`SelfSpecEngine`);
  2. **verify** — the target runs ONE cached multi-token forward over
     ``[cur, d_1..d_K]`` (``decode=True``); the streaming top-k sampler
     draws the target's own choice at all B*(K+1) positions in one call,
     and in rejection mode (temperature > 0) the `score_tokens` kernel
     gathers ``log p(d_i | prefix)`` for all B*K drafted tokens in one
     call — the (B, K+1, V) verification logits never exist;
  3. **accept** — greedy mode keeps the longest prefix of drafts equal to
     the target's argmax (no scoring pass); rejection mode keeps draft i
     with probability ``min(1, p_t(d_i) / p_d(d_i))``, both scored at
     their model's SAMPLING temperature, through the cumulative product
     of the per-position acceptances.  A step emits the accepted prefix
     plus one token the target chose: 1..K+1 tokens;
  4. **roll back** — the K - n_acc rejected entries leave every cache by
     length arithmetic (`registry.rollback_slot_caches`), or, for the
     recurrent families' state and griffin's ring buffers (the
     ``'scan'`` strategy), each slot takes the snapshot after its n_acc + 1 kept
     tokens (`registry.rollback_snapshot_caches`): the verification of
     such a model is K+1 single-token forwards with a snapshot after
     each, and so are the draft's steps.

The port's caches are updated IN PLACE, so a snapshot is a copy of what
the next forward writes in place (`registry.snapshot_caches`: the ring
buffers); without it every snapshot would alias the last state and the
rollback would silently do nothing.

The step functions are plain functions on tensors; random draws take an
explicit `torch.Generator` (they do not reproduce ``jax.random``, so
parity with the JAX package is greedy-exact, and rejection mode is held
to JAX's scores and acceptance rule on the same inputs).  Rejection
mode's replacement token comes from the target's top-k distribution at
the rejection position, as in the JAX package (an approximation of the
exact residual distribution, which needs the full logits row).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import Arch
from repro_torch.kernels.score_tokens import score_tokens
from repro_torch.models.registry import (apply_mtp_heads, forward_hidden,
                                         init_params, rollback_slot_caches,
                                         rollback_snapshot_caches,
                                         snapshot_caches,
                                         spec_cache_strategy, supports_mtp)
from repro_torch.serve.engine import Engine, ServeConfig, make_sampler


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding knobs (the target's stay in ServeConfig).

    k: drafted tokens per engine step (a step emits 1..k+1 tokens).
    score_impl: 'kernel', the only scorer: `score_tokens` launches the
        CUDA kernel on CUDA tensors and runs its plain version on CPU ones.
    draft_temperature: draft proposal temperature; None follows the
        target's (a greedy target drafts greedily, which is what makes
        greedy acceptance exact).
    """
    k: int = 4
    score_impl: str = "kernel"
    draft_temperature: Optional[float] = None

    def __post_init__(self):
        if self.score_impl != "kernel":
            raise ValueError(f"unknown score impl {self.score_impl!r}: "
                             "'kernel' is the only one")


def small_draft(arch: Arch, seed: int = 7, device="cpu", **overrides):
    """(draft_arch, draft_params): a 1-layer, narrow draft of the same
    family sharing `arch`'s vocabulary, seeded by `seed` on `device`.
    The defaults are the JAX package's (d_model 32), for the CPU; on the
    card the kernels need ``d % 64 == 0``, so pass full-width overrides
    (e.g. the target's d_model, heads and d_ff)."""
    fields = dict(name=arch.cfg.name + "-draft", n_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=1, head_dim=16, d_ff=48)
    fields.update(overrides)
    draft_arch = dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, **fields))
    gen = torch.Generator(device=device).manual_seed(seed)
    return draft_arch, init_params(draft_arch, gen, device)


def verify_forward(arch: Arch, params, caches, seq: torch.Tensor,
                   strat: str):
    """The target's multi-token verification forward over `seq` (B, S).

    ``'len'``: ONE cached ``decode=True`` forward (per-row append, causal
    over the whole cache); ``'scan'``: S single-token forwards with a
    snapshot before the first and after each (`snapshot_caches`; the
    last is the live tree).  Returns (hiddens (B, S, d), new_caches,
    snapshots or None)."""
    if strat == "len":
        h, _, caches = forward_hidden(arch, params, {"tokens": seq},
                                      caches=caches, decode=True)
        return h, caches, None
    hs, snaps = [], []
    for j in range(seq.shape[1]):
        snaps.append(snapshot_caches(caches))
        hj, _, caches = forward_hidden(arch, params,
                                       {"tokens": seq[:, j:j + 1]},
                                       caches=caches)
        hs.append(hj[:, -1, :])
    snaps.append(caches)
    return torch.stack(hs, dim=1), caches, snaps


def _rollback(caches, snaps, n_acc, k):
    """Keep each slot's n_acc + 1 consumed tokens of the step: length
    arithmetic (``snaps`` None) or the per-slot snapshot."""
    if snaps is None:
        return rollback_slot_caches(caches, k - n_acc)
    return rollback_snapshot_caches(snaps, n_acc + 1, k - n_acc)


def _score_lp(h2, w, ids, *, valid, cap, temp, w_scale=None):
    """log p(ids | h2) (N, P) under the shared lm_head at temperature
    `temp` (<= 0 or None: unscaled); `w_scale` marks a quantized head."""
    logp, _ = score_tokens(h2.contiguous(), w, ids, valid_vocab=valid,
                           logit_softcap=cap, temperature=temp,
                           w_scale=w_scale)
    return logp


def _accept(acc: torch.Tensor, draft: torch.Tensor, choice: torch.Tensor):
    """Per-slot emissions from the per-position acceptances `acc` (B, K):
    the accepted prefix (cumulative product), then the target's own
    choice at the first rejection (or the bonus after K).  Returns
    (tokens (B, K+1) zero-padded, counts (B,), n_acc (B,))."""
    b, k = draft.shape
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    pos = torch.arange(k + 1, device=draft.device)[None, :]
    dpad = torch.cat([draft, draft.new_zeros((b, 1))], dim=1)
    bonus = torch.gather(choice, 1, n_acc[:, None].long())
    out = torch.where(pos < n_acc[:, None], dpad, 0)
    out = torch.where(pos == n_acc[:, None], bonus, out)
    return out.to(torch.int32), (n_acc + 1).to(torch.int32), n_acc


def _uniform(shape, generator, device):
    """U[1e-20, 1) draws of the rejection test (log u stays finite)."""
    return torch.rand(shape, generator=generator,
                      device=device).clamp_min(1e-20)


def build_spec_step(arch: Arch, draft_arch: Arch, sc: ServeConfig,
                    spec: SpecConfig):
    """The sidecar speculative step.

    spec_step(params, dparams, caches, dcaches, cur (B, 1), generator) ->
        (tokens (B, K+1) int32, counts (B,) int32, caches, dcaches,
         n_accepted (B,))

    Per slot, ``tokens[:counts]`` are this step's emissions.  Free slots
    compute rows that callers ignore."""
    k = spec.k
    if k < 1:
        raise ValueError(f"spec.k must be >= 1, got {k}")
    if draft_arch.vocab_size != arch.vocab_size:
        raise ValueError(
            f"draft vocab {draft_arch.vocab_size} != target vocab "
            f"{arch.vocab_size}: draft and target must share a tokenizer")
    valid = arch.vocab_size
    target_cap = arch.cfg.logit_softcap
    draft_cap = draft_arch.cfg.logit_softcap
    greedy = sc.temperature == 0.0
    draft_temp = (sc.temperature if spec.draft_temperature is None
                  else spec.draft_temperature)
    t_strat = spec_cache_strategy(arch)
    d_scan = spec_cache_strategy(draft_arch) == "scan"
    sampler_t = make_sampler(arch, sc)
    sampler_d = make_sampler(draft_arch, sc)

    def spec_step(params, dparams, caches, dcaches, cur, gen):
        b = cur.shape[0]
        # quantized-head serving: both engines carry the per-row scales
        # beside their 1-byte lm_head (Engine.__init__)
        t_ws = params.get("lm_head_scale")
        d_ws = dparams.get("lm_head_scale")
        # ---- 1. draft proposal: K sampled tokens + one catch-up step so
        # the draft cache consumes d_K too (kept only if all K accepted)
        d_tokens, d_hidden = [], []
        d_snaps = [] if d_scan else None
        tok = cur
        for i in range(k + 1):
            if d_scan:
                d_snaps.append(snapshot_caches(dcaches))
            h, _, dcaches = forward_hidden(draft_arch, dparams,
                                           {"tokens": tok}, caches=dcaches)
            if i == k:
                break
            h_last = h[:, -1, :]
            nxt = sampler_d(h_last, dparams["lm_head"], draft_temp, gen,
                            w_scale=d_ws)
            d_hidden.append(h_last)
            d_tokens.append(nxt)
            tok = nxt[:, None]
        draft = torch.stack(d_tokens, dim=1)                 # (B, K)
        if not greedy:
            # one batched (B*K)-row vocab scan instead of K scans of B
            dh = torch.stack(d_hidden, dim=1).reshape(b * k, -1)
            d_lp = _score_lp(dh, dparams["lm_head"], draft.reshape(b * k, 1),
                             valid=valid, cap=draft_cap, temp=draft_temp,
                             w_scale=d_ws).reshape(b, k)

        # ---- 2. target verification over [cur, d_1..d_K]
        seq = torch.cat([cur, draft], dim=1)                 # (B, K+1)
        h, caches, t_snaps = verify_forward(arch, params, caches, seq,
                                            t_strat)
        d_model = h.shape[-1]
        choice = sampler_t(h.reshape(b * (k + 1), d_model),
                           params["lm_head"], sc.temperature,
                           gen, w_scale=t_ws).reshape(b, k + 1)

        # ---- 3. acceptance
        if greedy:
            acc = draft == choice[:, :k]
        else:
            # position i's hidden state scores drafted token i+1
            t_lp = _score_lp(h[:, :k, :].reshape(b * k, d_model),
                             params["lm_head"], draft.reshape(b * k, 1),
                             valid=valid, cap=target_cap,
                             temp=sc.temperature,
                             w_scale=t_ws).reshape(b, k)
            u = _uniform((b, k), gen, cur.device)
            acc = torch.log(u) <= (t_lp - d_lp)             # min(1, pt/pd)
        out, counts, n_acc = _accept(acc, draft, choice)

        # ---- 4. roll back the K - n_acc rejected positions (both models
        # consumed K+1 tokens and keep n_acc + 1 of them)
        caches = _rollback(caches, t_snaps, n_acc, k)
        if d_scan:
            d_snaps.append(dcaches)
        dcaches = _rollback(dcaches, d_snaps, n_acc, k)
        return out, counts, caches, dcaches, n_acc

    return spec_step


def _tune_verify(eng: Engine, topk_rows):
    """Tune a speculative engine's top-k at each row count of
    `topk_rows` and, at temperature > 0, `score_tokens` at B * K rows of
    one candidate (the drafts' scoring)."""
    from repro_torch.kernels.sample_topk.autotune import autotune_topk_plan
    from repro_torch.kernels.score_tokens.autotune import \
        autotune_score_plan
    v, d, dtype, wdtype = eng._tune_args()
    kw = dict(device=eng.device, trial_budget=eng.sc.tune_trial_budget,
              logit_softcap=eng.arch.cfg.logit_softcap, wdtype=wdtype)
    for n in sorted(set(topk_rows)):
        autotune_topk_plan(n, v, d, eng._sample_k(), dtype, **kw)
    if eng.sc.temperature != 0.0:
        autotune_score_plan(eng.sc.batch_size * eng.spec.k, v, d, 1, dtype,
                            **kw)


class SpecEngine(Engine):
    """Slot engine with a draft-model sidecar and speculative steps.

    The target side is a plain `Engine`; a second internal `Engine` owns
    the draft model's params and slab caches (same slot count and
    capacity), so prefill and slot recycling reuse the registry's cache
    surgery for both models.  `decode_step_multi` is the draft -> verify
    -> accept -> rollback cycle."""

    spec_mode = "sidecar"     # scheduler stats: draft model vs self-MTP
    # multi-token steps verify drafts unmasked: the request modes (eval
    # scoring) need the plain one-token engines
    supports_modes = False

    def __init__(self, arch: Arch, params, sc: ServeConfig,
                 draft_arch: Arch, draft_params,
                 spec: Optional[SpecConfig] = None, device="cuda"):
        self.spec = spec or SpecConfig()
        super().__init__(arch, params, sc, device=device)
        # the draft's own vocab scans stay untuned, as in the JAX package
        self.draft = Engine(draft_arch, draft_params,
                            dataclasses.replace(sc, autotune=False),
                            device=device)
        self.draft_arch = draft_arch
        self._spec_step = build_spec_step(arch, draft_arch, sc, self.spec)
        if sc.autotune:
            self._tune_spec_plans()

    @property
    def spec_k(self) -> int:
        return self.spec.k

    def _tune_spec_plans(self):
        """Tune the verify path's kernels for their exact shapes at
        construction: the top-k over B * (K + 1) rows and, in rejection
        mode only (greedy acceptance never scores), `score_tokens` over
        B * K rows of one candidate."""
        _tune_verify(self, (self.sc.batch_size * (self.spec.k + 1),))

    def reset(self, seed: int = 0):
        super().reset(seed)
        if hasattr(self, "draft"):                 # absent during __init__
            self.draft.reset(seed)

    def prefill_into_slot(self, slot: int, prompt, frontend_embeds=None
                          ) -> int:
        tok = super().prefill_into_slot(slot, prompt, frontend_embeds)
        # the draft's own first token is discarded: this fills the slot's
        # draft cache with the prompt
        self.draft.prefill_into_slot(slot, prompt, frontend_embeds)
        return tok

    def reset_slot(self, slot: int):
        super().reset_slot(slot)
        self.draft.reset_slot(slot)

    @torch.no_grad()
    def decode_step_multi(self) -> Tuple[np.ndarray, np.ndarray]:
        """One draft -> verify -> accept -> rollback cycle for every slot:
        (tokens (B, K+1), counts (B,)), the first ``counts`` tokens of a
        slot being its emissions, in order."""
        with self._tracer.span("spec.step", cat="spec", mode=self.spec_mode,
                               k=self.spec.k):
            cur = torch.from_numpy(self.cur[:, None].copy()).to(self.device)
            out, counts, self.caches, self.draft.caches, _ = \
                self._spec_step(self.params, self.draft.params, self.caches,
                                self.draft.caches, cur, self._gen)
            out = out.cpu().numpy().astype(np.int32)
            counts = counts.cpu().numpy().astype(np.int32)
        self.cur = out[np.arange(out.shape[0]), counts - 1].copy()
        return out, counts


# ---------------------------------------------------------------------------
# self-speculation from the target's own MTP heads
# ---------------------------------------------------------------------------


def _check_self_spec(arch: Arch, spec: SpecConfig):
    if spec.k < 1:
        raise ValueError(f"spec.k must be >= 1, got {spec.k}")
    if not supports_mtp(arch):
        raise ValueError(
            f"self-speculation needs MTP heads: arch {arch.arch_id!r} "
            f"(family {arch.family!r}) has mtp.n_heads={arch.mtp.n_heads}")
    if spec.k > arch.mtp.n_heads:
        raise ValueError(
            f"spec.k={spec.k} exceeds the arch's mtp.n_heads="
            f"{arch.mtp.n_heads} (each drafted token needs a head)")


def build_self_prefill(arch: Arch, sc: ServeConfig, spec: SpecConfig):
    """The sampling half of a self-speculative prefill.

    prefill(params, h_last (1, d), generator) ->
        (tok (1,), draft (K,), draft_lp (K,))

    `tok` is the usual first token; `draft` the K head proposals for the
    tokens AFTER it (head h at the last prompt position predicts offset
    h+1), `draft_lp` their head log-probs (zeros when greedy: never
    read)."""
    k = spec.k
    valid = arch.vocab_size
    cap = arch.cfg.logit_softcap
    greedy = sc.temperature == 0.0
    draft_temp = (sc.temperature if spec.draft_temperature is None
                  else spec.draft_temperature)
    sampler = make_sampler(arch, sc)

    def prefill(params, h_last, gen):
        w = params["lm_head"]
        ws = params.get("lm_head_scale")
        tok = sampler(h_last, w, sc.temperature, gen, w_scale=ws)  # (1,)
        hh = apply_mtp_heads(arch, params, h_last)[0, :k]        # (K, d)
        draft = sampler(hh, w, draft_temp, gen, w_scale=ws)      # (K,)
        if greedy:
            d_lp = torch.zeros((k,), dtype=torch.float32, device=hh.device)
        else:
            d_lp = _score_lp(hh, w, draft[:, None], valid=valid, cap=cap,
                             temp=draft_temp, w_scale=ws)[:, 0]
        return tok, draft, d_lp

    return prefill


def build_self_spec_step(arch: Arch, sc: ServeConfig, spec: SpecConfig):
    """The SELF-speculative step: the target drafts for itself through its
    MTP heads — no sidecar model, no second cache tree.

    self_spec_step(params, caches, cur (B, 1), draft (B, K),
                   draft_lp (B, K), generator) ->
        (tokens (B, K+1), counts (B,), caches, new_draft (B, K),
         new_draft_lp (B, K), n_accepted (B,))

    One forward a step: the verify forward over ``[cur, d_1..d_K]`` both
    checks this step's drafts AND yields the hidden state whose heads
    propose the next step's (gathered at each slot's accepted position,
    so head h there predicts offset h+1 after the bonus token).  Greedy
    emissions equal plain decode's; rejection mode accepts draft i with
    probability ``min(1, p_target(d_i) / p_head(d_i))``, the head's
    log-prob recorded when the draft was proposed."""
    _check_self_spec(arch, spec)
    k = spec.k
    valid = arch.vocab_size
    cap = arch.cfg.logit_softcap
    greedy = sc.temperature == 0.0
    draft_temp = (sc.temperature if spec.draft_temperature is None
                  else spec.draft_temperature)
    strat = spec_cache_strategy(arch)
    sampler = make_sampler(arch, sc)

    def self_spec_step(params, caches, cur, draft, draft_lp, gen):
        b = cur.shape[0]
        w = params["lm_head"]
        ws = params.get("lm_head_scale")
        # ---- 1. ONE target forward verifies the pending drafts
        seq = torch.cat([cur, draft], dim=1)                 # (B, K+1)
        h, caches, snaps = verify_forward(arch, params, caches, seq, strat)
        d_model = h.shape[-1]
        choice = sampler(h.reshape(b * (k + 1), d_model), w, sc.temperature,
                         gen, w_scale=ws).reshape(b, k + 1)

        # ---- 2. acceptance
        if greedy:
            acc = draft == choice[:, :k]
        else:
            t_lp = _score_lp(h[:, :k, :].reshape(b * k, d_model), w,
                             draft.reshape(b * k, 1), valid=valid, cap=cap,
                             temp=sc.temperature, w_scale=ws).reshape(b, k)
            u = _uniform((b, k), gen, cur.device)
            acc = torch.log(u) <= (t_lp - draft_lp)         # min(1, pt/ph)
        out, counts, n_acc = _accept(acc, draft, choice)

        # ---- 3. next step's drafts: the heads at the accepted position
        idx = n_acc.long()[:, None, None].expand(b, 1, d_model)
        h_a = torch.gather(h, 1, idx)[:, 0]                  # (B, d)
        hh = apply_mtp_heads(arch, params, h_a)[:, :k].reshape(b * k,
                                                               d_model)
        new_draft = sampler(hh, w, draft_temp, gen,
                            w_scale=ws).reshape(b, k)
        if greedy:
            new_lp = torch.zeros((b, k), dtype=torch.float32, device=h.device)
        else:
            new_lp = _score_lp(hh, w, new_draft.reshape(b * k, 1),
                               valid=valid, cap=cap, temp=draft_temp,
                               w_scale=ws).reshape(b, k)

        # ---- 4. roll back the K - n_acc rejected positions
        caches = _rollback(caches, snaps, n_acc, k)
        return out, counts, caches, new_draft, new_lp, n_acc

    return self_spec_step


class SelfSpecEngine(Engine):
    """Slot engine that speculates with the TARGET model's own MTP heads.

    Against the sidecar `SpecEngine`: no draft model, no second cache
    tree, no draft catch-up forwards; the extra state is the (B, K)
    pending drafts and their log-probs, the extra compute the K head MLPs
    at one gathered position a slot a step.  Prefill seeds a slot's
    drafts from the heads at its last prompt position."""

    spec_mode = "self"
    supports_modes = False    # see SpecEngine: multi-token emission

    def __init__(self, arch: Arch, params, sc: ServeConfig,
                 spec: Optional[SpecConfig] = None, device="cuda"):
        # the default drafts one token per head; an EXPLICIT k above the
        # head count raises (build_self_spec_step)
        self.spec = spec if spec is not None \
            else SpecConfig(k=max(arch.mtp.n_heads, 1))
        super().__init__(arch, params, sc, device=device)
        self._spec_step = build_self_spec_step(arch, sc, self.spec)
        self._prefill_mtp = build_self_prefill(arch, sc, self.spec)
        if sc.autotune:
            self._tune_self_spec_plans()

    @property
    def spec_k(self) -> int:
        return self.spec.k

    def _tune_self_spec_plans(self):
        """Tune the verify and redraft kernels for their exact shapes at
        construction: the top-k over B * (K + 1) choice rows and B * K
        head-draft rows; `score_tokens` over B * K rows in rejection mode
        only."""
        b, kk = self.sc.batch_size, self.spec.k
        _tune_verify(self, (b * (kk + 1), b * kk))

    def reset(self, seed: int = 0):
        # self.spec is set BEFORE Engine.__init__ calls reset
        super().reset(seed)
        shape = (self.sc.batch_size, self.spec.k)
        self._draft = torch.zeros(shape, dtype=torch.int32,
                                  device=self.device)
        self._draft_lp = torch.zeros(shape, dtype=torch.float32,
                                     device=self.device)

    def reset_slot(self, slot: int):
        super().reset_slot(slot)
        self._draft[slot] = 0
        self._draft_lp[slot] = 0.0

    @torch.no_grad()
    def prefill_into_slot(self, slot: int, prompt, frontend_embeds=None
                          ) -> int:
        batch, slot_caches, true_len, ctx = self._slot_prefill_view(
            slot, prompt, frontend_embeds)
        t_b = batch["tokens"].shape[1]
        ext = bool(ctx.get("ext"))
        with self._tracer.span("engine.prefill", cat="engine", slot=slot,
                               tokens=t_b, ext=ext):
            h, slot_caches = self._prefill_forward(batch, slot_caches,
                                                   true_len, ext)
            tok, draft, d_lp = self._prefill_mtp(
                self.params, h[:, true_len - 1, :], self._gen)
            self._commit_slot(slot, slot_caches, ctx)
            self._draft[slot] = draft
            self._draft_lp[slot] = d_lp
            tok = int(tok[0].item())
        self._m_prefills.inc()
        self._m_prefill_tokens.inc(t_b)
        self.cur[slot] = tok
        return tok

    @torch.no_grad()
    def decode_step_multi(self) -> Tuple[np.ndarray, np.ndarray]:
        """One verify -> accept -> redraft -> rollback cycle for every
        slot: (tokens (B, K+1), counts (B,))."""
        with self._tracer.span("spec.step", cat="spec", mode=self.spec_mode,
                               k=self.spec.k):
            cur = torch.from_numpy(self.cur[:, None].copy()).to(self.device)
            (out, counts, self.caches, self._draft, self._draft_lp,
             _) = self._spec_step(self.params, self.caches, cur, self._draft,
                                  self._draft_lp, self._gen)
            out = out.cpu().numpy().astype(np.int32)
            counts = counts.cpu().numpy().astype(np.int32)
        self.cur = out[np.arange(out.shape[0]), counts - 1].copy()
        return out, counts
