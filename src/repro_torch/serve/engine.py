"""Slot-based serving engine: per-slot prefill + batched decode steps.

Port of `repro.serve.engine` (slab caches, plain one-token decode).  Each
row of one live batched cache tree is an independent *slot*:

  * `prefill_into_slot(i, prompt)` runs the model over one prompt at
    batch=1 (padded to a power-of-two bucket), samples the first token,
    and copies the resulting cache into slot `i` of the live tree —
    through the hooks `_slot_prefill_view` (the inputs and the slot's
    cache view) and `_commit_slot` (publish it), which the paged engine
    overrides (`serve/paged.py`);
  * `decode_step()` advances EVERY slot one token with one forward and
    one streaming top-k sample — on the card through the hand-written
    `sample_topk` kernel, so the step never forms the (B, V) logits;
  * `reset_slot(i)` restores a finished slot to its pristine state.

An arch with a frontend stub (``cfg.frontend_len``, internvl2) takes each
request's precomputed ``frontend_embeds`` (1, F, d) ahead of its prompt
in the prefill: the slot's cache then holds F + prompt entries, and the
first token is read at the prompt's last position.  Every prefill path
(`prefill_into_slot`, `prefill_topk_into_slot`, `score_in_slot`,
`generate`) takes them; an arch without a frontend ignores them.

Enc-dec (seamless-m4t-medium): ``frontend_embeds`` (1, enc_len, d) are a
request's encoder frames, ``ServeConfig.enc_len`` of them (a request
with another count raises `ValueError`: the batched container holds
``enc_len`` frames a slot, and a shorter request would attend over its
zero rows in decode).  Every prefill runs the encoder over the request's
frames, or over zeros when it brings none, and the slot's tree takes
that run's cross K/V beside the decoder's self-attention cache.

Quantized serving (``ServeConfig.quantize_cache``, ``head_dtype``): an
int8 KV cache with per-(token, head) scales, and a 1-byte lm_head, made
once at init by `kernels.quant.quantize_weight` (``params['lm_head']``
becomes the int8 / fp8 copy and ``params['lm_head_scale']`` its (V,) f32
scales); every vocab scan then streams the 1-byte head with its scales
(`sample_topk`, `score_tokens`: ``w_scale``).

``ServeConfig.autotune`` tunes the launch plans of the engine's vocab
scans at construction (`_tune_plans`: the sampling top-k at rows 1 and
the batch, k 1 at temperature 0 and ``top_k`` above it, keyed by the
head's dtype; the paged and speculative engines add their kernels'
shapes) into the tuning cache, ``$REPRO_TUNING_CACHE`` or
``~/.cache/repro/blockplans.json``, at most ``tune_trial_budget`` plans
a key.  Every launch resolves its plan from that cache once a process,
with or without ``autotune``; a key no run has tuned keeps the
kernel's own plan.

The engine runs on ``device`` ("cuda" unless the caller asks for "cpu");
it raises if CUDA is asked for and missing, and never falls back.  Cache
updates are in place.  Free slots still run the batched decode (their
outputs are discarded and their caches overwritten at the next prefill);
their lengths grow past ``max_len`` and every cache write clamps.

The request modes (`serve/modes.py`) run on four more primitives, the
bodies of the JAX package's jitted `ModeFns` closures as plain methods:

  * `score_in_slot`, the loglikelihood-eval primitive: one batch=1
    prefill over prompt + continuation whose hidden states at the
    continuation's positions go through the `score_tokens` kernel;
  * `decode_topk_step` / `prefill_topk_into_slot`, a step or a prefill
    that returns each row's top-k candidates and its lse from ONE
    `sample_topk` launch (``return_lse``) instead of a token, for beam
    and best-of groups; `fork_slot` copies a slot's cache row;
  * `set_slot_mask`, a per-slot allowed-token set that every prefill and
    decode of that slot streams through `sample_topk` as its
    ``allowed_mask`` (constrained decoding).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ENCDEC_SERVE_ENC_LEN, Arch
from repro_torch.kernels.quant import head_quant_dtype, quantize_weight
from repro_torch.models.registry import (empty_serve_caches, forward_hidden,
                                         init_serve_caches,
                                         insert_slot_caches,
                                         reset_slot_caches, shift_cache_lens,
                                         take_slot_caches)
from repro_torch.serve.sampler import sample_tokens

_NO_ID = -1                    # pad id of an eval continuation: scores -inf


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 8            # number of serving slots
    max_len: int = 1024            # per-slot cache capacity (tokens)
    temperature: float = 0.0
    top_k: int = 40
    top_p: Optional[float] = None  # nucleus filter over the top-k logits
    cache_dtype: str = "bfloat16"
    quantize_cache: bool = False   # int8 KV (transformer family only)
    head_dtype: Optional[str] = None  # quantized lm_head serving dtype
    #   ("int8" | "float8_e4m3fn" | "float8_e5m2"; None/"bfloat16"/
    #   "float32" serve the full-precision head) - kernels/quant.py
    sampler_impl: str = "kernel"   # 'kernel' | 'plain' (CPU tensors only)
    autotune: bool = False         # tune the decode top-k plans at init
    tune_trial_budget: int = 6
    # paged KV cache (serve/paged.PagedEngine)
    paged: bool = False            # block-pool KV instead of dense slabs
    block_size: int = 16           # tokens per pool block
    pool_blocks: int = 0           # total pool blocks (0: slab parity)
    paged_impl: str = "kernel"     # 'kernel' | 'plain' (CPU tensors only)
    prefix_cache: bool = True      # shared-prefix block reuse (trie)
    enc_len: int = ENCDEC_SERVE_ENC_LEN  # enc-dec encoder frames a request


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if CUDA is asked for and missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def make_sampler(arch: Arch, sc: ServeConfig):
    """Streaming-sampler closure over the arch's softcap and the serve
    knobs: ``sample(h2, w, temperature, generator[, allowed_mask,
    w_scale]) -> (N,) int32``.  The temperature stays a call-site
    argument: the speculative engines draw drafts at the draft
    temperature and verify picks at the target's through the same
    closure.  `w_scale` marks w as a quantized head."""
    def sample(h2, w, temperature, generator, allowed_mask=None,
               w_scale=None):
        return sample_tokens(h2.contiguous(), w, generator=generator,
                             temperature=temperature, top_k=sc.top_k,
                             top_p=sc.top_p, valid_vocab=arch.vocab_size,
                             logit_softcap=arch.cfg.logit_softcap,
                             impl=sc.sampler_impl,
                             allowed_mask=allowed_mask, w_scale=w_scale)

    return sample


def _bucket_len(true_len: int, max_len: int) -> int:
    """Smallest power-of-two >= true_len (floor 8, capped at max_len)."""
    b = 8
    while b < true_len:
        b *= 2
    return min(b, max_len)


class Engine:
    """Slot-level serving engine over the model registry (one batched
    cache tree; rows are independently prefilled/recycled slots)."""

    # the request modes (eval scoring, beam / best-of groups, constrained
    # masks) need the one-token decode; the speculative engines say no
    supports_modes = True

    def __init__(self, arch: Arch, params, sc: ServeConfig,
                 device="cuda"):
        if sc.quantize_cache and arch.family != "transformer":
            # never fall back to bf16 quietly: the caller asked for the
            # halved-footprint cache and would get full-size slabs
            raise NotImplementedError(
                "quantize_cache is only implemented for the transformer "
                f"KV cache; arch family '{arch.family}' would silently "
                "serve full-precision state — set quantize_cache=False")
        self.arch = arch
        self.params = params
        self.sc = sc
        self._quant = sc.quantize_cache
        # quantized lm_head: the serving params' head becomes the 1-byte
        # copy and its per-row scales, once; every vocab scan reads
        # params["lm_head"] / params["lm_head_scale"]
        self._head_dtype = head_quant_dtype(sc.head_dtype)
        if self._head_dtype is not None:
            wq, ws = quantize_weight(params["lm_head"], self._head_dtype)
            self.params = dict(params, lm_head=wq.contiguous(),
                               lm_head_scale=ws.contiguous())
        self.device = resolve_device(device)
        self._cdt = getattr(torch, sc.cache_dtype)
        # bucket pads must never WRAP a griffin ring buffer (a wrapped pad
        # write destroys an in-window real entry): longer prompts prefill
        # at their exact length
        self._bucket_cap = sc.max_len
        if arch.family == "griffin":
            self._bucket_cap = min(sc.max_len, arch.cfg.window)
        self._sampler = make_sampler(arch, sc)
        self._tracer = obs.get_tracer()
        _reg = obs.get_registry()
        self._m_prefills = _reg.counter("engine.prefills_total")
        self._m_prefill_tokens = _reg.counter(
            "engine.prefill_tokens_total",
            "prompt tokens prefilled (bucket pad included)")
        self._m_decode_steps = _reg.counter("engine.decode_steps_total")
        # constrained decoding: each masked slot's (vocab_size,) int8
        # allowed set
        self._slot_masks: Dict[int, np.ndarray] = {}
        if sc.autotune:
            self._tune_plans()
        self.reset()

    # -- autotune -----------------------------------------------------------

    def _tune_args(self):
        """(V, d, the hidden states' dtype, the quantized head's dtype)
        that key this engine's vocab-scan plans."""
        v, d = self.params["lm_head"].shape
        dtype = getattr(torch, getattr(self.arch.cfg, "compute_dtype",
                                       "float32"))
        return v, d, dtype, self._head_dtype

    def _sample_k(self) -> int:
        return 1 if self.sc.temperature == 0.0 else self.sc.top_k

    def _tune_plans(self):
        """Tune the sampling top-k's plans for the decode and prefill
        shapes (rows 1 and the batch) at construction, before the first
        step: each key's first engine sweeps, later ones hit the cache.
        The trials are real launches (they count on `sample_topk`)."""
        from repro_torch.kernels.sample_topk.autotune import \
            autotune_topk_plan
        v, d, dtype, wdtype = self._tune_args()
        for n in sorted({1, self.sc.batch_size}):
            autotune_topk_plan(n, v, d, self._sample_k(), dtype,
                               device=self.device,
                               trial_budget=self.sc.tune_trial_budget,
                               logit_softcap=self.arch.cfg.logit_softcap,
                               wdtype=wdtype)

    # -- lifecycle ----------------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self.sc.batch_size

    def _empty_caches(self):
        return empty_serve_caches(
            self.arch, self.sc.batch_size, self.sc.max_len, dtype=self._cdt,
            device=self.device, quantize=self._quant,
            enc_len=self.sc.enc_len)

    def head_bytes(self) -> int:
        """Bytes of the served lm_head (and its scales, when quantized):
        what every vocab scan streams."""
        return sum(self.params[k].numel() * self.params[k].element_size()
                   for k in ("lm_head", "lm_head_scale") if k in self.params)

    def reset(self, seed: int = 0):
        """Fresh batched cache container + per-slot pristine template."""
        self.caches = self._empty_caches()
        self._template = take_slot_caches(self.caches, 0)
        self.cur = np.zeros((self.sc.batch_size,), np.int32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._slot_masks.clear()

    def _sample(self, h2: torch.Tensor,
                allowed_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._sampler(h2, self.params["lm_head"],
                             self.sc.temperature, self._gen, allowed_mask,
                             w_scale=self.params.get("lm_head_scale"))

    # -- slot operations ----------------------------------------------------

    def _bucket_for(self, true_len: int, cap: Optional[int] = None) -> int:
        """Padded prefill length of a `true_len`-token segment: its
        power-of-two bucket when that fits under `cap` (default: the
        family's bucket cap, `max_len` or griffin's window), else the
        exact length."""
        cap = self._bucket_cap if cap is None else min(cap,
                                                       self._bucket_cap)
        t_b = _bucket_len(true_len, self.sc.max_len)
        return t_b if t_b <= cap else true_len

    def _prefill_inputs(self, prompt, frontend_embeds=None,
                        pad_cap: Optional[int] = None,
                        pad_to: Optional[int] = None):
        """(batch, true_len) of one batch=1 prefill: validation and
        bucketing.  ``batch['tokens']`` (1, T_pad) is on the device, and
        so is ``batch['frontend_embeds']`` when the arch has a frontend
        and the request brings them.  `pad_cap` bounds the padded
        length; `pad_to` forces it (the paged engine pads a prefix hit's
        suffix so that shared + padded is the cold prefill's bucket)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        true_len = prompt.shape[0]
        if not 1 <= true_len <= self.sc.max_len:
            raise ValueError(f"prompt length {true_len} outside "
                             f"[1, {self.sc.max_len}]")
        if pad_to is not None:
            if pad_to < true_len:
                raise ValueError(f"pad_to={pad_to} < prompt {true_len}")
            t_b = pad_to
        else:
            t_b = self._bucket_for(true_len, pad_cap)
        tokens = np.zeros((1, t_b), np.int32)
        tokens[0, :true_len] = prompt
        batch = {"tokens": torch.from_numpy(tokens).to(self.device)}
        if getattr(self.arch.cfg, "frontend_len", 0) and \
                frontend_embeds is not None:
            batch["frontend_embeds"] = torch.as_tensor(
                frontend_embeds).to(self.device)
        return batch, true_len

    def _encoder_frames(self, frontend_embeds) -> torch.Tensor:
        """An enc-dec request's encoder input (1, enc_len, d) on the
        device: its frames, or zeros in the compute dtype when it brings
        none (the reference's unconditioned fallback)."""
        cfg, n = self.arch.cfg, self.sc.enc_len
        if frontend_embeds is None:
            return torch.zeros((1, n, cfg.d_model), device=self.device,
                               dtype=getattr(torch, cfg.compute_dtype))
        fe = torch.as_tensor(frontend_embeds).to(self.device)
        if tuple(fe.shape) != (1, n, cfg.d_model):
            raise ValueError(
                f"enc-dec request frames of shape {tuple(fe.shape)}: the "
                f"engine serves (1, enc_len={n}, {cfg.d_model}); set "
                "ServeConfig.enc_len to the frame count")
        return fe

    def _fresh_slot_caches(self, frontend_embeds):
        """A batch=1 cache tree for one prefill: empty, with enc-dec's
        cross K/V from the encoder over the request's frames."""
        kw = {}
        if self.arch.family == "encdec":
            kw = dict(params=self.params,
                      frontend_embeds=self._encoder_frames(frontend_embeds))
        return init_serve_caches(self.arch, 1, self.sc.max_len,
                                 dtype=self._cdt, device=self.device,
                                 quantize=self._quant, **kw)

    def _slot_prefill_view(self, slot: int, prompt, frontend_embeds=None,
                           match_len: Optional[int] = None):
        """(batch, slot_caches, true_len, ctx) of one slot prefill: a
        fresh batch=1 slab here.  `ctx` is threaded to `_commit_slot`;
        its ``'ext'`` key selects the cache-extension prefill (the paged
        engine's prefix hits).  `match_len` caps the paged prefix match;
        the slab engine has no prefix reuse and ignores it."""
        del slot, match_len
        batch, true_len = self._prefill_inputs(prompt, frontend_embeds)
        slot_caches = self._fresh_slot_caches(frontend_embeds)
        return batch, slot_caches, true_len, {"ext": False}

    def _commit_slot(self, slot: int, slot_caches, ctx):
        """Publish a finished prefill's slot tree into the live batch."""
        del ctx
        insert_slot_caches(self.caches, slot_caches, slot)

    def _prefill_forward(self, batch, slot_caches, true_len: int,
                         ext: bool):
        """The forward of one batch=1 prefill and the shift of the caches'
        length back by the bucket pad: (h (1, T_pad, d) at the token
        positions, the frontend's left out, caches).  ``ext`` makes it a
        cache extension (a paged prefix hit's suffix-only prefill).
        `true_len` also gates a recurrent family's pad steps into no-ops
        (griffin's and xlstm's state consumes every position)."""
        h, _, slot_caches = forward_hidden(
            self.arch, self.params, batch, caches=slot_caches, decode=ext,
            prefill_ext=ext, true_len=true_len)
        t_b = batch["tokens"].shape[1]
        return (h[:, h.shape[1] - t_b:],
                shift_cache_lens(slot_caches, t_b - true_len))

    @torch.no_grad()
    def prefill_into_slot(self, slot: int, prompt, frontend_embeds=None
                          ) -> int:
        """Prefill one prompt at batch=1 into slot `slot` (after its
        `frontend_embeds`, for an arch with a frontend); returns the
        FIRST sampled token (the time-to-first-token token)."""
        batch, slot_caches, true_len, ctx = self._slot_prefill_view(
            slot, prompt, frontend_embeds)
        t_b = batch["tokens"].shape[1]
        ext = bool(ctx.get("ext"))
        mask = None
        if slot in self._slot_masks:
            mask = torch.from_numpy(self._mask_row(slot)[None, :]).to(
                self.device)
        with self._tracer.span("engine.prefill", cat="engine", slot=slot,
                               tokens=t_b, ext=ext):
            h, slot_caches = self._prefill_forward(batch, slot_caches,
                                                   true_len, ext)
            tok = self._sample(h[:, true_len - 1, :], mask)
            self._commit_slot(slot, slot_caches, ctx)
            tok = int(tok[0].item())
        self._m_prefills.inc()
        self._m_prefill_tokens.inc(t_b)
        self.cur[slot] = tok
        return tok

    def _decode_forward(self) -> torch.Tensor:
        """The batched one-token forward of a decode step over `cur`:
        h (B, d) of the new positions."""
        tokens = torch.from_numpy(self.cur[:, None].copy()).to(self.device)
        h, _, self.caches = forward_hidden(self.arch, self.params,
                                           {"tokens": tokens},
                                           caches=self.caches)
        return h[:, -1, :]

    @torch.no_grad()
    def decode_step(self) -> np.ndarray:
        """Advance every slot one token; returns (B,) sampled ids.
        Rows of free slots are dead compute — callers ignore them.  When
        any slot carries a constrained-decoding mask the whole batch
        samples under the (B, V) mask matrix (unconstrained rows stream
        all ones: the same tokens as no mask)."""
        masked = bool(self._slot_masks)
        with self._tracer.span("engine.decode_step", cat="engine",
                               masked=masked):
            h2 = self._decode_forward()
            mask = self._mask_matrix() if masked else None
            toks = self._sample(h2, mask).cpu().numpy().astype(np.int32)
        self._m_decode_steps.inc()
        self.cur = toks.copy()
        return toks

    def decode_step_multi(self):
        """Variable-emission step contract shared with the speculative
        engines: (tokens (B, T), counts (B,)); the plain engine always
        emits exactly one token per slot."""
        toks = self.decode_step()
        return toks[:, None], np.ones_like(toks)

    def reset_slot(self, slot: int):
        """Recycle a finished slot back to its pristine empty state."""
        reset_slot_caches(self.caches, self._template, slot)
        self.cur[slot] = 0
        self._slot_masks.pop(slot, None)

    # -- request modes (serve/modes.py) --------------------------------------

    def set_slot_mask(self, slot: int, allowed) -> None:
        """Constrain slot `slot` to an allowed-token set (None clears).

        `allowed` is a (vocab_size,) BOOL mask or an integer id list;
        disallowed tokens score -inf inside the sampling kernel's vocab
        scan (`sample_topk` ``allowed_mask``), so they are never drawn at
        any temperature or top-p.  The set must not be empty."""
        if not self.supports_modes:
            raise NotImplementedError(
                f"{type(self).__name__} does not support per-slot token "
                "masks (speculative drafting would need masked "
                "verification): serve constrained requests on a "
                "non-speculative engine")
        if allowed is None:
            self._slot_masks.pop(slot, None)
            return
        v = self.arch.vocab_size
        a = np.asarray(allowed)
        if a.dtype == np.bool_:
            if a.shape != (v,):
                raise ValueError(f"bool mask shape {a.shape} != ({v},)")
            mask = a.astype(np.int8)
        else:
            from repro_torch.serve.modes import allowed_ids_mask
            mask = allowed_ids_mask(a, v).astype(np.int8)
        if not mask.any():
            raise ValueError("empty allowed-token set")
        self._slot_masks[slot] = mask

    def _mask_row(self, slot: int) -> np.ndarray:
        """The slot's mask padded to the lm_head's (possibly padded) vocab
        width: pad columns stay 1, the kernel's validity clamp already
        removes them."""
        row = np.ones((self.params["lm_head"].shape[0],), np.int8)
        row[:self.arch.vocab_size] = self._slot_masks[slot]
        return row

    def _mask_matrix(self) -> torch.Tensor:
        """(B, V_head) int8 batch mask on the device: all-ones rows (the
        same tokens as no mask) except the slots with a constraint."""
        m = np.ones((self.sc.batch_size, self.params["lm_head"].shape[0]),
                    np.int8)
        for s in self._slot_masks:
            m[s] = self._mask_row(s)
        return torch.from_numpy(m).to(self.device)

    def _topk_lse(self, h2: torch.Tensor, k: int):
        """(vals (N, k), ids (N, k), lse (N,)) of one logits-free vocab
        scan: `sample_topk` with ``return_lse`` (its plain version on CPU
        tensors)."""
        from repro_torch.kernels.sample_topk import cuda_topk
        return cuda_topk(h2.contiguous(), self.params["lm_head"], k,
                         valid_vocab=self.arch.vocab_size,
                         logit_softcap=self.arch.cfg.logit_softcap,
                         w_scale=self.params.get("lm_head_scale"),
                         return_lse=True)

    @torch.no_grad()
    def decode_topk_step(self, n_cand: int):
        """Advance every slot one step, returning the top-`n_cand`
        candidate scores instead of sampling: (vals (B, k) f32, idxs
        (B, k) i32, lse (B,) f32), numpy; ``vals - lse[:, None]`` are the
        candidates' log-probabilities, from ONE vocab scan.  Does NOT
        update `self.cur`: the caller (a beam or best-of group) picks each
        slot's next token."""
        with self._tracer.span("engine.decode_step", cat="engine",
                               topk=n_cand):
            vals, idxs, lse = self._topk_lse(self._decode_forward(), n_cand)
            vals = vals.cpu().numpy().astype(np.float32)
            idxs = idxs.cpu().numpy().astype(np.int32)
            lse = lse.cpu().numpy().astype(np.float32)
        self._m_decode_steps.inc()
        return vals, idxs, lse

    @torch.no_grad()
    def prefill_topk_into_slot(self, slot: int, prompt, n_cand: int,
                               frontend_embeds=None):
        """Prefill one prompt into `slot`, returning the first step's
        top-`n_cand` candidates (vals (k,), idxs (k,), lse float) instead
        of a sampled token: the admit half of a beam or best-of group.
        Does NOT set ``self.cur[slot]``; the group does."""
        batch, slot_caches, true_len, ctx = self._slot_prefill_view(
            slot, prompt, frontend_embeds)
        t_b = batch["tokens"].shape[1]
        ext = bool(ctx.get("ext"))
        with self._tracer.span("engine.prefill", cat="engine", slot=slot,
                               tokens=t_b, ext=ext, topk=n_cand):
            h, slot_caches = self._prefill_forward(batch, slot_caches,
                                                   true_len, ext)
            vals, idxs, lse = self._topk_lse(h[:, true_len - 1, :], n_cand)
            self._commit_slot(slot, slot_caches, ctx)
            vals = vals.cpu().numpy().astype(np.float32)[0]
            idxs = idxs.cpu().numpy().astype(np.int32)[0]
            lse = float(lse.cpu().numpy()[0])
        self._m_prefills.inc()
        self._m_prefill_tokens.inc(t_b)
        return vals, idxs, lse

    def _eval_logp(self, hs: torch.Tensor, ids: torch.Tensor):
        """(N,) ``log p(ids | hs)`` under the full-vocab softmax through
        `score_tokens` (the kernel on CUDA tensors, its plain version on
        CPU ones)."""
        from repro_torch.kernels.score_tokens import score_tokens
        logp, _ = score_tokens(hs, self.params["lm_head"], ids,
                               valid_vocab=self.arch.vocab_size,
                               logit_softcap=self.arch.cfg.logit_softcap,
                               w_scale=self.params.get("lm_head_scale"))
        return logp

    @torch.no_grad()
    def score_in_slot(self, slot: int, prompt, continuation,
                      frontend_embeds=None) -> np.ndarray:
        """Per-token ``log p(continuation | prompt)`` (len(cont),) f32 in
        ONE batch=1 forward over prompt + continuation through slot
        `slot`.  The hidden state before each continuation token goes
        through `score_tokens` (candidate logit and lse a row, never a
        logits row).  On paged engines the prompt replays through the
        prefix trie (``match_len`` caps the match at the prompt, so every
        scored position lies in the suffix forward).  The slot's cache is
        left holding prompt + continuation; the caller resets it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cont = np.asarray(continuation, np.int32).reshape(-1)
        if cont.size == 0:
            return np.zeros((0,), np.float32)
        seq = np.concatenate([prompt, cont])
        batch, slot_caches, true_len, ctx = self._slot_prefill_view(
            slot, seq, frontend_embeds, match_len=len(prompt))
        t_b = batch["tokens"].shape[1]
        p_pad = max(8, _bucket_len(len(cont), 1 << 30))
        ids = np.full((p_pad,), _NO_ID, np.int32)
        ids[:len(cont)] = cont
        # the hidden state BEFORE continuation token i, clipped into the
        # bucket (pad rows score -1: -inf, sliced off below)
        pos = np.clip(true_len - len(cont) - 1 + np.arange(p_pad), 0,
                      t_b - 1)
        ext = bool(ctx.get("ext"))
        with self._tracer.span("engine.prefill", cat="engine", slot=slot,
                               tokens=t_b, ext=ext, mode="eval"):
            h, slot_caches = self._prefill_forward(batch, slot_caches,
                                                   true_len, ext)
            hs = h[0, torch.from_numpy(pos).to(self.device)]   # (p_pad, d)
            logp = self._eval_logp(hs, torch.from_numpy(ids).to(
                self.device))
            self._commit_slot(slot, slot_caches, ctx)
            logp = logp.cpu().numpy().astype(np.float32)
        self._m_prefills.inc()
        self._m_prefill_tokens.inc(t_b)
        return logp[:len(cont)]

    def fork_slot(self, dst: int, src: int) -> None:
        """Duplicate slot `src`'s decode state into free slot `dst` (beam
        and best-of forks): the slab engine copies the cache row;
        `PagedEngine` overrides this with a `BlockPool.fork` refcount bump
        of the chain (serve/paged.py)."""
        insert_slot_caches(self.caches, take_slot_caches(self.caches, src),
                           dst)
        self.cur[dst] = self.cur[src]

    # -- fixed-batch convenience -------------------------------------------

    def generate(self, prompts, max_new_tokens: int,
                 eos_id: Optional[int] = None, seed: int = 0,
                 frontend_embeds=None) -> np.ndarray:
        """prompts: a sequence of (T_i,) int prompts (or an (R, T) array).
        Returns (R, max_new_tokens) generated ids (post-eos positions
        repeat eos).  `frontend_embeds` (batch=1) go ahead of every
        prompt.  Drives a private `ContinuousScheduler`."""
        from repro_torch.serve.scheduler import ContinuousScheduler

        self.reset(seed)
        sched = ContinuousScheduler(self, max_new_tokens=max_new_tokens,
                                    eos_id=eos_id)
        rids = [sched.submit(p, frontend_embeds=frontend_embeds)
                for p in prompts]
        results = sched.run()
        fill = eos_id if eos_id is not None else 0
        out = np.full((len(rids), max_new_tokens), fill, np.int32)
        for i, rid in enumerate(rids):
            toks = results[rid]
            out[i, :len(toks)] = toks
        return out
