"""Slot-based serving engine: per-slot prefill + batched decode steps.

Port of `repro.serve.engine` (slab caches, plain one-token decode).  Each
row of one live batched cache tree is an independent *slot*:

  * `prefill_into_slot(i, prompt)` runs the model over one prompt at
    batch=1 (padded to a power-of-two bucket), samples the first token,
    and copies the resulting cache into slot `i` of the live tree;
  * `decode_step()` advances EVERY slot one token with one forward and
    one streaming top-k sample — on the card through the hand-written
    `sample_topk` kernel, so the step never forms the (B, V) logits;
  * `reset_slot(i)` restores a finished slot to its pristine state.

The engine runs on ``device`` ("cuda" unless the caller asks for "cpu");
it raises if CUDA is asked for and missing, and never falls back.  Cache
updates are in place.  Free slots still run the batched decode (their
outputs are discarded and their caches overwritten at the next prefill);
their lengths grow past ``max_len`` and every cache write clamps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import Arch
from repro_torch.models.registry import (empty_serve_caches, forward_hidden,
                                         init_serve_caches,
                                         insert_slot_caches,
                                         reset_slot_caches, shift_cache_lens,
                                         take_slot_caches)
from repro_torch.serve.sampler import sample_tokens


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 8            # number of serving slots
    max_len: int = 1024            # per-slot cache capacity (tokens)
    temperature: float = 0.0
    top_k: int = 40
    top_p: Optional[float] = None  # nucleus filter over the top-k logits
    cache_dtype: str = "bfloat16"
    quantize_cache: bool = False   # int8 KV: ROADMAP A6
    head_dtype: Optional[str] = None  # quantized lm_head: ROADMAP A6
    sampler_impl: str = "kernel"   # 'kernel' | 'plain' (CPU tensors only)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if CUDA is asked for and missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _bucket_len(true_len: int, max_len: int) -> int:
    """Smallest power-of-two >= true_len (floor 8, capped at max_len)."""
    b = 8
    while b < true_len:
        b *= 2
    return min(b, max_len)


class Engine:
    """Slot-level serving engine over the model registry (one batched
    cache tree; rows are independently prefilled/recycled slots)."""

    def __init__(self, arch: Arch, params, sc: ServeConfig,
                 device="cuda"):
        if sc.quantize_cache or sc.head_dtype not in (None, "bfloat16",
                                                      "float32"):
            raise NotImplementedError("quantized KV caches and lm_heads "
                                      "come with ROADMAP A6")
        self.arch = arch
        self.params = params
        self.sc = sc
        self.device = resolve_device(device)
        self._cdt = getattr(torch, sc.cache_dtype)
        self._tracer = obs.get_tracer()
        _reg = obs.get_registry()
        self._m_prefills = _reg.counter("engine.prefills_total")
        self._m_prefill_tokens = _reg.counter(
            "engine.prefill_tokens_total",
            "prompt tokens prefilled (bucket pad included)")
        self._m_decode_steps = _reg.counter("engine.decode_steps_total")
        self.reset()

    # -- lifecycle ----------------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self.sc.batch_size

    def reset(self, seed: int = 0):
        """Fresh batched cache container + per-slot pristine template."""
        self.caches = empty_serve_caches(
            self.arch, self.sc.batch_size, self.sc.max_len, dtype=self._cdt,
            device=self.device)
        self._template = take_slot_caches(self.caches, 0)
        self.cur = np.zeros((self.sc.batch_size,), np.int32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    def _sample(self, h2: torch.Tensor) -> torch.Tensor:
        return sample_tokens(h2.contiguous(), self.params["lm_head"],
                             generator=self._gen,
                             temperature=self.sc.temperature,
                             top_k=self.sc.top_k, top_p=self.sc.top_p,
                             valid_vocab=self.arch.vocab_size,
                             logit_softcap=self.arch.cfg.logit_softcap,
                             impl=self.sc.sampler_impl)

    # -- slot operations ----------------------------------------------------

    @torch.no_grad()
    def prefill_into_slot(self, slot: int, prompt) -> int:
        """Prefill one prompt at batch=1 into slot `slot`; returns the
        FIRST sampled token (the time-to-first-token token)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        true_len = prompt.shape[0]
        if not 1 <= true_len <= self.sc.max_len:
            raise ValueError(f"prompt length {true_len} outside "
                             f"[1, {self.sc.max_len}]")
        t_b = _bucket_len(true_len, self.sc.max_len)
        tokens = np.zeros((1, t_b), np.int32)
        tokens[0, :true_len] = prompt
        with self._tracer.span("engine.prefill", cat="engine", slot=slot,
                               tokens=t_b, ext=False):
            slot_caches = init_serve_caches(
                self.arch, 1, self.sc.max_len, dtype=self._cdt,
                device=self.device)
            h, _, slot_caches = forward_hidden(
                self.arch, self.params,
                {"tokens": torch.from_numpy(tokens).to(self.device)},
                caches=slot_caches)
            slot_caches = shift_cache_lens(slot_caches, t_b - true_len)
            tok = self._sample(h[:, true_len - 1, :])
            insert_slot_caches(self.caches, slot_caches, slot)
            tok = int(tok[0].item())
        self._m_prefills.inc()
        self._m_prefill_tokens.inc(t_b)
        self.cur[slot] = tok
        return tok

    @torch.no_grad()
    def decode_step(self) -> np.ndarray:
        """Advance every slot one token; returns (B,) sampled ids.
        Rows of free slots are dead compute — callers ignore them."""
        with self._tracer.span("engine.decode_step", cat="engine",
                               masked=False):
            tokens = torch.from_numpy(self.cur[:, None].copy()).to(
                self.device)
            h, _, self.caches = forward_hidden(self.arch, self.params,
                                               {"tokens": tokens},
                                               caches=self.caches)
            toks = self._sample(h[:, -1, :]).cpu().numpy().astype(np.int32)
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

    # -- request-mode hooks (ROADMAP A4, A5) ----------------------------------

    def set_slot_mask(self, slot: int, allowed) -> None:
        raise NotImplementedError("constrained decoding masks come with "
                                  "ROADMAP A5")

    def decode_topk_step(self, n_cand: int):
        raise NotImplementedError("top-k decode steps (beam / best-of) "
                                  "come with ROADMAP A5")

    def prefill_topk_into_slot(self, slot: int, prompt, n_cand: int):
        raise NotImplementedError("top-k prefills (beam / best-of) come "
                                  "with ROADMAP A5")

    def score_in_slot(self, slot: int, prompt, continuation):
        raise NotImplementedError("loglikelihood eval comes with "
                                  "ROADMAP A4")

    def fork_slot(self, dst: int, src: int) -> None:
        raise NotImplementedError("slot forks (beam / best-of) come with "
                                  "ROADMAP A5")

    # -- fixed-batch convenience -------------------------------------------

    def generate(self, prompts, max_new_tokens: int,
                 eos_id: Optional[int] = None, seed: int = 0) -> np.ndarray:
        """prompts: a sequence of (T_i,) int prompts (or an (R, T) array).
        Returns (R, max_new_tokens) generated ids (post-eos positions
        repeat eos).  Drives a private `ContinuousScheduler`."""
        from repro_torch.serve.scheduler import ContinuousScheduler

        self.reset(seed)
        sched = ContinuousScheduler(self, max_new_tokens=max_new_tokens,
                                    eos_id=eos_id)
        rids = [sched.submit(p) for p in prompts]
        results = sched.run()
        fill = eos_id if eos_id is not None else 0
        out = np.full((len(rids), max_new_tokens), fill, np.int32)
        for i, rid in enumerate(rids):
            toks = results[rid]
            out[i, :len(toks)] = toks
        return out
