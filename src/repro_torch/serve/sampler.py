"""Streaming samplers: next-token selection WITHOUT materializing logits.

Port of `repro.serve.sampler`.  Two implementations share one contract
(values f32 sorted descending, global ids, ties to the lowest id):

  * `streaming_topk` — plain PyTorch: scans the lm_head in vocab chunks,
    keeping a running (values, ids) top-k merged by a stable sort.
  * `repro_torch.kernels.sample_topk.cuda_topk` — the hand-written Hopper
    kernel; on CPU tensors it runs its own plain version.

`sample_tokens` draws greedy (temperature == 0) or temperature/top-k/
top-p samples from the surviving k logits.  Its ``impl`` chooses between
the two only for CPU tensors: CUDA tensors always go to the kernel.
Random draws take an explicit `torch.Generator`; they do not reproduce
``jax.random`` bits, so parity with the JAX package is greedy-exact and
sampling is held to its support (top-k, top-p) instead.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = float("-inf")


def _stable_topk(z: torch.Tensor, k: int):
    """(values, positions) of the k largest per row, ties to the lowest
    position (``torch.topk`` promises no order among ties)."""
    vals, order = torch.sort(z, dim=-1, descending=True, stable=True)
    return vals[:, :k], order[:, :k]


def streaming_topk(
    h: torch.Tensor, w: torch.Tensor, k: int, *,
    block_v: int = 8192, valid_vocab: Optional[int] = None,
    logit_softcap: Optional[float] = None,
):
    """Top-k of h @ w.T per row, streamed over vocab chunks.

    h: (B, d); w: (V, d).  Returns (values (B, k) f32, ids (B, k) i32).
    The request-mode options of the JAX version (``w_scale``,
    ``allowed_mask``, ``return_lse``) live in the plain reference
    `topk_scores_ref` until their slices (ROADMAP A5, A6)."""
    b = h.shape[0]
    v = w.shape[0]
    valid = v if valid_vocab is None else valid_vocab
    bv = min(block_v, v)
    h32 = h.float()
    best_v = torch.full((b, k), _NEG_INF, dtype=torch.float32,
                        device=h.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=h.device)
    for lo in range(0, v, bv):
        hi = min(lo + bv, v)
        z = h32 @ w[lo:hi].float().T                        # (B, chunk)
        if logit_softcap is not None:
            z = logit_softcap * torch.tanh(z / logit_softcap)
        col = torch.arange(lo, hi, device=h.device)
        z = torch.where((col < valid)[None, :], z, _NEG_INF)
        cv, ci = _stable_topk(z, min(k, hi - lo))
        # carried state holds lower ids than this chunk and comes first,
        # so the stable merge keeps lowest-id-first among equal values
        mv, sel = _stable_topk(torch.cat([best_v, cv], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, col[ci]], dim=1), 1, sel)
        best_v = mv
    return best_v, best_i.to(torch.int32)


def top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter over DESCENDING-sorted logits: keep the smallest
    prefix whose probability mass reaches `top_p`, -inf the rest.  The
    top-1 token is always kept, and ``top_p >= 1`` is the identity."""
    if top_p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    return torch.where(keep, logits, _NEG_INF)


def sample_tokens(
    h: torch.Tensor, w: torch.Tensor, *,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0, top_k: int = 40,
    top_p: Optional[float] = None,
    block_v: int = 8192, valid_vocab: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """Next-token ids (B,) int32 — greedy when temperature == 0.

    impl: 'kernel' (`cuda_topk`: the Hopper kernel on CUDA tensors, its
    plain version on CPU ones) or 'plain' (`streaming_topk`, CPU tensors
    only).  `generator` drives the categorical draw at temperature > 0."""
    k = 1 if temperature == 0.0 else top_k
    if impl == "kernel":
        from repro_torch.kernels.sample_topk import cuda_topk
        vals, idxs = cuda_topk(h, w, k, valid_vocab=valid_vocab,
                               logit_softcap=logit_softcap)
    elif impl == "plain":
        if h.device.type != "cpu":
            raise ValueError("the plain sampler serves CPU tensors only; "
                             "CUDA tensors go to the kernel "
                             "(impl='kernel')")
        vals, idxs = streaming_topk(h, w, k, block_v=block_v,
                                    valid_vocab=valid_vocab,
                                    logit_softcap=logit_softcap)
    else:
        raise ValueError(f"unknown sampler impl {impl!r}")
    if temperature == 0.0:
        return idxs[:, 0]
    logits = vals / temperature
    if top_p is not None:
        logits = top_p_mask(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)   # (B, 1)
    return torch.gather(idxs, 1, choice)[:, 0]
