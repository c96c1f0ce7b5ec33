"""GQA attention, serving subset: prefill over a fresh segment + cached decode.

The port of `repro.models.attention` for the slab-cache serving path.
Both attentions are plain PyTorch (neither is a Pallas kernel in the JAX
package): scores in f32 through `_tile_scores` — which keeps the GQA
grouping and the optional `attn_softcap` that
`scaled_dot_product_attention` has no place for — then a masked softmax
in f32.

  * `prefill_attention` is one tile of the JAX package's blockwise
    recurrence (``p = exp(s - m)``, ``acc = p @ v`` with p in the value
    dtype, ``out = acc / a``): the whole (T, T) score block at once, which
    serving prompts (T <= max_len) afford.
  * `decode_attention` keeps the softmax-then-matmul order of
    `repro.models.attention.decode_attention`.

Cache writes (`_update_cache`) are IN PLACE on the cache tensors they are
given, and clamp every position into the cache as JAX's
``dynamic_update_slice`` and clipped scatter do: free slots keep decoding
past ``max_len``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.models import layers as L

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    n_layers_scale: int = 1


def init_attention(cfg: AttnConfig, generator: torch.Generator,
                   dtype=torch.float32, device="cpu"):
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    out_scale = 1.0 / math.sqrt(2.0 * max(cfg.n_layers_scale, 1))
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": L.dense_init((d, nq, hd), generator, **kw),
        "wk": L.dense_init((d, nkv, hd), generator, **kw),
        "wv": L.dense_init((d, nkv, hd), generator, **kw),
        "wo": L.dense_init((nq, hd, d), generator, scale=out_scale, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq, hd), **kw)
        p["bk"] = torch.zeros((nkv, hd), **kw)
        p["bv"] = torch.zeros((nkv, hd), **kw)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), **kw)
        p["k_norm"] = torch.ones((hd,), **kw)
    return p


def _project_qkv(params, x, positions, cfg: AttnConfig):
    q = torch.einsum("btd,dnh->btnh", x, params["wq"])
    k = torch.einsum("btd,dnh->btnh", x, params["wk"])
    v = torch.einsum("btd,dnh->btnh", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = L.head_rmsnorm(params["q_norm"], q)
        k = L.head_rmsnorm(params["k_norm"], k)
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def _tile_scores(qb, kb, cfg: AttnConfig):
    """(B, cq, nkv, g, hd) x (B, ck, nkv, hd) -> (B, nkv, g, cq, ck) f32.

    The inputs are widened to f32 first: bf16 products are exact in f32,
    so this is JAX's ``preferred_element_type=f32`` contraction."""
    s = torch.einsum("bqngh,bknh->bngqk", qb.float(), kb.float())
    s = s * (1.0 / math.sqrt(cfg.head_dim))
    if cfg.attn_softcap is not None:
        cap = cfg.attn_softcap
        s = cap * torch.tanh(s / cap)
    return s


def _pv(p, v):
    """(B, nkv, g, Tq, S) probabilities x (B, S, nkv, hd) values ->
    (B, Tq, nkv, g, hd) f32, with p rounded to the value dtype first."""
    return torch.einsum("bngqk,bknh->bqngh", p.to(v.dtype).float(),
                        v.float())


def prefill_attention(q, k, v, cfg: AttnConfig):
    """Causal attention within a fresh segment: q (B, T, nq, hd),
    k/v (B, T, nkv, hd) -> (B, T, nq, hd)."""
    b, t, nq, hd = q.shape
    nkv = k.shape[2]
    q5 = q.reshape(b, t, nkv, nq // nkv, hd)
    s = _tile_scores(q5, k, cfg)                         # (B,nkv,g,T,T)
    pos = torch.arange(t, device=q.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    a = p.sum(dim=-1)                                    # (B,nkv,g,T)
    out = _pv(p, v) / a.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, t, nq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, cfg: AttnConfig):
    """Cached decode: q (B, Tq, nq, hd) vs cache (B, S, nkv, hd).

    `cache_len` (B,) is the length AFTER the Tq new entries were appended:
    query i sits at absolute position ``cache_len - Tq + i`` and attends
    to everything at or before it."""
    b, tq, nq, hd = q.shape
    s_len, nkv = k_cache.shape[1], k_cache.shape[2]
    q5 = q.reshape(b, tq, nkv, nq // nkv, hd)
    s = _tile_scores(q5, k_cache, cfg)                   # (B,nkv,g,Tq,S)
    kpos = torch.arange(s_len, device=q.device)
    qpos = cache_len[:, None] - tq + torch.arange(tq, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]       # (B, Tq, S)
    s = s.masked_fill(~mask[:, None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _pv(p, v_cache).reshape(b, tq, nq, hd).to(q.dtype)


def _update_cache(cache_arr, new_vals, cur_len):
    """Write new_vals (B, t, ...) at each row's position `cur_len` (B,),
    IN PLACE, and return the cache.

    One row writes a contiguous slab whose start is clamped into
    ``[0, S - t]`` (JAX's ``dynamic_update_slice``); several rows scatter
    with every position clipped into ``[0, S - 1]`` (JAX's clipped
    scatter) — only dead rows ever clamp."""
    b, t = new_vals.shape[:2]
    s_len = cache_arr.shape[1]
    steps = torch.arange(t, device=cache_arr.device)
    if b == 1:
        start = cur_len.clamp(0, max(s_len - t, 0))
        idx = (start[:, None] + steps[None, :]).clamp(0, s_len - 1)
    else:
        idx = (cur_len[:, None] + steps[None, :]).clamp(0, s_len - 1)
    rows = torch.arange(b, device=cache_arr.device)[:, None].expand(b, t)
    cache_arr.index_put_((rows, idx), new_vals.to(cache_arr.dtype))
    return cache_arr


def init_cache(batch, max_len, cfg: AttnConfig, dtype=torch.bfloat16,
               device="cpu", quantize: bool = False):
    """Dense slab KV cache {'k', 'v' (B, S, nkv, hd), 'len' (B,)}."""
    if quantize:
        raise NotImplementedError("int8 KV caches come with ROADMAP A6")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def attention_layer(
    params, x, cfg: AttnConfig, *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention layer: returns (out, new_cache).

    cache: None (a cache-free forward: attention within the segment) or a
    dense slab {'k', 'v', 'len'}.  With a cache, T > 1 is a prefill — the
    segment is written at ``len`` and attends within itself (the cache is
    empty before a prefill) — and T == 1 (or ``decode=True``) appends and
    attends over the whole cache.  The k/v tensors of the cache are
    updated in place; the returned cache carries the new ``len``.
    """
    b, t, _ = x.shape
    if positions is None:
        if cache is not None:
            positions = cache["len"][:, None] + torch.arange(
                t, device=x.device)[None, :]
        else:
            positions = torch.arange(t, device=x.device)[None, :].expand(
                b, t)
    q, k, v = _project_qkv(params, x, positions, cfg)
    new_cache = None
    if cache is None:
        out = prefill_attention(q, k, v, cfg)
    elif "table" in cache:
        raise NotImplementedError("paged KV attention comes with ROADMAP A3")
    elif "pos" in cache:
        raise NotImplementedError("ring-buffer local attention comes with "
                                  "ROADMAP A8")
    elif "k_scale" in cache:
        raise NotImplementedError("int8 KV caches come with ROADMAP A6")
    else:
        k_cache = _update_cache(cache["k"], k, cache["len"])
        v_cache = _update_cache(cache["v"], v, cache["len"])
        new_len = cache["len"] + t
        new_cache = {"k": k_cache, "v": v_cache, "len": new_len}
        if decode or t == 1:
            out = decode_attention(q, k_cache, v_cache, new_len, cfg)
        else:
            out = prefill_attention(q, k, v, cfg)
    y = torch.einsum("btnh,nhd->btd", out.to(x.dtype), params["wo"])
    return y, new_cache
