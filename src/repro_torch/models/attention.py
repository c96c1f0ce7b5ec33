"""GQA attention: blockwise training attention, slab-cache prefill and
cached decode (port of `repro.models.attention`).

Every attention here is plain PyTorch (none is a Pallas kernel in the
JAX package): scores in f32 through `_tile_scores` — which keeps the GQA
grouping and the optional `attn_softcap` that
`scaled_dot_product_attention` has no place for — then a masked softmax
in f32.

  * `blockwise_attention` (a cache-free forward: training) is the JAX
    package's online-softmax recurrence over (chunk_q x chunk_k) score
    tiles, with its FlashAttention-style backward as a
    `torch.autograd.Function` that recomputes the tiles.
  * `prefill_attention` (serving prefill into a cache) is one tile of
    that recurrence (``p = exp(s - m)``, ``acc = p @ v`` with p in the
    value dtype, ``out = acc / a``): the whole (T, T) score block at
    once, which serving prompts (T <= max_len) afford.
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
import torch.nn.functional as F

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
    causal: bool = True                   # local windows: ROADMAP A8
    chunk_q: int = 512
    chunk_k: int = 1024
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


# ---------------------------------------------------------------------------
# blockwise (training) attention
# ---------------------------------------------------------------------------


def _block_mask(qpos, kpos, kv_len, cfg: AttnConfig):
    mask = kpos[None, :] < kv_len
    if cfg.causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    return mask


def _kv_bounds(qi, cq, ck, nkb, cfg: AttnConfig):
    """KV-block range [lo, hi) visible from query block qi."""
    hi = min(((qi + 1) * cq + ck - 1) // ck, nkb) if cfg.causal else nkb
    return 0, hi


def _q_bounds(kj, cq, ck, nqb, cfg: AttnConfig):
    """Query-block range [lo, hi) that can see kv block kj."""
    lo = (kj * ck) // cq if cfg.causal else 0
    return lo, nqb


def _flash_fwd_impl(q, k, v, cfg: AttnConfig, kv_len: int):
    """Returns (out (B,Tq,nq,hd) f32, lse (B,nkv,g,Tq) f32); T padded to
    whole chunks."""
    b, tq_p, nq, hd = q.shape
    tk_p, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    cq, ck = min(cfg.chunk_q, tq_p), min(cfg.chunk_k, tk_p)
    nqb, nkb = tq_p // cq, tk_p // ck
    q5 = q.reshape(b, nqb, cq, nkv, g, hd)
    dev = q.device
    outs, lses = [], []
    for qi in range(nqb):
        qb = q5[:, qi]                                   # (B,cq,nkv,g,hd)
        qpos = qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, nkv, g, cq), _NEG_INF, device=dev)
        a = torch.zeros((b, nkv, g, cq), device=dev)
        acc = torch.zeros((b, nkv, g, cq, hd), device=dev)
        lo, hi = _kv_bounds(qi, cq, ck, nkb, cfg)
        for kj in range(lo, hi):
            kb = k[:, kj * ck:(kj + 1) * ck]
            vb = v[:, kj * ck:(kj + 1) * ck]
            s = _tile_scores(qb, kb, cfg)                # (B,nkv,g,cq,ck)
            kpos = kj * ck + torch.arange(ck, device=dev)
            s = s.masked_fill(~_block_mask(qpos, kpos, kv_len, cfg),
                              _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            scale_prev = torch.exp(m - m_safe)
            a = a * scale_prev + p.sum(dim=-1)
            pv = torch.einsum("bngqk,bknh->bngqh", p.to(vb.dtype).float(),
                              vb.float())
            acc = acc * scale_prev[..., None] + pv
            m = m_new
        a_safe = torch.clamp_min(a, 1e-30)
        out = acc / a_safe[..., None]
        m_fin = torch.where(torch.isneginf(m), 0.0, m)
        lses.append(m_fin + torch.log(a_safe))           # (B,nkv,g,cq)
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B,cq,nkv,g,hd)
    out = torch.cat(outs, dim=1).reshape(b, tq_p, nq, hd)
    lse = torch.stack(lses, dim=3).reshape(b, nkv, g, tq_p)
    return out, lse


def _flash_bwd_impl(q, k, v, out, lse, dout, cfg: AttnConfig, kv_len: int):
    """FlashAttention-style backward: recompute the score tiles blockwise;
    f32 throughout.  Returns f32 (dq, dk, dv)."""
    b, tq_p, nq, hd = q.shape
    tk_p, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    cq, ck = min(cfg.chunk_q, tq_p), min(cfg.chunk_k, tk_p)
    nqb, nkb = tq_p // cq, tk_p // ck
    scale = 1.0 / math.sqrt(cfg.head_dim)
    dev = q.device

    q5 = q.reshape(b, nqb, cq, nkv, g, hd)
    do5 = dout.reshape(b, nqb, cq, nkv, g, hd)
    dsum = (dout.float() * out.float()).sum(dim=-1)     # D_i, (B, Tq, nq)
    dsum = dsum.reshape(b, nqb, cq, nkv, g)
    lse5 = lse.reshape(b, nkv, g, nqb, cq).movedim(3, 1)

    def q_block(qi):
        dob = do5[:, qi].float().permute(0, 2, 3, 1, 4)  # (B,nkv,g,cq,hd)
        lse_b = lse5[:, qi][..., None]                   # (B,nkv,g,cq,1)
        ds_b = dsum[:, qi].permute(0, 2, 3, 1)[..., None]
        qpos = qi * cq + torch.arange(cq, device=dev)
        return q5[:, qi], dob, lse_b, ds_b, qpos

    def tile(qb, kb, vb, dob, lse_b, ds_b, qpos, kpos):
        """p (softmax tile) and d(score) with the softcap chain factor."""
        s_c = _tile_scores(qb, kb, cfg)
        s_m = s_c.masked_fill(~_block_mask(qpos, kpos, kv_len, cfg),
                              _NEG_INF)
        p = torch.exp(s_m - lse_b)
        dp = torch.einsum("bngqh,bknh->bngqk", dob, vb.float())
        dsc = p * (dp - ds_b)
        if cfg.attn_softcap is not None:
            dsc = dsc * (1.0 - (s_c / cfg.attn_softcap) ** 2)
        return p, dsc

    dq_blocks = []
    for qi in range(nqb):
        qb, dob, lse_b, ds_b, qpos = q_block(qi)
        dq = torch.zeros((b, cq, nkv, g, hd), device=dev)
        lo, hi = _kv_bounds(qi, cq, ck, nkb, cfg)
        for kj in range(lo, hi):
            kb = k[:, kj * ck:(kj + 1) * ck]
            vb = v[:, kj * ck:(kj + 1) * ck]
            kpos = kj * ck + torch.arange(ck, device=dev)
            _, dsc = tile(qb, kb, vb, dob, lse_b, ds_b, qpos, kpos)
            dq = dq + torch.einsum("bngqk,bknh->bqngh", dsc,
                                   kb.float()) * scale
        dq_blocks.append(dq)
    dq = torch.cat(dq_blocks, dim=1).reshape(b, tq_p, nq, hd)

    dk_blocks, dv_blocks = [], []
    for kj in range(nkb):
        kb = k[:, kj * ck:(kj + 1) * ck]
        vb = v[:, kj * ck:(kj + 1) * ck]
        kpos = kj * ck + torch.arange(ck, device=dev)
        dk = torch.zeros((b, ck, nkv, hd), device=dev)
        dv = torch.zeros((b, ck, nkv, hd), device=dev)
        lo, hi = _q_bounds(kj, cq, ck, nqb, cfg)
        for qi in range(lo, hi):
            qb, dob, lse_b, ds_b, qpos = q_block(qi)
            p, dsc = tile(qb, kb, vb, dob, lse_b, ds_b, qpos, kpos)
            dv = dv + torch.einsum("bngqk,bngqh->bknh", p, dob)
            dk = dk + torch.einsum("bngqk,bqngh->bknh", dsc,
                                   qb.float()) * scale
        dk_blocks.append(dk)
        dv_blocks.append(dv)
    return dq, torch.cat(dk_blocks, dim=1), torch.cat(dv_blocks, dim=1)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cfg: AttnConfig, kv_len: int):
        out, lse = _flash_fwd_impl(q, k, v, cfg, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg, ctx.kv_len = cfg, kv_len
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout, ctx.cfg,
                                     ctx.kv_len)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _pad_axis1(x, pad):
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) if pad else x


def blockwise_attention(q, k, v, cfg: AttnConfig, *,
                        kv_len: Optional[int] = None):
    """Online-softmax (FlashAttention-style) attention with its own
    backward: q (B, Tq, nq, hd), k/v (B, Tk, nkv, hd) -> (B, Tq, nq, hd).

    Score tiles exist one (chunk_q x chunk_k) block at a time, forward
    and backward (the backward recomputes them); `kv_len` masks padded
    kv positions (default Tk)."""
    tq, tk = q.shape[1], k.shape[1]
    kv_len = tk if kv_len is None else kv_len
    cq, ck = min(cfg.chunk_q, tq), min(cfg.chunk_k, tk)
    pad_q, pad_k = (-tq) % cq, (-tk) % ck
    out = _Flash.apply(_pad_axis1(q, pad_q), _pad_axis1(k, pad_k),
                       _pad_axis1(v, pad_k), cfg, kv_len)
    return out[:, :tq].to(q.dtype)


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

    cache: None (a cache-free forward, as in training, through
    `blockwise_attention`) or a dense slab {'k', 'v', 'len'}.  With a
    cache, T > 1 is a prefill — the segment is written at ``len`` and
    attends within itself (the cache is empty before a prefill) — and
    T == 1 (or ``decode=True``) appends and attends over the whole
    cache.  The k/v tensors of the cache are
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
        out = blockwise_attention(q, k, v, cfg)
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
