"""GQA attention: blockwise training attention, slab-cache prefill,
cached decode and paged decode (port of `repro.models.attention`).

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
  * `extend_attention` (a paged prefix hit's suffix prefill over the
    cached prefix) replays `prefill_attention`'s arithmetic, so a hit's
    rows match a cold prefill's.
  * a local window (``AttnConfig.window``, griffin) masks keys `window`
    or more positions back in every mask above, and the blockwise tile
    bounds skip the blocks wholly outside it; its cache is a ring buffer
    of `window` entries addressed by absolute position (`_ring_update`,
    `_ring_decode`).

int8 caches (``quantize=True``): `quantize_kv` gives each (token, KV
head) an f32 scale and int8 values; the slab decodes through
`_decode_quantized` (one chunk of the cache dequantized at a time, K
back to q's dtype, V in f32), a paged pool through the kernel's int8
option, and a paged prefix hit's suffix prefill over a dequantized view
of the chain.  A prefill attends within its own fresh, unquantized K/V.

On a mesh (training, `attention_layer`'s ``mesh``) the cache-free layer
is a Megatron tensor-parallel region by heads (`_tp_attention`), or
runs whole on leaves gathered at use where M does not divide the q
heads.

Paged decode (a cache dict with a ``'table'``) goes through the
hand-written Hopper kernel `repro_torch.kernels.paged_attn` when
``paged_impl='kernel'`` (its plain version for CPU tensors), or through
`decode_attention` over `gather_paged_kv` when ``paged_impl='plain'``
(CPU tensors only).

Cache writes (`_update_cache`, `_paged_update`) are IN PLACE on the
cache tensors they are given, and clamp every position into the cache as JAX's
``dynamic_update_slice`` and clipped scatter do: free slots keep decoding
past ``max_len``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attn import gather_paged_kv, paged_attention
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
    causal: bool = True
    window: Optional[int] = None          # local attention (griffin)
    chunk_q: int = 512
    chunk_k: int = 1024
    n_layers_scale: int = 1
    paged_impl: str = "kernel"            # 'kernel' | 'plain' (CPU only)


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
    return _qkv_post(params, q, k, v, positions, cfg)


def _qkv_post(params, q, k, v, positions, cfg: AttnConfig):
    """The projections' biases, qk-norms and RoPE."""
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = L.head_rmsnorm(params["q_norm"], q)
        k = L.head_rmsnorm(params["k_norm"], k)
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def kv_heads_of(q0: int, nq_local: int, cfg: AttnConfig):
    """The KV heads that q heads ``q0 .. q0 + nq_local - 1`` read, and
    whether they form whole GQA groups (each of them read by the same
    number of those q heads, in order): a range ``[lo, hi)``, else one
    KV head a q head."""
    g = cfg.num_heads // cfg.num_kv_heads
    of = [(q0 + i) // g for i in range(nq_local)]
    lo, n = of[0], of[-1] + 1 - of[0]
    if nq_local % n == 0 and all(
            of[i] - lo == i // (nq_local // n) for i in range(nq_local)):
        return list(range(lo, lo + n))
    return of


def _tp_attention(params, x, cfg: AttnConfig, mesh):
    """The cache-free attention layer as a tensor-parallel region: rank
    r's q heads are block r of ``wq`` / ``bq`` (column-parallel), its
    output projection the same block of ``wo``'s heads (row-parallel),
    summed over "model" once at the exit.  Its KV heads are its block of
    ``wk`` / ``wv`` / ``bk`` / ``bv`` where M divides them too (the GQA
    groups line up); else those leaves are gathered whole inside the
    region and the KV heads its q heads read are taken from them
    (`kv_heads_of`).  ``q_norm`` / ``k_norm`` stay whole."""
    from repro_torch.distributed import collectives as C
    m = mesh.model
    nq = cfg.num_heads // m
    q0 = mesh.model_index * nq
    aligned = cfg.num_kv_heads % m == 0
    kv = None if aligned else kv_heads_of(q0, nq, cfg)
    p = {"wq": L.tp_block(params, "wq", 1, mesh)}
    for name in ("wk", "wv"):
        p[name] = L.tp_block(params, name, 1, mesh, index=kv)
    if cfg.qkv_bias:
        p["bq"] = L.tp_block(params, "bq", 0, mesh)
        for name in ("bk", "bv"):
            p[name] = L.tp_block(params, name, 0, mesh, index=kv)
    if cfg.qk_norm:
        # in f32 (the norm widens its scale anyway): each rank's gradient
        # over its heads is summed over model before it is rounded once
        for name in ("q_norm", "k_norm"):
            p[name] = L.gathered_leaf(params[name].float(), name, mesh,
                                      inside=True)
    q, k, v = mesh.column_in(x, p["wq"], p["wk"], p["wv"])
    b, t = q.shape[:2]
    positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
    q, k, v = _qkv_post(p, q, k, v, positions, cfg)
    out = blockwise_attention(q, k, v, cfg).to(x.dtype)
    wo = L.tp_block(params, "wo", 0, mesh)
    y = C.matmul_f32(out.reshape(b, t, -1),
                     wo.reshape(-1, wo.shape[-1]))
    return mesh.region_out(y, x.dtype)


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
    k/v (B, T, nkv, hd) -> (B, T, nq, hd); a local window masks keys
    `window` or more positions back."""
    b, t, nq, hd = q.shape
    nkv = k.shape[2]
    q5 = q.reshape(b, t, nkv, nq // nkv, hd)
    s = _tile_scores(q5, k, cfg)                         # (B,nkv,g,T,T)
    pos = torch.arange(t, device=q.device)
    s = s.masked_fill(~_block_mask(pos, pos, t, cfg), _NEG_INF)
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
    if cfg.window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - cfg.window)
    return mask


def _kv_bounds(qi, cq, ck, nkb, cfg: AttnConfig):
    """KV-block range [lo, hi) visible from query block qi: a local
    window starts it at the block of ``qi * cq - window``."""
    hi = min(((qi + 1) * cq + ck - 1) // ck, nkb) if cfg.causal else nkb
    lo = max((qi * cq - cfg.window) // ck, 0) if cfg.window is not None \
        else 0
    return lo, hi


def _q_bounds(kj, cq, ck, nqb, cfg: AttnConfig):
    """Query-block range [lo, hi) that can see kv block kj: a local
    window ends it at the block of ``(kj + 1) * ck + window``."""
    lo = (kj * ck) // cq if cfg.causal else 0
    hi = (min((kj * ck + ck + cfg.window + cq - 1) // cq, nqb)
          if cfg.window is not None else nqb)
    return lo, hi


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
    if cfg.window is not None:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - cfg.window)
    s = s.masked_fill(~mask[:, None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _pv(p, v_cache).reshape(b, tq, nq, hd).to(q.dtype)


def extend_attention(q, k_cache, v_cache, cache_len, cfg: AttnConfig):
    """Suffix-prefill attention: new queries over [cached prefix | fresh].

    `decode_attention`'s signature and masking with `prefill_attention`'s
    arithmetic (``p = exp(s - m)``, ``acc = p @ v`` with p in the value
    dtype, ``out = acc / max(a, 1e-30)``): a prefix hit's suffix rows
    repeat the rows of a cold prefill of the whole prompt, which reduces
    over the same number of keys (the paged engine pads the suffix so
    that shared + suffix is the cold bucket)."""
    b, tq, nq, hd = q.shape
    s_len, nkv = k_cache.shape[1], k_cache.shape[2]
    q5 = q.reshape(b, tq, nkv, nq // nkv, hd)
    s = _tile_scores(q5, k_cache, cfg)                   # (B,nkv,g,Tq,S)
    kpos = torch.arange(s_len, device=q.device)
    qpos = cache_len[:, None] - tq + torch.arange(tq, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]       # (B, Tq, S)
    if cfg.window is not None:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - cfg.window)
    s = s.masked_fill(~mask[:, None, None], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    a = p.sum(dim=-1)                                    # (B,nkv,g,Tq)
    out = _pv(p, v_cache) / a.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, tq, nq, hd).to(q.dtype)


def _paged_update(pool, table, new_vals, cur_len):
    """Scatter new_vals (B, t, nkv, hd) into the shared block pool
    (N, bs, nkv, hd), IN PLACE, and return the pool.

    Position ``p`` of row ``b`` lives in block ``table[b, p // bs]`` at
    slot ``p % bs``; rows own disjoint blocks, so live writes never
    collide.  Positions past a row's table clamp into its last column,
    and free slots' null-filled rows land in the reserved null block 0,
    which nothing reads (JAX's clipped gather and scatter)."""
    b, t = new_vals.shape[:2]
    n, bs = pool.shape[:2]
    pos = cur_len.long()[:, None] + torch.arange(t, device=pool.device)
    col = (pos // bs).clamp(0, table.shape[1] - 1)
    blk = table.long().gather(1, col)                    # (B, t)
    slot = (blk * bs + pos % bs).reshape(-1)
    flat = pool.view((n * bs,) + tuple(pool.shape[2:]))
    flat.index_put_((slot,), new_vals.reshape(
        (b * t,) + tuple(new_vals.shape[2:])).to(pool.dtype))
    return pool


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
    """Dense slab KV cache {'k', 'v' (B, S, nkv, hd), 'len' (B,)};
    ``quantize=True`` stores int8 k/v with per-(token, head) f32 scales
    'k_scale' / 'v_scale' (B, S, nkv, 1): about half the bytes a cached
    token."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if quantize:
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def quantize_kv(x):
    """(..., hd) -> (int8 values, f32 scale (..., 1)): symmetric per-row
    scaling on the [-127, 127] grid, half to even."""
    x32 = x.float()
    s = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / s), -127, 127)
    return q.to(torch.int8), s


def _decode_quantized(q, cache, cfg: AttnConfig, chunk: int = 4096):
    """Decode against an int8 cache {'k', 'v', 'k_scale', 'v_scale',
    'len'}, dequantizing one chunk of keys at a time under an online
    softmax: K back to q's dtype before the score dot, V in f32.  Query i
    of Tq sits at ``len - Tq + i`` and attends causally."""
    b, tq, nq, hd = q.shape
    s_len, nkv = cache["k"].shape[1], cache["k"].shape[2]
    g = nq // nkv
    ck = min(chunk, s_len)
    nkb = -(-s_len // ck)
    q5 = q.reshape(b, tq, nkv, g, hd)
    dev = q.device
    qpos = cache["len"].long()[:, None] - tq + torch.arange(tq, device=dev)
    m = torch.full((b, nkv, g, tq), _NEG_INF, device=dev)
    a = torch.zeros((b, nkv, g, tq), device=dev)
    acc = torch.zeros((b, nkv, g, tq, hd), device=dev)
    for kj in range(nkb):
        # the ragged tail's start is clamped; the overlap is masked out
        start = min(kj * ck, s_len - ck)
        sl = slice(start, start + ck)
        kb = cache["k"][:, sl].float() * cache["k_scale"][:, sl]
        vb = cache["v"][:, sl].float() * cache["v_scale"][:, sl]
        s = _tile_scores(q5, kb.to(q.dtype), cfg)        # (B,nkv,g,Tq,ck)
        kpos = start + torch.arange(ck, device=dev)
        own = (kpos >= kj * ck) & (kpos < (kj + 1) * ck)
        mask = own[None, None, :] & (kpos[None, None, :]
                                     <= qpos[:, :, None])  # (B, Tq, ck)
        if cfg.window is not None:
            mask = mask & (kpos[None, None, :] > qpos[:, :, None]
                           - cfg.window)
        s = s.masked_fill(~mask[:, None, None], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        scale_prev = torch.exp(m - m_safe)
        a = a * scale_prev + p.sum(dim=-1)
        acc = acc * scale_prev[..., None] + torch.einsum(
            "bngqk,bknh->bngqh", p, vb)
        m = m_new
    out = acc / a.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, nq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# ring-buffer cache of local-window attention (O(window) memory at any length)
# ---------------------------------------------------------------------------


def init_local_cache(batch, window, cfg: AttnConfig, dtype=torch.bfloat16,
                     device="cpu"):
    """Ring buffer {'k', 'v' (B, W, nkv, hd), 'pos' (B, W), 'len' (B,)}:
    ``pos`` holds each slot's absolute position, -1 while empty."""
    shape = (batch, window, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, window), -1, dtype=torch.int32,
                          device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _ring_update(cache, k, v, valid=None):
    """Append T new entries at slots ``(len + i) % W``, IN PLACE on the
    cache's k / v / pos, and return the cache with ``len + T``.

    ``valid`` (B, T) marks the real positions of a bucket-padded prefill:
    a pad entry still takes its slot but stores ``pos = -1``, which
    `_ring_decode` masks.  A segment longer than the window (an
    exact-length prefill past it) writes only its last W entries: the
    others would land on slots those overwrite, and a scatter with
    repeated indices leaves an unspecified one of them on the card —
    here the later position wins by construction, as it does in the JAX
    package's in-order scatter."""
    t = k.shape[1]
    window = cache["k"].shape[1]
    lens = cache["len"]
    start = max(t - window, 0)
    pos_new = lens[:, None].long() + torch.arange(
        start, t, device=k.device)[None, :]                # (B, T')
    slots = pos_new % window
    rows = torch.arange(k.shape[0], device=k.device)[:, None].expand_as(
        slots)
    store = pos_new.to(torch.int32)
    if valid is not None:
        store = torch.where(valid[:, start:], store, -1)
    cache["k"].index_put_((rows, slots), k[:, start:].to(cache["k"].dtype))
    cache["v"].index_put_((rows, slots), v[:, start:].to(cache["v"].dtype))
    cache["pos"].index_put_((rows, slots), store)
    return dict(cache, len=lens + t)


def _ring_decode(q, cache, cfg: AttnConfig):
    """Tq >= 1 queries against the ring buffer by its stored absolute
    positions: query i sits at ``len - Tq + i`` and attends to every
    in-window entry at or before it."""
    b, tq, nq, hd = q.shape
    nkv = cache["k"].shape[2]
    q5 = q.reshape(b, tq, nkv, nq // nkv, hd)
    s = _tile_scores(q5, cache["k"], cfg)                # (B,nkv,g,Tq,W)
    qpos = cache["len"][:, None] - tq + torch.arange(tq, device=q.device)
    kpos = cache["pos"][:, None, :]                      # (B, 1, W)
    mask = (kpos >= 0) & (kpos <= qpos[:, :, None])
    if cfg.window is not None:
        mask = mask & (kpos > qpos[:, :, None] - cfg.window)
    s = s.masked_fill(~mask[:, None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _pv(p, cache["v"]).reshape(b, tq, nq, hd).to(q.dtype)


def attention_layer(
    params, x, cfg: AttnConfig, *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    decode: bool = False,
    prefill_ext: bool = False,
    valid: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention layer: returns (out, new_cache).

    cache: None (a cache-free forward, as in training, through
    `blockwise_attention`), a dense slab {'k', 'v', 'len'} or a paged
    block pool {'kp', 'vp', 'table', 'len'}, each with int8 values and
    their scales ('k_scale' / 'v_scale', 'kp_scale' / 'vp_scale') when
    quantized, or a local window's ring buffer {'k', 'v', 'pos', 'len'}
    (`init_local_cache`), whose prefill attends within its segment
    through `blockwise_attention`, as the JAX package's does, and whose
    ``valid`` (B, T) marks the real positions of a bucket-padded
    prefill (`_ring_update`).  With a cache, T > 1 is a
    prefill — the segment is written at ``len`` and attends within
    itself (the cache is empty before a prefill) — and T == 1 (or
    ``decode=True``) appends and attends over the whole cache.
    ``prefill_ext=True`` (with ``decode=True``, paged only) marks the
    suffix prefill of a prefix hit: the new tokens attend over the
    cached prefix through `extend_attention`.  The cache's k/v tensors
    or pools are updated in place; the returned cache carries the new
    ``len``.

    `mesh` (a `MeshContext` at the layer's subtree; training only, no
    cache): where the layout cut ``wq`` by heads the layer is one
    tensor-parallel region (Megatron, `_tp_attention`); otherwise its
    leaves are gathered at use and every rank runs the whole layer.
    """
    if mesh is not None:
        if cache is not None or positions is not None:
            raise ValueError("attention_layer takes a mesh in the "
                             "cache-free training forward only, at "
                             "positions 0..T-1")
        if mesh.model > 1 and mesh.cut("wq") == 1:
            return _tp_attention(params, x, cfg, mesh), None
        params = L.gathered(params, mesh)
    b, t, _ = x.shape
    is_decode = decode or t == 1
    if cfg.window is not None and cache is not None and "table" in cache \
            and is_decode:
        raise NotImplementedError(
            "paged decode has no local-window path (windowed caches "
            "are ring buffers, already O(window))")
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
    elif "table" in cache:                               # paged block pool
        quant = "kp_scale" in cache          # int8 pools + scale pools
        table = cache["table"]
        kps = vps = None
        if quant:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            kp = _paged_update(cache["kp"], table, kq, cache["len"])
            vp = _paged_update(cache["vp"], table, vq, cache["len"])
            kps = _paged_update(cache["kp_scale"], table, ks, cache["len"])
            vps = _paged_update(cache["vp_scale"], table, vs, cache["len"])
        else:
            kp = _paged_update(cache["kp"], table, k, cache["len"])
            vp = _paged_update(cache["vp"], table, v, cache["len"])
        new_len = cache["len"] + t
        new_cache = {"kp": kp, "vp": vp, "table": table, "len": new_len}
        if quant:
            new_cache["kp_scale"] = kps
            new_cache["vp_scale"] = vps
        if not is_decode:
            # cold prefill: the chain is empty, attend within the segment
            out = prefill_attention(q, k, v, cfg)
        elif prefill_ext:
            if quant:
                # over a dequantized view of the chain, with
                # `_decode_quantized`'s factors (K to q's dtype, V in f32)
                kd = (gather_paged_kv(kp, table).float()
                      * gather_paged_kv(kps, table)).to(q.dtype)
                vd = (gather_paged_kv(vp, table).float()
                      * gather_paged_kv(vps, table))
                out = extend_attention(q, kd, vd, new_len, cfg)
            else:
                out = extend_attention(q, gather_paged_kv(kp, table),
                                       gather_paged_kv(vp, table), new_len,
                                       cfg)
        elif cfg.paged_impl == "kernel":
            out = paged_attention(q, kp, vp, table, new_len, kp_scale=kps,
                                  vp_scale=vps, softcap=cfg.attn_softcap)
        elif cfg.paged_impl == "plain":
            if q.device.type != "cpu":
                raise ValueError("paged_impl='plain' (the gather oracle) "
                                 "runs on CPU tensors only")
            if quant:
                dense = {"k": gather_paged_kv(kp, table),
                         "v": gather_paged_kv(vp, table),
                         "k_scale": gather_paged_kv(kps, table),
                         "v_scale": gather_paged_kv(vps, table),
                         "len": new_len}
                out = _decode_quantized(q, dense, cfg)
            else:
                out = decode_attention(q, gather_paged_kv(kp, table),
                                       gather_paged_kv(vp, table), new_len,
                                       cfg)
        else:
            raise ValueError(f"unknown paged_impl {cfg.paged_impl!r}")
    elif "pos" in cache:                                 # local ring
        new_cache = _ring_update(cache, k, v, valid=valid)
        if is_decode:
            out = _ring_decode(q, new_cache, cfg)
        else:
            out = blockwise_attention(q, k, v, cfg)
    elif "k_scale" in cache:                             # int8 slab
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        lens = cache["len"]
        new_cache = {
            "k": _update_cache(cache["k"], kq, lens),
            "v": _update_cache(cache["v"], vq, lens),
            "k_scale": _update_cache(cache["k_scale"], ks, lens),
            "v_scale": _update_cache(cache["v_scale"], vs, lens),
            "len": lens + t,
        }
        if is_decode:
            out = _decode_quantized(q, new_cache, cfg)
        else:
            out = prefill_attention(q, k, v, cfg)
    else:
        k_cache = _update_cache(cache["k"], k, cache["len"])
        v_cache = _update_cache(cache["v"], v, cache["len"])
        new_len = cache["len"] + t
        new_cache = {"k": k_cache, "v": v_cache, "len": new_len}
        if is_decode:
            out = decode_attention(q, k_cache, v_cache, new_len, cfg)
        else:
            out = prefill_attention(q, k, v, cfg)
    y = torch.einsum("btnh,nhd->btd", out.to(x.dtype), params["wo"])
    return y, new_cache
