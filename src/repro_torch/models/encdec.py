"""Encoder-decoder transformer: seamless-m4t-medium's backbone (port of
`repro.models.encdec`).

The speech frontend is a stub, as in the JAX package: ``frontend_embeds``
(B, T_enc, d), precomputed frame embeddings, are the encoder's input,
cast to the compute dtype first.  The encoder's blocks attend without a
causal mask but with RoPE at positions 0..T_enc-1; `ln_enc` closes it.
Each decoder block runs causal self-attention, then cross-attention
(no RoPE, no mask: `blockwise_attention` over all T_enc keys) of its
queries over the K/V that its own ``cross_attn`` projects from the
encoder output, then the MLP; `ln_f` closes the decoder.  Both stacks
use the non-gated GeLU MLP with biases, and every output projection is
scaled for ``n_enc_layers + n_dec_layers`` layers.  The aux loss is 0.

Params: ``enc`` and ``dec`` are lists of per-layer dicts (the JAX package
stacks them; `repro_torch.weights` unstacks them).  A cache-free forward
under autograd rematerializes each block in its backward
(`torch.utils.checkpoint`) when `remat` is set; a decoder block's
checkpoint recomputes its cross K/V too, so the gradient reaches the
encoder through every decoder layer.

Serve caches: ``{'self': ..., 'cross': [...]}``.  ``self`` is the
transformer's stacked slab ``{'k', 'v': (L, B, S, nkv, hd), 'len': (L,
B)}`` or its paged form (`models.transformer.stacked_caches`), in the
cache dtype; ``cross`` is a per-layer list of ``{'k', 'v': (B, T_enc,
nkv, hd)}``, batch axis first, in the dtype of the encoder output (the
compute dtype, whatever the cache dtype, as the reference's), computed
once a request from its frames (`init_caches`) and never written by a
forward.  Only ``self`` has a ``len``, so the length arithmetic of
bucketing and of the speculative rollback leaves ``cross`` alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import dtype_of, stacked_caches


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    d_model: int
    n_enc_layers: int
    n_dec_layers: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    chunk_q: int = 512
    chunk_k: int = 1024
    paged_impl: str = "kernel"    # paged-KV decode: 'kernel' | 'plain'
    logit_softcap: Optional[float] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def n_layers_scale(self) -> int:
        return self.n_enc_layers + self.n_dec_layers

    def attn_config(self, causal: bool = True) -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.resolved_head_dim,
            rope_theta=self.rope_theta, causal=causal,
            chunk_q=self.chunk_q, chunk_k=self.chunk_k,
            n_layers_scale=self.n_layers_scale, paged_impl=self.paged_impl)

    @property
    def cross_dtype(self) -> torch.dtype:
        """The dtype of the encoder output and of the cross K/V."""
        return torch.promote_types(dtype_of(self.compute_dtype),
                                   dtype_of(self.param_dtype))


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------


def init_cross_attention(cfg: EncDecConfig, generator: torch.Generator,
                         dtype=torch.float32, device="cpu"):
    """wq (d, nq, hd), wk / wv (d, nkv, hd), wo (nq, hd, d): the
    self-attention's layout without biases or norms."""
    d, nq = cfg.d_model, cfg.num_heads
    nkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    out_scale = 1.0 / (2.0 * cfg.n_layers_scale) ** 0.5
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": L.dense_init((d, nq, hd), generator, **kw),
        "wk": L.dense_init((d, nkv, hd), generator, **kw),
        "wv": L.dense_init((d, nkv, hd), generator, **kw),
        "wo": L.dense_init((nq, hd, d), generator, scale=out_scale, **kw),
    }


def cross_kv(params, enc_out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The cross K/V {'k', 'v': (B, T_enc, nkv, hd)} of one decoder layer
    from the encoder output (B, T_enc, d)."""
    return {"k": torch.einsum("bsd,dnh->bsnh", enc_out, params["wk"]),
            "v": torch.einsum("bsd,dnh->bsnh", enc_out, params["wv"])}


def cross_attention(params, x: torch.Tensor, kv, cfg: EncDecConfig):
    """x (B, T_dec, d) over `kv` (`cross_kv`): no positions, no mask."""
    q = torch.einsum("btd,dnh->btnh", x, params["wq"])
    out = A.blockwise_attention(q, kv["k"], kv["v"],
                                cfg.attn_config(causal=False))
    return torch.einsum("btnh,nhd->btd", out.to(x.dtype), params["wo"])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _mlp_init(cfg: EncDecConfig, generator, dtype, device):
    return L.init_mlp(cfg.d_model, cfg.d_ff, generator, gated=False,
                      bias=True, n_layers_scale=cfg.n_layers_scale,
                      dtype=dtype, device=device)


def init_enc_block(cfg: EncDecConfig, generator: torch.Generator, dtype,
                   device="cpu"):
    return {
        "ln_attn": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": A.init_attention(cfg.attn_config(causal=False), generator,
                                 dtype, device),
        "ln_mlp": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": _mlp_init(cfg, generator, dtype, device),
    }


def apply_enc_block(p, x: torch.Tensor, cfg: EncDecConfig) -> torch.Tensor:
    h, _ = A.attention_layer(p["attn"],
                             L.rmsnorm(p["ln_attn"], x, cfg.norm_eps),
                             cfg.attn_config(causal=False))
    x = x + h
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps))


def init_dec_block(cfg: EncDecConfig, generator: torch.Generator, dtype,
                   device="cpu"):
    return {
        "ln_self": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": A.init_attention(cfg.attn_config(), generator, dtype,
                                 device),
        "ln_cross": L.init_rmsnorm(cfg.d_model, dtype, device),
        "cross_attn": init_cross_attention(cfg, generator, dtype, device),
        "ln_mlp": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": _mlp_init(cfg, generator, dtype, device),
    }


def apply_dec_block(p, x: torch.Tensor, kv, cfg: EncDecConfig, *,
                    cache=None, decode: bool = False,
                    prefill_ext: bool = False):
    """kv: this layer's cross K/V; cache: its self-attention cache
    (serving only).  Returns (x, new_cache)."""
    h, new_cache = A.attention_layer(
        p["attn"], L.rmsnorm(p["ln_self"], x, cfg.norm_eps),
        cfg.attn_config(), cache=cache, decode=decode,
        prefill_ext=prefill_ext)
    x = x + h
    x = x + cross_attention(p["cross_attn"],
                            L.rmsnorm(p["ln_cross"], x, cfg.norm_eps), kv,
                            cfg)
    x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps))
    return x, new_cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init_params(cfg: EncDecConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random params with the JAX package's distributions; `generator`
    must live on `device`."""
    dt = dtype_of(cfg.param_dtype)
    return {
        "embed": {"table": L.embed_init((cfg.vocab_size, cfg.d_model),
                                        generator, dtype=dt,
                                        device=device)},
        "enc": [init_enc_block(cfg, generator, dt, device)
                for _ in range(cfg.n_enc_layers)],
        "dec": [init_dec_block(cfg, generator, dt, device)
                for _ in range(cfg.n_dec_layers)],
        "ln_enc": L.init_rmsnorm(cfg.d_model, dt, device),
        "ln_f": L.init_rmsnorm(cfg.d_model, dt, device),
        "lm_head": L.dense_init((cfg.vocab_size, cfg.d_model), generator,
                                dtype=dt, device=device),
    }


def encode(params, frame_embeds: torch.Tensor,
           cfg: EncDecConfig, mesh=None) -> torch.Tensor:
    """The encoder output (B, T_enc, d) of frames (B, T_enc, d).  On a
    mesh (`mesh`, a `MeshContext`) every block's leaves are gathered at
    use and every rank runs the whole block on its rows."""
    x = frame_embeds.to(dtype_of(cfg.compute_dtype))
    remat = cfg.remat and torch.is_grad_enabled()
    def block(p, x):
        if mesh is not None:
            p = L.gathered(p, mesh.sub("enc"))
        return apply_enc_block(p, x, cfg)

    for p in params["enc"]:
        if remat:
            x = checkpoint(lambda x_, p_=p: block(p_, x_), x,
                           use_reentrant=False)
        else:
            x = block(p, x)
    return L.rmsnorm(params["ln_enc"], x, cfg.norm_eps)


def _train_dec_block(p, x, enc_out, cfg, mesh=None):
    if mesh is not None:
        p = L.gathered(p, mesh.sub("dec"))
    return apply_dec_block(p, x, cross_kv(p["cross_attn"], enc_out), cfg)[0]


def decode_hidden(params, tokens: torch.Tensor, enc_out, cfg: EncDecConfig,
                  *, caches=None, cross=None, decode: bool = False,
                  prefill_ext: bool = False, mesh=None):
    """The decoder: (hidden (B, T, d), new self caches).  Training passes
    `enc_out` alone (each layer projects its cross K/V from it), and on a
    mesh its `MeshContext`, which reaches the embedding and gathers each
    block's leaves at use; serving passes
    the per-layer `cross` K/V and the stacked self `caches`, whose
    per-layer views each layer writes IN PLACE."""
    x = L.embed_lookup(params["embed"]["table"], tokens, mesh,
                       cfg.d_model).to(
        dtype_of(cfg.compute_dtype))
    if cross is None:
        remat = cfg.remat and torch.is_grad_enabled()
        for p in params["dec"]:
            if remat:
                x = checkpoint(
                    lambda x_, e_, p_=p: _train_dec_block(p_, x_, e_, cfg,
                                                          mesh),
                    x, enc_out, use_reentrant=False)
            else:
                x = _train_dec_block(p, x, enc_out, cfg, mesh)
        return L.rmsnorm(params["ln_f"], x, cfg.norm_eps), None
    lens = []
    for i, p in enumerate(params["dec"]):
        cache = {key: val[i] for key, val in caches.items()}
        x, new_cache = apply_dec_block(p, x, cross[i], cfg, cache=cache,
                                       decode=decode,
                                       prefill_ext=prefill_ext)
        lens.append(new_cache["len"])
    return (L.rmsnorm(params["ln_f"], x, cfg.norm_eps),
            dict(caches, len=torch.stack(lens)))


def forward(params, tokens: torch.Tensor, cfg: EncDecConfig, *,
            frontend_embeds: Optional[torch.Tensor] = None, caches=None,
            decode: bool = False, prefill_ext: bool = False, mesh=None):
    """tokens (B, T) -> (decoder hidden (B, T, d), aux 0, new caches).

    Cache-free (training, a reference forward): `frontend_embeds` (B,
    T_enc, d) run through the encoder.  Serving: the encoder output is
    already in ``caches['cross']``; `decode` / `prefill_ext` as in
    `models.attention.attention_layer`."""
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if caches is not None:
        x, selfc = decode_hidden(params, tokens, None, cfg,
                                 caches=caches["self"],
                                 cross=caches["cross"], decode=decode,
                                 prefill_ext=prefill_ext)
        return x, aux, {"self": selfc, "cross": caches["cross"]}
    if frontend_embeds is None:
        raise ValueError("an enc-dec forward without caches needs "
                         "frontend_embeds (B, T_enc, d): the encoder input")
    enc_out = encode(params, frontend_embeds, cfg, mesh)
    x, _ = decode_hidden(params, tokens, enc_out, cfg, mesh=mesh)
    return x, aux, None


def init_caches(params, cfg: EncDecConfig, frame_embeds: torch.Tensor,
                max_len: int, dtype=torch.bfloat16, device="cpu",
                paged=None):
    """Serving caches of a batch of requests: the encoder runs once over
    `frame_embeds` (B, T_enc, d) and every decoder layer's cross K/V are
    precomputed; the self caches start empty (slab, or paged with
    `paged`)."""
    enc_out = encode(params, frame_embeds, cfg)
    return {"self": stacked_caches(cfg.attn_config(), cfg.n_dec_layers,
                                   frame_embeds.shape[0], max_len, dtype,
                                   device, paged=paged),
            "cross": [cross_kv(p["cross_attn"], enc_out)
                      for p in params["dec"]]}


def empty_caches(cfg: EncDecConfig, batch: int, max_len: int, enc_len: int,
                 dtype=torch.bfloat16, device="cpu", paged=None):
    """The batched container whose slots await per-slot prefills: zeros,
    cross at `enc_len` frames; no encoder runs."""
    shape = (batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim)

    def zeros():
        return torch.zeros(shape, dtype=cfg.cross_dtype, device=device)

    return {"self": stacked_caches(cfg.attn_config(), cfg.n_dec_layers,
                                   batch, max_len, dtype, device,
                                   paged=paged),
            "cross": [{"k": zeros(), "v": zeros()}
                      for _ in range(cfg.n_dec_layers)]}
