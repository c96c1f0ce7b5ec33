"""Decoder-only transformer LM family, dense and MoE, with the frontend
stub's prepended embeddings (port of `repro.models.transformer`).

An MoE block (``num_experts > 0``) runs `models.moe.moe_layer` in place of
the MLP, or beside it with ``dense_ff_residual`` (arctic); each block's
load-balance aux loss is summed over the layers.  ``frontend_embeds``
(B, F, d), precomputed (internvl2's stubbed ViT patches), go ahead of the
token embeddings: the hidden states and the caches cover those F
positions too.

Layers run as a Python loop over a list of per-layer param dicts (the
JAX package scans stacked params; `repro_torch.weights` unstacks them).
A cache-free forward under autograd rematerializes each block in its
backward (`torch.utils.checkpoint`, non-reentrant) when `remat` is set,
as the JAX package's ``jax.checkpoint`` per block.
The serve caches keep the JAX package's stacked layout — slab
``{'k', 'v': (L, B, S, nkv, hd), 'len': (L, B)}`` or paged
``{'kp', 'vp': (L, N, bs, nkv, hd), 'table': (L, B, nb), 'len': (L, B)}``
— and each layer reads its own views of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    d_model: int
    n_layers: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    logit_softcap: Optional[float] = None
    # MoE (num_experts == 0 -> dense)
    num_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    dense_ff_residual: bool = False         # arctic: dense FFN || MoE
    # frontend stub: number of precomputed embedding positions prepended
    frontend_len: int = 0
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    chunk_q: int = 512
    chunk_k: int = 1024
    paged_impl: str = "kernel"    # paged-KV decode: 'kernel' | 'plain'

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attn_config(self) -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, chunk_q=self.chunk_q,
            chunk_k=self.chunk_k, n_layers_scale=self.n_layers,
            paged_impl=self.paged_impl)

    def moe_config(self) -> M.MoEConfig:
        return M.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff_expert or self.d_ff,
            num_experts=self.num_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            aux_weight=self.aux_weight, n_layers_scale=self.n_layers)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(cfg: TransformerConfig, generator: torch.Generator,
               device="cpu"):
    dt = dtype_of(cfg.param_dtype)
    p = {
        "ln_attn": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": A.init_attention(cfg.attn_config(), generator, dt, device),
        "ln_mlp": L.init_rmsnorm(cfg.d_model, dt, device),
    }
    if cfg.is_moe:
        p["moe"] = M.init_moe(cfg.moe_config(), generator, dt, device)
    if not cfg.is_moe or cfg.dense_ff_residual:
        p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, generator,
                              n_layers_scale=cfg.n_layers, dtype=dt,
                              device=device)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random params with the JAX package's distributions (truncated-
    normal fan-in dense layers, N(0, 0.02) embedding); `generator` must
    live on `device`."""
    dt = dtype_of(cfg.param_dtype)
    return {
        "embed": {"table": L.embed_init((cfg.vocab_size, cfg.d_model),
                                        generator, dtype=dt,
                                        device=device)},
        "blocks": [init_block(cfg, generator, device)
                   for _ in range(cfg.n_layers)],
        "ln_f": L.init_rmsnorm(cfg.d_model, dt, device),
        "lm_head": L.dense_init((cfg.vocab_size, cfg.d_model), generator,
                                dtype=dt, device=device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_block(p, x, cfg: TransformerConfig, *, cache=None,
                decode: bool = False, prefill_ext: bool = False,
                mesh=None):
    """Pre-norm block; returns (x, aux, new_cache).

    `mesh` (a `distributed.collectives.MeshContext` at the blocks'
    subtree, training on a mesh): attention and the dense MLP run as
    tensor-parallel regions over "model" (Megatron) where the layout cut
    them so, the MoE layer as expert parallelism, the norms' scales
    gathered at use.  Arctic's dense MLP beside an expert-parallel MoE
    shares its region: their partial outputs are summed over "model"
    once."""
    ln_attn, ln_mlp = p["ln_attn"], p["ln_mlp"]
    if mesh is not None:
        ln_attn = L.gathered(ln_attn, mesh.sub("ln_attn"))
        ln_mlp = L.gathered(ln_mlp, mesh.sub("ln_mlp"))
    h, new_cache = A.attention_layer(
        p["attn"], L.rmsnorm(ln_attn, x, cfg.norm_eps),
        cfg.attn_config(), cache=cache, decode=decode,
        prefill_ext=prefill_ext,
        mesh=None if mesh is None else mesh.sub("attn"))
    x = x + h
    xn = L.rmsnorm(ln_mlp, x, cfg.norm_eps)
    mlp_mesh = None if mesh is None else mesh.sub("mlp")
    if not cfg.is_moe:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + L.mlp(p["mlp"], xn, mlp_mesh), aux, new_cache
    mcfg = cfg.moe_config()
    moe_mesh = None if mesh is None else mesh.sub("moe")
    if cfg.dense_ff_residual and M.expert_parallel(mcfg, moe_mesh) and \
            L.mlp_split(mlp_mesh):
        part, aux = M.moe_part(p["moe"], xn, mcfg, moe_mesh)
        mo = mesh.region_out(part + L.mlp_part(p["mlp"], xn, mlp_mesh),
                             xn.dtype)
        if "bo" in p["mlp"]:
            mo = mo + p["mlp"]["bo"]
        return x + mo, aux, new_cache
    mo, aux = M.moe_layer(p["moe"], xn, mcfg, moe_mesh)
    if cfg.dense_ff_residual:
        mo = mo + L.mlp(p["mlp"], xn, mlp_mesh)
    return x + mo, aux, new_cache


def forward(
    params, tokens: torch.Tensor, cfg: TransformerConfig, *,
    frontend_embeds: Optional[torch.Tensor] = None,
    caches: Optional[Dict[str, torch.Tensor]] = None,
    decode: bool = False,
    prefill_ext: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """tokens (B, T) [+ frontend_embeds (B, F, d)] -> (hidden
    (B, F + T, d), aux_loss summed over the layers, new_caches).

    With `caches`, each layer gets its own views of every stacked leaf and
    writes its K/V into them IN PLACE (slab k/v or paged pools); the
    returned tree holds the same tensors and the new lens.
    ``prefill_ext`` marks a paged suffix prefill (`attention_layer`).
    `mesh` (a `MeshContext`, training on a mesh): tokens are this rank's
    rows; the embedding and the blocks run on its shards of them
    (`apply_block`)."""
    x = L.embed_lookup(params["embed"]["table"], tokens, mesh,
                       cfg.d_model).to(
        dtype_of(cfg.compute_dtype))
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    lens = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = caches is None and cfg.remat and torch.is_grad_enabled()
    blocks = None if mesh is None else mesh.sub("blocks")
    for i, p in enumerate(params["blocks"]):
        if remat:
            x, a = checkpoint(
                lambda x_, p_=p: apply_block(p_, x_, cfg, mesh=blocks)[:2],
                x, use_reentrant=False)
            aux = aux + a
            continue
        cache = None
        if caches is not None:
            cache = {key: val[i] for key, val in caches.items()}
        x, a, new_cache = apply_block(p, x, cfg, cache=cache, decode=decode,
                                      prefill_ext=prefill_ext, mesh=blocks)
        aux = aux + a
        if new_cache is not None:
            lens.append(new_cache["len"])
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    new_caches = None
    if caches is not None:
        new_caches = dict(caches, len=torch.stack(lens))
    return x, aux, new_caches


def stacked_caches(acfg: A.AttnConfig, n_layers: int, batch: int,
                   max_len: int, dtype=torch.bfloat16, device="cpu",
                   quantize: bool = False, paged=None):
    """`n_layers` slab caches stacked: k/v (L, B, S, nkv, hd), len (L, B);
    with `paged` (a `serve.kvpool.PagedConfig`), the paged form of them
    (`serve.kvpool.paged_tree`; the slab is never allocated)."""
    one = A.init_cache(batch, max_len, acfg, dtype,
                       "meta" if paged is not None else device,
                       quantize=quantize)
    slab = {key: val[None].repeat((n_layers,) + (1,) * val.dim())
            for key, val in one.items()}
    if paged is None:
        return slab
    from repro_torch.serve.kvpool import paged_tree
    return paged_tree(slab, paged, device=device)


def init_caches(cfg: TransformerConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cpu", quantize: bool = False,
                paged=None):
    """The serve caches: `stacked_caches` of every layer."""
    return stacked_caches(cfg.attn_config(), cfg.n_layers, batch, max_len,
                          dtype, device, quantize=quantize, paged=paged)
