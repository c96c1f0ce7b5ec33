"""Decoder-only transformer LM family, dense (port of
`repro.models.transformer`).

Layers run as a Python loop over a list of per-layer param dicts (the
JAX package scans stacked params; `repro_torch.weights` unstacks them).
A cache-free forward under autograd rematerializes each block in its
backward (`torch.utils.checkpoint`, non-reentrant) when `remat` is set,
as the JAX package's ``jax.checkpoint`` per block.
The serve caches keep the JAX package's stacked layout,
``{'k', 'v': (L, B, S, nkv, hd), 'len': (L, B)}``, and each layer reads
its own views of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L


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
    num_experts: int = 0                    # MoE: ROADMAP A8
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    chunk_q: int = 512
    chunk_k: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attn_config(self) -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, chunk_q=self.chunk_q,
            chunk_k=self.chunk_k, n_layers_scale=self.n_layers)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def _require_dense(cfg: TransformerConfig):
    if cfg.is_moe:
        raise NotImplementedError("MoE transformer blocks come with "
                                  "ROADMAP A8")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(cfg: TransformerConfig, generator: torch.Generator,
               device="cpu"):
    _require_dense(cfg)
    dt = dtype_of(cfg.param_dtype)
    return {
        "ln_attn": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": A.init_attention(cfg.attn_config(), generator, dt, device),
        "ln_mlp": L.init_rmsnorm(cfg.d_model, dt, device),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, generator,
                          n_layers_scale=cfg.n_layers, dtype=dt,
                          device=device),
    }


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
                decode: bool = False):
    """Pre-norm block; returns (x, new_cache)."""
    _require_dense(cfg)
    h, new_cache = A.attention_layer(
        p["attn"], L.rmsnorm(p["ln_attn"], x, cfg.norm_eps),
        cfg.attn_config(), cache=cache, decode=decode)
    x = x + h
    x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps))
    return x, new_cache


def forward(
    params, tokens: torch.Tensor, cfg: TransformerConfig, *,
    caches: Optional[Dict[str, torch.Tensor]] = None,
    decode: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """tokens (B, T) -> (hidden (B, T, d), aux_loss, new_caches).

    With `caches`, each layer writes its K/V into the stacked k/v tensors
    IN PLACE; the returned tree holds the same k/v and the new lens."""
    x = L.embed_lookup(params["embed"]["table"], tokens).to(
        dtype_of(cfg.compute_dtype))
    lens = []
    remat = caches is None and cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(params["blocks"]):
        if remat:
            x = checkpoint(lambda x_, p_=p: apply_block(p_, x_, cfg)[0], x,
                           use_reentrant=False)
            continue
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i],
                     "len": caches["len"][i]}
        x, new_cache = apply_block(p, x, cfg, cache=cache, decode=decode)
        if new_cache is not None:
            lens.append(new_cache["len"])
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = None
    if caches is not None:
        new_caches = {"k": caches["k"], "v": caches["v"],
                      "len": torch.stack(lens)}
    return x, aux, new_caches


def init_caches(cfg: TransformerConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cpu", quantize: bool = False):
    """Stacked per-layer slab caches: k/v (L, B, S, nkv, hd), len (L, B)."""
    one = A.init_cache(batch, max_len, cfg.attn_config(), dtype, device,
                       quantize=quantize)
    return {key: val[None].repeat((cfg.n_layers,) + (1,) * val.dim())
            for key, val in one.items()}
