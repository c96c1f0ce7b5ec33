"""Griffin / RecurrentGemma (arXiv:2402.19427): RG-LRU + local attention
(port of `repro.models.griffin`).

Residual pattern: repeating (recurrent, recurrent, local-attention)
temporal blocks, each followed by a gated MLP block.  The RG-LRU diagonal
linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(lam) * r_t),   r_t, i_t gates

runs as a log-depth associative scan for training and prefill, and one
combine a step for decode.  None of it is a Pallas kernel in the JAX
package (``jax.lax.associative_scan`` and plain ``jnp``), so all of it
is plain PyTorch here.

The scan (`_assoc_scan`) is the odd/even recursion of
``jax.lax.associative_scan``: it pairs ``[0:-1:2]`` with ``[1::2]``,
recurses, combines the odd results with ``[2::2]`` and interleaves, so
every output is the same tree of combines as the reference's.  That
matters for the carried state of a bucket-padded prefill: its pad steps
(``a = 1, u = 0``, exact identities) change where the last real element
sits in the tree, so its ``h_T`` differs from an exact-length prefill's
by an ulp or two in f32 wherever the true length is not a power of two.
The reference's docstring calls the two bit-identical; its outputs at
the real positions are, its carried state is not.  The port holds its
state to the JAX package's padded run.

Params keep the JAX package's layout, with its layer-stacked ``supers``
(``scan_layers=True``: (n_super, ...) leaves of (rec, rec, attn) blocks)
unstacked into a list of per-super dicts, as the transformer's
``blocks``; the ``rem<i>`` blocks left over after the supers are plain
subtrees in both.  The serve state is ``{'supers': [{'b<i>': state}
...], 'rem<i>': state}``: a recurrent block's ``{'conv' (B, w-1, d_rnn),
'h' (B, d_rnn) f32}``, an attention block's ring buffer
(`attention.init_local_cache`); every leaf has its batch axis first.
A forward returns new ``conv`` / ``h`` tensors (the old ones are left as
they were) and writes the ring buffers IN PLACE.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L

_C = 8.0  # RG-LRU decay sharpness constant (paper section 2.4)


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    name: str
    d_model: int
    n_layers: int                  # temporal blocks total
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_rnn: Optional[int] = None    # defaults to d_model
    window: int = 2048
    head_dim: Optional[int] = None
    rglru_blocks: Optional[int] = None   # default: num_heads
    conv_width: int = 4
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    scan_layers: bool = True
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    chunk_q: int = 512
    chunk_k: int = 1024
    # the serving plumbing's fields, which the JAX package reads through
    # getattr defaults: no softcap, no frontend, nothing paged
    logit_softcap: Optional[float] = None
    frontend_len: int = 0
    paged_impl: str = "kernel"

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attn_config(self) -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.resolved_head_dim,
            rope_theta=self.rope_theta, window=self.window,
            chunk_q=self.chunk_q, chunk_k=self.chunk_k,
            n_layers_scale=self.n_layers)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def init_rglru(d_rnn, generator: torch.Generator, *, dtype=torch.float32,
               num_blocks: int = 1, device="cpu"):
    """``lam`` (f32 whatever the model's dtype) so that a^c lies in
    [0.9, 0.999]; block-diagonal gates ``wa`` / ``wx`` (nb, db, db) when
    ``num_blocks > 1``, whose fan-in is the reference's ``shape[0]`` (the
    block count: std 1/sqrt(nb), not 1/sqrt(db))."""
    u = torch.empty((d_rnn,), dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    db = d_rnn // num_blocks
    shape = (db, db) if num_blocks == 1 else (num_blocks, db, db)
    kw = dict(dtype=dtype, device=device)
    return {
        "lam": lam,
        "wa": L.dense_init(shape, generator, **kw),
        "ba": torch.zeros((d_rnn,), **kw),
        "wx": L.dense_init(shape, generator, **kw),
        "bx": torch.zeros((d_rnn,), **kw),
    }


def _gate_matmul(x32, w):
    """x32 (B, T, D) f32 through a dense (D, D) or block-diagonal
    (nb, db, db) gate matrix, in f32."""
    w32 = w.float()
    if w.dim() == 2:
        return x32 @ w32
    nb, db = w.shape[0], w.shape[1]
    b, t, d = x32.shape
    out = torch.einsum("btnd,nde->btne", x32.reshape(b, t, nb, db), w32)
    return out.reshape(b, t, d)


def _combine(a1, u1, a2, u2):
    return a1 * a2, a2 * u1 + u2


def _interleave(even, odd):
    """out[:, 0::2] = even, out[:, 1::2] = odd along axis 1 (even holds
    one more element than odd when the length is odd)."""
    n_odd = odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2)
    out = pairs.reshape((even.shape[0], 2 * n_odd) + tuple(even.shape[2:]))
    if even.shape[1] > n_odd:
        out = torch.cat([out, even[:, n_odd:]], dim=1)
    return out


def _assoc_scan(a, u):
    """Inclusive scan of ``(a, u)`` along axis 1 under `_combine`, with
    ``jax.lax.associative_scan``'s odd/even recursion (module
    docstring): log2(T) levels of elementwise ops, whose backward
    autograd gives."""
    n = a.shape[1]
    if n < 2:
        return a, u
    a_r, u_r = _combine(a[:, 0:-1:2], u[:, 0:-1:2], a[:, 1::2], u[:, 1::2])
    a_o, u_o = _assoc_scan(a_r, u_r)
    if n % 2 == 0:
        a_e, u_e = _combine(a_o[:, :-1], u_o[:, :-1], a[:, 2::2],
                            u[:, 2::2])
    else:
        a_e, u_e = _combine(a_o, u_o, a[:, 2::2], u[:, 2::2])
    a_e = torch.cat([a[:, :1], a_e], dim=1)
    u_e = torch.cat([u[:, :1], u_e], dim=1)
    return _interleave(a_e, a_o), _interleave(u_e, u_o)


def rglru(params, x, h0=None, valid=None):
    """x (B, T, D) -> (y (B, T, D) in x's dtype, h_T (B, D) f32).

    The gates, the decay and the scan run in f32.  ``valid`` (B, T)
    masks bucket-pad steps of a padded prefill to ``a = 1, u = 0``; `h0`
    folds into the first step as ``u_0 += a_0 * h0``."""
    x32 = x.float()
    r = torch.sigmoid(_gate_matmul(x32, params["wa"])
                      + params["ba"].float())
    i = torch.sigmoid(_gate_matmul(x32, params["wx"])
                      + params["bx"].float())
    log_a = -_C * F.softplus(params["lam"].float()) * r   # (B,T,D) <= 0
    if valid is not None:
        log_a = torch.where(valid[..., None], log_a, 0.0)
    a = torch.exp(log_a)
    # sqrt(1 - a^2) through expm1, stably
    gate = torch.sqrt(torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12))
    u = gate * (i * x32)
    if valid is not None:
        u = torch.where(valid[..., None], u, 0.0)
    if h0 is not None:
        u = torch.cat([u[:, :1] + a[:, :1] * h0[:, None].float(), u[:, 1:]],
                      dim=1)
    _, h = _assoc_scan(a, u)
    return h.to(x.dtype), h[:, -1]


def rglru_step(params, x, h_prev):
    """One decode step: x (B, 1, D), h_prev (B, D)."""
    return rglru(params, x, h0=h_prev)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_recurrent_block(cfg: GriffinConfig, generator: torch.Generator,
                         dtype, device="cpu"):
    d, dr = cfg.d_model, cfg.resolved_d_rnn
    kw = dict(dtype=dtype, device=device)
    return {
        "ln": L.init_rmsnorm(d, dtype, device),
        "w_rnn": L.dense_init((d, dr), generator, **kw),
        "w_gate": L.dense_init((d, dr), generator, **kw),
        "conv": L.init_causal_conv(dr, generator, cfg.conv_width, **kw),
        "rglru": init_rglru(dr, generator,
                            num_blocks=cfg.rglru_blocks or cfg.num_heads,
                            **kw),
        "w_out": L.dense_init((dr, d), generator,
                              scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def apply_recurrent_block(p, x, cfg: GriffinConfig, state=None,
                          true_len: Optional[int] = None):
    xin = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    u = xin @ p["w_rnn"]
    gate = xin @ p["w_gate"]
    conv_state = state["conv"] if state is not None else None
    uc, conv_state = L.causal_conv(p["conv"], u, conv_state)
    valid = None
    if true_len is not None and state is not None and true_len < x.shape[1]:
        # bucketed prefill: pad steps must not touch the carried state
        valid = (torch.arange(x.shape[1], device=x.device) < true_len)[None]
        conv_state = L.conv_state_at(state["conv"], u, true_len)
    h_prev = state["h"] if state is not None else None
    y, h_last = rglru(p["rglru"], uc, h0=h_prev, valid=valid)
    # jax.nn.gelu's default is the tanh approximation
    y = y * F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    out = y @ p["w_out"]
    new_state = ({"conv": conv_state, "h": h_last}
                 if state is not None else None)
    return x + out, new_state


def init_temporal_block(kind: str, cfg: GriffinConfig,
                        generator: torch.Generator, dtype, device="cpu"):
    if kind == "rec":
        tb = init_recurrent_block(cfg, generator, dtype, device)
    else:
        tb = {"ln": L.init_rmsnorm(cfg.d_model, dtype, device),
              "attn": A.init_attention(cfg.attn_config(), generator, dtype,
                                       device)}
    return {
        "temporal": tb,
        "ln_mlp": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, generator,
                          n_layers_scale=cfg.n_layers, dtype=dtype,
                          device=device),
    }


def apply_temporal_block(p, x, kind: str, cfg: GriffinConfig, state=None,
                         decode: bool = False,
                         true_len: Optional[int] = None, mesh=None):
    """One temporal block and its MLP.  `mesh` (a `MeshContext` at the
    block's subtree, training on a mesh): the local attention and the
    MLP run as tensor-parallel regions (`attention_layer`, `layers.mlp`);
    the recurrent block's leaves and the norms' scales are gathered at
    use, every rank running the whole recurrence."""
    ln_mlp = p["ln_mlp"]
    if mesh is not None:
        ln_mlp = L.gathered(ln_mlp, mesh.sub("ln_mlp"))
    if kind == "attn" and mesh is not None:
        tmesh = mesh.sub("temporal")
        h, new_state = A.attention_layer(
            p["temporal"]["attn"],
            L.rmsnorm(L.gathered(p["temporal"]["ln"], tmesh.sub("ln")), x,
                      cfg.norm_eps),
            cfg.attn_config(), mesh=tmesh.sub("attn"))
        x = x + h
    elif kind == "attn":
        valid = None
        if true_len is not None and state is not None \
                and true_len < x.shape[1]:
            valid = (torch.arange(x.shape[1], device=x.device)
                     < true_len)[None].expand(x.shape[0], -1)
        h, new_state = A.attention_layer(
            p["temporal"]["attn"],
            L.rmsnorm(p["temporal"]["ln"], x, cfg.norm_eps),
            cfg.attn_config(), cache=state, decode=decode, valid=valid)
        x = x + h
    else:
        temporal = p["temporal"]
        if mesh is not None:
            temporal = L.gathered(temporal, mesh.sub("temporal"))
        x, new_state = apply_recurrent_block(temporal, x, cfg,
                                             state=state, true_len=true_len)
    y = L.mlp(p["mlp"], L.rmsnorm(ln_mlp, x, cfg.norm_eps),
              None if mesh is None else mesh.sub("mlp"))
    return x + y, new_state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _layout(cfg: GriffinConfig):
    """(n_super, remainder kinds): (rec, rec, attn) supers + leftovers."""
    plen = len(cfg.pattern)
    n_super = cfg.n_layers // plen
    return n_super, tuple(cfg.pattern[:cfg.n_layers - n_super * plen])


def init_params(cfg: GriffinConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random params with the JAX package's distributions; `generator`
    must live on `device`."""
    dt = _dtype(cfg.param_dtype)
    n_super, rem = _layout(cfg)
    params: Dict[str, Any] = {
        "embed": {"table": L.embed_init((cfg.vocab_size, cfg.d_model),
                                        generator, dtype=dt,
                                        device=device)},
        "ln_f": L.init_rmsnorm(cfg.d_model, dt, device),
        "lm_head": L.dense_init((cfg.vocab_size, cfg.d_model), generator,
                                dtype=dt, device=device),
    }
    if n_super:
        params["supers"] = [
            {f"b{i}": init_temporal_block(kind, cfg, generator, dt, device)
             for i, kind in enumerate(cfg.pattern)}
            for _ in range(n_super)]
    for i, kind in enumerate(rem):
        params[f"rem{i}"] = init_temporal_block(kind, cfg, generator, dt,
                                                device)
    return params


def forward(params, tokens: torch.Tensor, cfg: GriffinConfig, *,
            states=None, decode: bool = False,
            true_len: Optional[int] = None, mesh=None):
    """tokens (B, T) -> (hidden (B, T, d), aux 0, new_states).

    ``true_len`` (serving prefill; a host int): tokens at or past it are
    bucket pads, which every stateful primitive masks so that the state
    carried out equals an exact-length prefill's (up to the scan's
    rounding, module docstring).  A cache-free forward under autograd
    rematerializes each super in its backward when ``remat`` is set, as
    the JAX package's ``jax.checkpoint`` of the scanned super.  `mesh`
    (a `MeshContext`, training on a mesh) reaches the embedding and
    every block (`apply_temporal_block`)."""
    if states is None:
        true_len = None                      # training: no carried state
    x = L.embed_lookup(params["embed"]["table"], tokens, mesh,
                       cfg.d_model).to(
        _dtype(cfg.compute_dtype))
    n_super, rem = _layout(cfg)

    def sub(name):
        return None if mesh is None else mesh.sub(name)

    def apply_super(p, x, st):
        new_st = {} if st is not None else None
        for i, kind in enumerate(cfg.pattern):
            s_i = st[f"b{i}"] if st is not None else None
            x, ns = apply_temporal_block(p[f"b{i}"], x, kind, cfg,
                                         state=s_i, decode=decode,
                                         true_len=true_len,
                                         mesh=sub(f"supers/b{i}"))
            if st is not None:
                new_st[f"b{i}"] = ns
        return x, new_st

    remat = states is None and cfg.remat and torch.is_grad_enabled()
    new_states = {"supers": []} if states is not None else None
    for j in range(n_super):
        p = params["supers"][j]
        if remat:
            x = checkpoint(lambda x_, p_=p: apply_super(p_, x_, None)[0], x,
                           use_reentrant=False)
            continue
        x, nst = apply_super(p, x,
                             states["supers"][j] if states is not None
                             else None)
        if states is not None:
            new_states["supers"].append(nst)
    for i, kind in enumerate(rem):
        st = states[f"rem{i}"] if states is not None else None
        x, ns = apply_temporal_block(params[f"rem{i}"], x, kind, cfg,
                                     state=st, decode=decode,
                                     true_len=true_len, mesh=sub(f"rem{i}"))
        if states is not None:
            new_states[f"rem{i}"] = ns
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), \
        new_states


def init_states(cfg: GriffinConfig, batch: int, dtype=torch.bfloat16,
                device="cpu"):
    """Decode state: the RG-LRU ``h`` and the conv tail of each recurrent
    block, a ring buffer of ``window`` entries for each attention
    block."""
    dr, cw = cfg.resolved_d_rnn, cfg.conv_width - 1

    def block_state(kind):
        if kind == "rec":
            return {"conv": torch.zeros((batch, cw, dr), dtype=dtype,
                                        device=device),
                    "h": torch.zeros((batch, dr), dtype=torch.float32,
                                     device=device)}
        return A.init_local_cache(batch, cfg.window, cfg.attn_config(),
                                  dtype, device)

    n_super, rem = _layout(cfg)
    st: Dict[str, Any] = {"supers": [
        {f"b{i}": block_state(kind) for i, kind in enumerate(cfg.pattern)}
        for _ in range(n_super)]}
    for i, kind in enumerate(rem):
        st[f"rem{i}"] = block_state(kind)
    return st
