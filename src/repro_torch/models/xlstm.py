"""xLSTM (arXiv:2405.04517): alternating sLSTM / mLSTM blocks (port of
`repro.models.xlstm`).

mLSTM: a matrix memory ``C`` with an exponential input gate and a
log-space max-stabilizer ``m``.  Training and every longer prefill run
the chunkwise-parallel form (`mlstm_chunkwise`: a Python loop over chunks
carrying ``(C, n, m)``, batched products inside a chunk); a stateful
forward of at most `SEQ_MAX_T` tokens (decode, and every single-token
verify forward of speculative decoding) steps token by token
(`mlstm_sequential`), as the reference does, so that the two packages
pick the same arithmetic for the same call.

sLSTM: a scalar memory with per-head (block-diagonal) recurrent matrices
on ``h``: inherently sequential, a Python loop over time whose four
recurrent products are one batched product a step.

None of this is a Pallas kernel in the JAX package (``jax.lax.scan``,
``jnp.einsum``), so all of it is plain PyTorch here.

Params keep the JAX package's layout, with its layer-stacked ``pairs``
(``scan_layers=True``: (n_pairs, ...) leaves of ``{'slstm', 'mlstm'}``)
unstacked into a list of per-pair dicts, as the transformer's
``blocks``.  The serve state is a per-pair list of ``{'slstm': {'conv'
(B, w-1, d), 'cell': [h, c, n, m] (B, nh, d/nh)}, 'mlstm': {'conv' (B,
w-1, 2d), 'cell': [C (B, nh, hd, hd), n (B, nh, hd), m (B, nh)]}}``, the
batch axis first, f32 throughout whatever the model's dtype (the
reference's ``init_states`` default; a served conv thus sums its taps in
f32 where the cache-free forward rounds them in the model's dtype).  A
forward returns NEW tensors for every state leaf and never writes the
old ones: the snapshots of the ``'scan'`` speculative rollback share
them (`registry.snapshot_caches`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L

# a stateful forward of at most this many tokens steps the mLSTM token by
# token (the reference's threshold)
SEQ_MAX_T = 4
# the chunkwise mLSTM's tail pad steps: no input, the state kept (the
# reference's constants; log_sigmoid(30) = -9.4e-14, so not exact no-ops)
_PAD_IGATE = -1e30
_PAD_FGATE = 30.0
_FORGET_BIAS = 3.0
_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    name: str
    d_model: int
    n_layers: int               # total blocks; alternating sLSTM, mLSTM
    num_heads: int
    vocab_size: int
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_width: int = 4
    chunk: int = 128            # mLSTM chunk length
    norm_eps: float = 1e-6
    scan_layers: bool = True
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # the serving plumbing's fields, which the JAX package reads through
    # getattr defaults: no softcap, no frontend, nothing paged
    logit_softcap: Optional[float] = None
    frontend_len: int = 0
    paged_impl: str = "kernel"

    @property
    def d_inner_m(self) -> int:
        return int(self.d_model * self.mlstm_proj_factor)

    @property
    def d_inner_s(self) -> int:
        d = int(self.d_model * self.slstm_proj_factor)
        return -(-d // 8) * 8

    @property
    def head_dim_m(self) -> int:
        return self.d_inner_m // self.num_heads


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _neg_inf_to_zero(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isneginf(m), 0.0, m)


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------


def _mlstm_zero_state(b, h, d, device):
    f32 = torch.float32
    return (torch.zeros((b, h, d, d), dtype=f32, device=device),
            torch.zeros((b, h, d), dtype=f32, device=device),
            torch.full((b, h), -_INF, dtype=f32, device=device))


def mlstm_sequential(q, k, v, igate, fgate, state=None):
    """Step-by-step mLSTM (the decode path and the oracle).

    q, k, v (B, T, H, D); igate / fgate (B, T, H) pre-activations; state
    ``(C (B, H, D, D), n (B, H, D), m (B, H))`` or None.  Returns (h (B,
    T, H, D) f32, state')."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    c_, n_, m_ = state if state is not None else _mlstm_zero_state(
        b, h, d, q.device)
    q32, k32, v32 = q.float() * scale, k.float(), v.float()
    ig, fg = igate.float(), fgate.float()
    hs = []
    for s in range(t):
        qt, kt, vt = q32[:, s], k32[:, s], v32[:, s]
        lf = F.logsigmoid(fg[:, s])
        m_new = torch.maximum(lf + m_, ig[:, s])
        m_safe = _neg_inf_to_zero(m_new)
        f_ = torch.exp(lf + m_ - m_safe)
        i_ = torch.exp(ig[:, s] - m_safe)
        c_ = f_[..., None, None] * c_ + i_[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n_ = f_[..., None] * n_ + i_[..., None] * kt
        num = (qt[..., None, :] @ c_)[..., 0, :]
        den = torch.maximum(torch.abs((qt * n_).sum(-1)),
                            torch.exp(-m_safe))
        hs.append(num / den[..., None])
        m_ = m_new
    return torch.stack(hs, 1), (c_, n_, m_)


def mlstm_chunkwise(q, k, v, igate, fgate, chunk: int, state=None):
    """Chunkwise-parallel mLSTM (training and longer prefills): the same
    semantics as `mlstm_sequential`.  Chunks of ``min(chunk, T)`` steps;
    the tail pads with `_PAD_IGATE` / `_PAD_FGATE` gates.  Inside a chunk
    everything runs head-major, (B, H, L, ...)."""
    b, t, h, d = q.shape
    lc = min(chunk, t)
    pad = (-t) % lc
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        igate = F.pad(igate, (0, 0, 0, pad), value=_PAD_IGATE)
        fgate = F.pad(fgate, (0, 0, 0, pad), value=_PAD_FGATE)
    tp = q.shape[1]
    scale = 1.0 / math.sqrt(d)
    qh = (q.float() * scale).transpose(1, 2)         # (B, H, Tp, D)
    kh, vh = k.float().transpose(1, 2), v.float().transpose(1, 2)
    ig, fg = igate.float().transpose(1, 2), fgate.float().transpose(1, 2)
    c0, n0, m0 = state if state is not None else _mlstm_zero_state(
        b, h, d, q.device)
    tri = torch.ones((lc, lc), dtype=torch.bool, device=q.device).tril()
    outs = []
    for j in range(0, tp, lc):
        qc, kc, vc = qh[:, :, j:j + lc], kh[:, :, j:j + lc], vh[:, :, j:j + lc]
        ic, fc = ig[:, :, j:j + lc], fg[:, :, j:j + lc]      # (B, H, L)
        bcum = torch.cumsum(F.logsigmoid(fc), -1)            # b_t
        btot = bcum[..., -1:]
        # stabilizers: intra-chunk, then against the carried state
        m_loc = torch.cummax(ic - bcum, -1).values + bcum
        m0e = m0[..., None]
        m_safe = _neg_inf_to_zero(torch.maximum(bcum + m0e, m_loc))
        # decay D_ts = exp(b_t - b_s + i_s - m_t) for s <= t
        log_d = (bcum[..., :, None] - bcum[..., None, :] + ic[..., None, :]
                 - m_safe[..., :, None])
        log_d = torch.where(tri, log_d, -_INF)
        s_w = (qc @ kc.transpose(-1, -2)) * torch.exp(log_d)
        inter = torch.exp(bcum + m0e - m_safe)               # (B, H, L)
        num = s_w @ vc + (qc @ c0) * inter[..., None]
        den = s_w.sum(-1) + (qc @ n0[..., None])[..., 0] * inter
        den = torch.maximum(torch.abs(den), torch.exp(-m_safe))
        outs.append(num / den[..., None])
        # the state at the chunk's end
        g_s = btot - bcum                                    # B - b_s
        m_new = torch.maximum(btot[..., 0] + m0, torch.amax(ic + g_s, -1))
        m_ns = _neg_inf_to_zero(m_new)
        kw = kc * torch.exp(ic + g_s - m_ns[..., None])[..., None]
        carry = torch.exp(btot[..., 0] + m0 - m_ns)          # (B, H)
        c0 = carry[..., None, None] * c0 + kw.transpose(-1, -2) @ vc
        n0 = carry[..., None] * n0 + kw.sum(-2)
        m0 = m_new
    hout = torch.cat(outs, 2).transpose(1, 2)[:, :t]
    return hout, (c0, n0, m0)


# ---------------------------------------------------------------------------
# sLSTM cell
# ---------------------------------------------------------------------------


def slstm_sequential(xi, xf, xz, xo, r_params, state=None, valid=None):
    """sLSTM with per-head recurrent matrices.

    xi / xf / xz / xo (B, T, H, D) input pre-activations, kept in their
    dtype and upcast a step at a time; `r_params` ``'ri', 'rf', 'rz',
    'ro'`` each (H, D, D), cast to f32 once (exact); state ``(h, c, n,
    m)`` each (B, H, D) f32, or None.  ``valid`` (B or 1, T) masks the
    bucket-pad tail steps of a padded prefill: an invalid step carries
    every state component through unchanged (an exact select: ``h``
    feeds the recurrent products).  Returns (h (B, T, H, D) f32,
    state')."""
    b, t, nh, d = xi.shape
    if state is None:
        z = torch.zeros((b, nh, d), dtype=torch.float32, device=xi.device)
        state = (z, z, z, torch.full_like(z, -_INF))
    # inside the loop everything is head-major (H, B, ...): the four
    # recurrent products are one (H, B, D) x (H, D, 4D) product a step
    h_, c_, n_, m_ = (s.transpose(0, 1) for s in state)
    r = torch.cat([r_params[n].float() for n in ("ri", "rf", "rz", "ro")],
                  dim=-1)                                   # (H, D, 4D)
    x4 = torch.stack([xi, xf, xz, xo], 3).permute(1, 2, 0, 3, 4) \
        .contiguous()                                       # (T, H, B, 4, D)
    keep = None
    if valid is not None:
        keep = valid.expand(b, t).T[:, None, :, None].contiguous()
    hs = []
    for s in range(t):
        g = torch.bmm(h_, r).view(nh, b, 4, d) + x4[s]
        it, ft = g[:, :, 0], g[:, :, 1]
        zt, ot = torch.tanh(g[:, :, 2]), torch.sigmoid(g[:, :, 3])
        lf_m = F.logsigmoid(ft) + m_
        m_new = torch.maximum(lf_m, it)
        m_safe = _neg_inf_to_zero(m_new)
        i_ = torch.exp(it - m_safe)
        f_ = torch.exp(lf_m - m_safe)
        c_new = f_ * c_ + i_ * zt
        n_new = f_ * n_ + i_
        h_new = ot * c_new / torch.clamp_min(n_new, 1e-6)
        if keep is not None:
            k_s = keep[s]
            h_new = torch.where(k_s, h_new, h_)
            c_new = torch.where(k_s, c_new, c_)
            n_new = torch.where(k_s, n_new, n_)
            m_new = torch.where(k_s, m_new, m_)
        h_, c_, n_, m_ = h_new, c_new, n_new, m_new
        hs.append(h_new)
    out = torch.stack(hs, 0).permute(2, 0, 1, 3)           # (B, T, H, D)
    return out, tuple(s.transpose(0, 1) for s in (h_, c_, n_, m_))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_mlstm_block(cfg: XLSTMConfig, generator: torch.Generator, dtype,
                     device="cpu"):
    d, di, nh = cfg.d_model, cfg.d_inner_m, cfg.num_heads
    kw = dict(dtype=dtype, device=device)
    return {
        "ln": L.init_rmsnorm(d, dtype, device),
        "w_up": L.dense_init((d, 2 * di), generator, **kw),
        "conv": L.init_causal_conv(di, generator, cfg.conv_width, **kw),
        "wq": L.dense_init((di, di), generator, **kw),
        "wk": L.dense_init((di, di), generator, **kw),
        "wv": L.dense_init((di, di), generator, **kw),
        "w_gates": L.dense_init((di, 2 * nh), generator, **kw),
        "gn": L.init_rmsnorm(cfg.head_dim_m, dtype, device),
        "w_down": L.dense_init((di, d), generator,
                               scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def _valid_steps(x, state, true_len):
    """(1, T) bool of the real steps of a bucket-padded prefill, or None
    when nothing is padded (masking would then change nothing)."""
    t = x.shape[1]
    if true_len is None or state is None or true_len >= t:
        return None
    return (torch.arange(t, device=x.device) < true_len)[None]


def _write_state(state, conv_state, cell):
    """Write a block's new serve state into the tensors of `state`, in
    place, and return `state`'s tensors: the caches are updated as the
    reference's donated ones are, so the old and the new state are never
    live together past the step (`registry.snapshot_caches` copies them
    for the ``'scan'`` rollback)."""
    state["conv"].copy_(conv_state)
    for old, new in zip(state["cell"], cell):
        old.copy_(new)
    return {"conv": state["conv"], "cell": list(state["cell"])}


def apply_mlstm_block(p, x, cfg: XLSTMConfig, state=None,
                      true_len: Optional[int] = None):
    """state: None (training) or ``{'conv', 'cell'}`` (serving).

    ``true_len`` (a padded prefill's host int): the pad steps' gates
    become no-ops, ``i = exp(-inf) = 0`` and ``log f = log_sigmoid(+inf)
    = 0``, which carries ``(C, n, m)`` through exactly; the pad rows'
    outputs are garbage and unused."""
    b, t, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim_m
    xin = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    u, z = (xin @ p["w_up"]).chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    uc, conv_state = L.causal_conv(p["conv"], u, conv_state)
    uc = F.silu(uc.float()).to(x.dtype)
    q = (uc @ p["wq"]).reshape(b, t, nh, hd)
    k = (uc @ p["wk"]).reshape(b, t, nh, hd)
    v = (u @ p["wv"]).reshape(b, t, nh, hd)
    gates = (uc @ p["w_gates"]).float()
    igate, fgate = gates[..., :nh], gates[..., nh:] + _FORGET_BIAS
    valid = _valid_steps(x, state, true_len)
    if valid is not None:
        igate = torch.where(valid[..., None], igate, -_INF)
        fgate = torch.where(valid[..., None], fgate, _INF)
        conv_state = L.conv_state_at(state["conv"], u, true_len)
    cell = tuple(state["cell"]) if state is not None else None
    if state is not None and t <= SEQ_MAX_T:
        h, cell = mlstm_sequential(q, k, v, igate, fgate, cell)
    else:
        h, cell = mlstm_chunkwise(q, k, v, igate, fgate, cfg.chunk, cell)
    h = L.rmsnorm(p["gn"], h.to(x.dtype), cfg.norm_eps)    # per head
    h = h.reshape(b, t, nh * hd)
    out = (h * F.silu(z.float()).to(x.dtype)) @ p["w_down"]
    new_state = (_write_state(state, conv_state, cell)
                 if state is not None else None)
    return x + out, new_state


def init_slstm_block(cfg: XLSTMConfig, generator: torch.Generator, dtype,
                     device="cpu"):
    """The recurrent matrices (nh, hd, hd) take the reference's fan-in of
    ``shape[0]``: std 1/sqrt(nh), not 1/sqrt(hd)."""
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    kw = dict(dtype=dtype, device=device)
    return {
        "ln": L.init_rmsnorm(d, dtype, device),
        "conv": L.init_causal_conv(d, generator, cfg.conv_width, **kw),
        "w_ifzo": L.dense_init((d, 4 * d), generator, **kw),
        "ri": L.dense_init((nh, hd, hd), generator, **kw),
        "rf": L.dense_init((nh, hd, hd), generator, **kw),
        "rz": L.dense_init((nh, hd, hd), generator, **kw),
        "ro": L.dense_init((nh, hd, hd), generator, **kw),
        "gn": L.init_rmsnorm(hd, dtype, device),
        "mlp": L.init_mlp(d, cfg.d_inner_s, generator,
                          n_layers_scale=cfg.n_layers, **kw),
        "ln_mlp": L.init_rmsnorm(d, dtype, device),
    }


def apply_slstm_block(p, x, cfg: XLSTMConfig, state=None,
                      true_len: Optional[int] = None, mlp_mesh=None):
    """The forget bias is added in the model's dtype, before the cell's
    per-step upcast (as the reference).  `mlp_mesh` (a `MeshContext` at
    the MLP's subtree) runs the MLP as a tensor-parallel region."""
    b, t, d = x.shape
    nh = cfg.num_heads
    xin = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    conv_state = state["conv"] if state is not None else None
    xc, conv_state = L.causal_conv(p["conv"], xin, conv_state)
    xc = F.silu(xc.float()).to(x.dtype)
    xi, xf, xz, xo = (a.reshape(b, t, nh, d // nh)
                      for a in (xc @ p["w_ifzo"]).chunk(4, dim=-1))
    valid = _valid_steps(x, state, true_len)
    if valid is not None:
        conv_state = L.conv_state_at(state["conv"], xin, true_len)
    cell = tuple(state["cell"]) if state is not None else None
    h, cell = slstm_sequential(
        xi, xf + _FORGET_BIAS, xz, xo,
        {n: p[n] for n in ("ri", "rf", "rz", "ro")}, cell, valid=valid)
    h = L.rmsnorm(p["gn"], h.to(x.dtype), cfg.norm_eps)
    x = x + h.reshape(b, t, d)
    x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps),
                  mlp_mesh)
    new_state = (_write_state(state, conv_state, cell)
                 if state is not None else None)
    return x, new_state


# ---------------------------------------------------------------------------
# full model: embedding -> [sLSTM, mLSTM] * (L/2) -> norm
# ---------------------------------------------------------------------------


def init_params(cfg: XLSTMConfig, generator: torch.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random params with the JAX package's distributions; `generator`
    must live on `device`."""
    dt = _dtype(cfg.param_dtype)
    return {
        "embed": {"table": L.embed_init((cfg.vocab_size, cfg.d_model),
                                        generator, dtype=dt, device=device)},
        "pairs": [{"slstm": init_slstm_block(cfg, generator, dt, device),
                   "mlstm": init_mlstm_block(cfg, generator, dt, device)}
                  for _ in range(cfg.n_layers // 2)],
        "ln_f": L.init_rmsnorm(cfg.d_model, dt, device),
        "lm_head": L.dense_init((cfg.vocab_size, cfg.d_model), generator,
                                dtype=dt, device=device),
    }


def _apply_pair(p, x, cfg: XLSTMConfig, st=None, true_len=None,
                mesh=None):
    """An (sLSTM, mLSTM) pair.  `mesh` (a `MeshContext` at the pairs'
    subtree, training on a mesh): the sLSTM block's MLP runs as a
    tensor-parallel region; every other leaf is gathered at use and
    every rank runs the whole recurrences."""
    ps, pm, mlp_mesh = p["slstm"], p["mlstm"], None
    if mesh is not None:
        smesh = mesh.sub("slstm")
        ps = dict(L.gathered({k: v for k, v in ps.items() if k != "mlp"},
                             smesh), mlp=ps["mlp"])
        pm, mlp_mesh = L.gathered(pm, mesh.sub("mlstm")), smesh.sub("mlp")
    x, s_st = apply_slstm_block(ps, x, cfg,
                                st["slstm"] if st is not None else None,
                                true_len=true_len, mlp_mesh=mlp_mesh)
    x, m_st = apply_mlstm_block(pm, x, cfg,
                                st["mlstm"] if st is not None else None,
                                true_len=true_len)
    return x, ({"slstm": s_st, "mlstm": m_st} if st is not None else None)


def forward(params, tokens: torch.Tensor, cfg: XLSTMConfig, *,
            states=None, decode: bool = False,
            true_len: Optional[int] = None, mesh=None):
    """tokens (B, T) -> (hidden (B, T, d), aux 0, new_states).

    The recurrent state consumes the tokens one after another whatever T
    is, so `decode` changes nothing.  ``true_len`` (a serving prefill's
    host int): tokens at or past it are bucket pads, which every
    stateful primitive masks.  A cache-free forward under autograd
    rematerializes each pair in its backward when ``remat`` is set, as
    the JAX package's ``jax.checkpoint`` of the scanned pair.  `mesh`
    (a `MeshContext`, training on a mesh) reaches the embedding and
    every pair (`_apply_pair`)."""
    del decode
    if states is None:
        true_len = None                      # training: no carried state
    x = L.embed_lookup(params["embed"]["table"], tokens, mesh,
                       cfg.d_model).to(
        _dtype(cfg.compute_dtype))
    remat = states is None and cfg.remat and torch.is_grad_enabled()
    new_states = [] if states is not None else None
    pairs = None if mesh is None else mesh.sub("pairs")
    for i, p in enumerate(params["pairs"]):
        if remat:
            x = checkpoint(lambda x_, p_=p: _apply_pair(
                p_, x_, cfg, mesh=pairs)[0], x, use_reentrant=False)
            continue
        x, st = _apply_pair(p, x, cfg,
                            states[i] if states is not None else None,
                            true_len, mesh=pairs)
        if states is not None:
            new_states.append(st)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), \
        new_states


def init_states(cfg: XLSTMConfig, batch: int, device="cpu"):
    """The recurrent state of `batch` slots (constant size in T), f32
    whatever the model's dtype, as the reference's (its serving calls
    ``init_states`` with the default dtype)."""
    nh, hdm = cfg.num_heads, cfg.head_dim_m
    d, di = cfg.d_model, cfg.d_inner_m
    hds, cw = d // nh, cfg.conv_width - 1

    def zeros(*shape):
        return torch.zeros((batch,) + shape, dtype=torch.float32,
                           device=device)

    def neg_inf(*shape):
        return torch.full((batch,) + shape, -_INF, dtype=torch.float32,
                          device=device)

    return [{
        "slstm": {"conv": zeros(cw, d),
                  "cell": [zeros(nh, hds), zeros(nh, hds), zeros(nh, hds),
                           neg_inf(nh, hds)]},
        "mlstm": {"conv": zeros(cw, di),
                  "cell": [zeros(nh, hdm, hdm), zeros(nh, hdm),
                           neg_inf(nh)]},
    } for _ in range(cfg.n_layers // 2)]
