"""Shared neural-net layers (plain functions on tensors, dict params).

Conventions, as in `repro.models.layers`:
  * params are nested dicts of tensors; every layer has
    `init_<layer>(...) -> params` and `<layer>(params, x, ...)`;
  * computation dtype follows the input; normalization statistics and
    softmax-like reductions run in f32;
  * weight layouts are the JAX package's, so weights copy over as they are
    (`repro_torch.weights`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers (same distributions as the JAX package; not the same bits)
# ---------------------------------------------------------------------------


def dense_init(shape, generator: torch.Generator, *, scale: float = 1.0,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Truncated-normal fan-in init (stddev = scale / sqrt(fan_in))."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (scale / math.sqrt(fan_in))).to(dtype)


def embed_init(shape, generator: torch.Generator, *, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (t * 0.02).to(dtype)


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``, ids clamped; under autograd an id past the table
    passes no gradient, as the transpose of JAX's gather drops it."""
    ids = tokens.long()
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    if torch.is_grad_enabled() and table.requires_grad:
        rows = torch.where((ids < table.shape[0])[..., None], rows,
                           rows.detach())
    return rows


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, mesh=None,
                 d_model: int = 0) -> torch.Tensor:
    """``table[tokens]`` with ids clamped into ``[0, V)``, as JAX's gather
    clamps (an out-of-range index would be a device-side assert here),
    and, as its transpose, no gradient from an id past the table.
    Out-of-range ids reach this point from free slots, whose fed-back
    token may be a padded-vocab id or the sampler's id for a NaN row.

    On a mesh (`mesh`, a `MeshContext`, with the model width `d_model`)
    whose "model" size M > 1 divides d, `table` is this rank's (V, d/M)
    column block (the reference's ``(None, "model")`` table): the lookup
    is local and its rows are all-gathered along d, so the body gets the
    whole width.  Rows replicated over "model": the backward takes this
    rank's columns of the (replicated) cotangent, with no communication.
    Rows split over "model": the ids are all-gathered first, and this
    rank's rows taken from the whole lookup; the backward gathers the
    rows' cotangents and takes this rank's columns.  Where M does not
    divide d the table is whole, as in the reference; a table cut for
    the other case raises."""
    split = mesh is not None and mesh.model > 1 and d_model % mesh.model == 0
    if mesh is not None and table.shape[1] != (
            d_model // mesh.model if split else d_model):
        raise ValueError(
            f"embed_lookup: a table of {table.shape[1]} columns where the "
            f"{'d-sharded' if split else 'whole-table'} lookup of d "
            f"{d_model} over model = {mesh.model} needs "
            f"{d_model // mesh.model if split else d_model}")
    if not split:
        return _lookup(table, tokens)
    from repro_torch.distributed import collectives as C
    m = mesh.mesh
    if mesh.rows_over_model:
        tokens = C.all_gather(tokens, m, "model")
    out = C.gather_ad(_lookup(table, tokens), m, "model", dim=-1,
                      grad="replicated")
    if mesh.rows_over_model:
        out = C.block_ad(out, m, "model")
    return out


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def init_rmsnorm(dim, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS over the head dim of (..., heads, head_dim)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """(..., T) int positions -> cos/sin of shape (..., T, head_dim//2)."""
    half = head_dim // 2
    # a Python-scalar base: a tensor built from `theta` on the card would
    # be a host-to-device copy, which synchronizes every layer
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, heads, head_dim); cos/sin: (..., T, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(d_model, d_ff, generator: torch.Generator, *,
             gated: bool = True, bias: bool = False, n_layers_scale=1,
             dtype=torch.float32, device="cpu"):
    """SwiGLU (gated) or GeLU MLP params; ``bias`` adds ``bi`` (d_ff,)
    and ``bo`` (d_model,), zeros."""
    out_scale = 1.0 / math.sqrt(2.0 * max(n_layers_scale, 1))
    kw = dict(dtype=dtype, device=device)
    p = {
        "wi": dense_init((d_model, d_ff), generator, **kw),
        "wo": dense_init((d_ff, d_model), generator, scale=out_scale, **kw),
    }
    if gated:
        p["wg"] = dense_init((d_model, d_ff), generator, **kw)
    if bias:
        p["bi"] = torch.zeros((d_ff,), **kw)
        p["bo"] = torch.zeros((d_model,), **kw)
    return p


def mlp(params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Gated SiLU MLP ``(silu(x @ wg) * (x @ wi)) @ wo`` or, without
    ``wg``, ``gelu(x @ wi + bi) @ wo + bo``; the activation in f32, the
    GeLU in its tanh form (JAX's ``jax.nn.gelu`` default), the biases
    added in the input dtype.

    On a mesh (`mesh`, a `MeshContext` at the MLP's subtree) whose
    layout cut ``wi`` by ffn, the MLP is one tensor-parallel region
    (Megatron): ``wi`` / ``wg`` / ``bi`` column-parallel, ``wo``
    row-parallel, one sum over "model" at the exit, ``bo`` added once
    after it.  Otherwise its leaves are gathered at use (`gathered`)."""
    if mesh is not None and mlp_split(mesh):
        out = mesh.region_out(mlp_part(params, x, mesh), x.dtype)
        return out + params["bo"] if "bo" in params else out
    if mesh is not None:
        params = gathered(params, mesh)
    out = _mlp_act(x @ params["wi"], x @ params["wg"] if "wg" in params
                   else None, params.get("bi"), x.dtype) @ params["wo"]
    if "bo" in params:
        out = out + params["bo"]
    return out


def _mlp_act(up, gate, bi, dtype):
    """The MLP's activation from its up (and gate) products: the bias
    added in the input dtype, SiLU / GeLU in f32."""
    if bi is not None:
        up = up + bi
    if gate is not None:
        return F.silu(gate.float()).to(dtype) * up
    return F.gelu(up.float(), approximate="tanh").to(dtype)


def mlp_split(mesh) -> bool:
    """Whether `mlp` runs tensor-parallel: the layout cut ``wi`` by ffn."""
    return mesh.model > 1 and mesh.cut("wi") == 1


def mlp_part(params, x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's partial output (f32, no ``bo``) of a tensor-parallel
    MLP on the region's rows, from this rank's rows `x`: its ffn block of
    ``wi`` / ``wg`` / ``bi`` (column-parallel, `MeshContext.column_in`)
    and the rows of ``wo`` that match them (row-parallel,
    `collectives.matmul_f32`)."""
    from repro_torch.distributed import collectives as C
    gated = "wg" in params
    outs = mesh.column_in(x, *[tp_block(params, n, 1, mesh) for n in
                               (("wi", "wg") if gated else ("wi",))])
    bi = tp_block(params, "bi", 0, mesh) if "bi" in params else None
    act = _mlp_act(outs[0], outs[1] if gated else None, bi, x.dtype)
    return C.matmul_f32(act, tp_block(params, "wo", 0, mesh))


# ---------------------------------------------------------------------------
# leaves on a mesh: gathered at use, or this rank's block in a region
# ---------------------------------------------------------------------------


def gathered_leaf(t: torch.Tensor, name: str, mesh, inside: bool = False
                  ) -> torch.Tensor:
    """Leaf `name` of `mesh`'s subtree whole: all-gathered along its cut
    dim (`collectives.gather_ad`), or as it is where it is whole.  Its
    backward leaves this rank's block of the gradient summed over the
    axes on which the ranks saw different rows: outside a
    tensor-parallel region (``inside=False``) that is "model" only where
    the rows are split over it; inside one every "model" rank uses the
    whole leaf for its own part of the region, so the parts are summed
    over "model" (a whole leaf there takes `collectives.enter`, unless
    the rows are split over "model", whose whole-leaf gradients the
    train step sums over it already)."""
    from repro_torch.distributed import collectives as C
    dim = mesh.cut(name)
    if dim is None:
        if inside and not mesh.rows_over_model:
            return C.enter(t, mesh.mesh, "model")
        return t
    grad = "partial" if inside or mesh.rows_over_model else "replicated"
    return C.gather_ad(t, mesh.mesh, "model", dim=dim, grad=grad)


def gathered(tree, mesh, inside: bool = False):
    """Every leaf of the param subtree `tree` (at `mesh`'s prefix) whole
    (`gathered_leaf`): the leaves whose cut does not line up with a
    tensor-parallel region (griffin's recurrent block, xlstm's cells,
    the norm scales, attention heads that M does not divide)."""
    return {k: gathered(v, mesh.sub(k), inside) if isinstance(v, dict)
            else gathered_leaf(v, k, mesh, inside) for k, v in tree.items()}


def tp_block(params, name: str, dim: int, mesh, index=None
             ) -> torch.Tensor:
    """This rank's block of leaf `name` along `dim` inside a
    tensor-parallel region: the leaf itself where the layout cut it
    there, else the block (or the rows `index`, a list) of the whole
    leaf (`gathered_leaf` inside the region)."""
    t = params[name]
    if index is None and mesh.cut(name) == dim:
        return t
    whole = gathered_leaf(t, name, mesh, inside=True)
    if index is not None:
        return whole.index_select(dim, torch.tensor(index,
                                                    device=whole.device))
    n = whole.shape[dim] // mesh.model
    return whole.narrow(dim, mesh.model_index * n, n)


# ---------------------------------------------------------------------------
# causal depthwise conv (Griffin's temporal conv)
# ---------------------------------------------------------------------------


def init_causal_conv(dim, generator: torch.Generator, width: int = 4, *,
                     dtype=torch.float32, device="cpu"):
    """``w (width, dim)`` with the reference's fan-in of ``shape[0]``
    (std 1/sqrt(width)), ``b (dim,)`` zeros."""
    return {
        "w": dense_init((width, dim), generator, dtype=dtype, device=device),
        "b": torch.zeros((dim,), dtype=dtype, device=device),
    }


def causal_conv(params, x: torch.Tensor, state=None):
    """Depthwise causal 1D conv over x (B, T, D): returns (y, new_state),
    `state` being the last (width - 1) inputs of the previous segment
    (zeros when None).

    Each product and each partial sum rounds to the input dtype in turn,
    as the reference's Python ``sum`` over the taps does: in bf16 this
    is what the JAX package computes bit for bit, where an f32 sum
    rounded once is not."""
    w = params["w"]
    width = w.shape[0]
    t = x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1) + tuple(x.shape[2:]))
    xx = torch.cat([state, x], dim=1)                  # (B, T+w-1, D)
    y = xx[:, 0:t] * w[0]
    for i in range(1, width):
        y = y + xx[:, i:i + t] * w[i]
    y = y + params["b"]
    new_state = xx[:, t:] if width > 1 else state
    return y.to(x.dtype), new_state


def conv_state_at(prev_state: torch.Tensor, x: torch.Tensor,
                  true_len: int) -> torch.Tensor:
    """The conv carry as if only the first `true_len` steps of x had been
    consumed (a bucket-padded prefill): the (width - 1) inputs ending at
    position ``true_len - 1`` of ``[prev_state; x]``, which reach back
    into `prev_state` when ``true_len < width - 1``.  `true_len` is a
    host int."""
    xx = torch.cat([prev_state, x.to(prev_state.dtype)], dim=1)
    w1 = prev_state.shape[1]
    return xx[:, true_len:true_len + w1]
