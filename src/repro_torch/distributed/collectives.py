"""Collectives along the axes of a `Mesh`: the port's counterparts of
the ``jax.lax`` collectives that the JAX package calls inside
``shard_map`` (``psum``, ``pmax``, ``all_gather(tiled=True)``,
``psum_scatter(tiled=True)``).

Each takes a tensor, the mesh and the axis names, and returns a new
tensor (the input is never written).  Along axes of size 1 a collective
is the identity and runs nothing.  Every call that runs counts itself in
`STATS`: calls and operand bytes by kind, under the names of the
reference's HLO accounting (``all-reduce``, ``all-gather``,
``reduce-scatter``), the operand being what this rank sends into the
collective (an all-gather's local shard, a reduce-scatter's whole
input).  Gloo takes the card's tensors for all four (torch 2.11 on the
H100): nothing is staged by hand.

`enter`, `exit_sum`, `gather_ad`, `scatter_ad` and `block_ad` are the
same collectives under autograd, each with the backward its call site's
cotangent needs (see each docstring); every collective they run, either
way, counts in `STATS` as above.  `MeshContext` is what a model body
reads of its mesh, the edges of its tensor-parallel regions among it.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

ALL_REDUCE, ALL_GATHER, REDUCE_SCATTER = ("all-reduce", "all-gather",
                                          "reduce-scatter")


class CollectiveStats:
    """Calls and operand bytes by kind (the reference's
    ``analysis.hlo.CollectiveStats`` keys)."""

    def __init__(self):
        self.bytes_by_kind: Dict[str, int] = defaultdict(int)
        self.count_by_kind: Dict[str, int] = defaultdict(int)

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] += int(nbytes)
        self.count_by_kind[kind] += 1

    def reset(self) -> None:
        self.bytes_by_kind.clear()
        self.count_by_kind.clear()

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def to_dict(self) -> dict:
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind),
                "total_bytes": self.total_bytes}


STATS = CollectiveStats()


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """What a model body on a mesh needs to know (the counterpart of the
    reference's ``shard`` argument): the mesh, the axes that split the
    batch rows (``rows_axes``: "pod" and "data"), and whether the rows
    are split over "model" too (``rows_over_model``: the 'sharded_sp'
    layout; else the body is replicated over "model").

    ``specs`` maps each param's stacked path (``sharding.rules.
    stacked_path``: "blocks/attn/wq") to the spec over "model" that
    `train.TrainLayout` cut it by, in its per-layer form; a leaf missing
    from it (or every leaf, where ``specs`` is None) is whole.  A layer
    reads its own leaves' specs through `sub` (the context at a subtree)
    and `cut`; ``lead`` leading entries of each spec are dropped (a
    slice of a stacked leaf, as the MTP heads take).

    A tensor-parallel region (Megatron's column-parallel then
    row-parallel pair) takes its input through `region_in` (or, fused
    with its column-parallel products, `column_in`) and leaves through
    `region_out`: with the body replicated over "model", the identity
    with a summed backward, then one all-reduce; with the rows split
    over "model" (Megatron's sequence-parallel form over the batch
    rows), an all-gather of the rows, then one reduce-scatter back to
    this rank's rows.  The ranks' partial outputs (`matmul_f32`) and, in
    `column_in`'s backward, their partial input cotangents are summed in
    f32 and rounded to the activations' dtype once, as one process's
    GEMM rounds its f32 accumulator once: M partials rounded apart
    would move a bf16 body by an ulp where one process's does not."""

    mesh: Any
    rows_axes: Tuple[str, ...]
    rows_over_model: bool = False
    specs: Optional[Mapping[str, tuple]] = dataclasses.field(
        default=None, compare=False, hash=False)
    prefix: str = ""
    lead: int = 0

    @property
    def model(self) -> int:
        """Ranks along "model" (1 on a mesh without that axis)."""
        return self.mesh.shape.get("model", 1)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Every axis that splits this rank's rows from the others'."""
        return self.rows_axes + (("model",) if self.rows_over_model
                                 and self.model > 1 else ())

    @property
    def model_index(self) -> int:
        return self.mesh.axis_index("model") if self.model > 1 else 0

    def sub(self, name: str, lead: int = 0) -> "MeshContext":
        """The context at the subtree `name` (a "/"-joined path below this
        one), `lead` more leading spec entries dropped."""
        return dataclasses.replace(
            self, prefix=f"{self.prefix}/{name}" if self.prefix else name,
            lead=self.lead + lead)

    def spec(self, name: str) -> tuple:
        key = f"{self.prefix}/{name}" if self.prefix else name
        spec = (self.specs or {}).get(key, ())
        return tuple(spec[self.lead:])

    def cut(self, name: str) -> Optional[int]:
        """The dim of leaf `name` that is cut over "model", or None."""
        spec = self.spec(name)
        return spec.index("model") if "model" in spec else None

    def region_in(self, x: torch.Tensor) -> torch.Tensor:
        """`x` (this rank's rows) entering a tensor-parallel region: the
        region's rows, the same on every "model" rank."""
        if self.rows_over_model:
            return gather_ad(x, self.mesh, "model", dim=0, grad="partial")
        return enter(x, self.mesh, "model")

    def column_in(self, x: torch.Tensor, *ws: torch.Tensor):
        """`x` (this rank's rows, (..., d)) entering a region through its
        column-parallel products: ``region_in(x) @ w`` for each `w` (d,
        ...) of this rank's columns.  The backward sums the products'
        input cotangents in f32 before the region's sum over "model"."""
        return _ColumnIn.apply(self, x, *ws)

    def region_out(self, y: torch.Tensor, dtype=None) -> torch.Tensor:
        """The sum over "model" of the ranks' partial outputs `y` of a
        region, on this rank's rows, cast to `dtype` after the sum."""
        if self.rows_over_model:
            y = scatter_ad(y, self.mesh, "model", dim=0)
        else:
            y = exit_sum(y, self.mesh, "model")
        return y if dtype is None else y.to(dtype)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 2-D product ``a @ b`` in f32 without a rounded intermediate: a
    CUDA GEMM of bf16 / fp16 operands keeps its f32 accumulator
    (``out_dtype``); elsewhere the operands are widened first."""
    if a.dtype == b.dtype == torch.float32:
        return a @ b
    if a.is_cuda and a.dtype == b.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``a @ w`` over a's last dim and w's first with an f32 result (the
    partial output of a row-parallel product, summed over "model" in
    f32); the backward, in the operands' dtype, is the product's."""

    @staticmethod
    def forward(ctx, a, w):
        a2, w2 = a.reshape(-1, w.shape[0]), w.reshape(w.shape[0], -1)
        ctx.save_for_backward(a2, w2)
        ctx.shapes = a.shape, w.shape
        return mm_f32(a2, w2).reshape(a.shape[:-1] + w.shape[1:])

    @staticmethod
    def backward(ctx, g):
        a2, w2 = ctx.saved_tensors
        a_shape, w_shape = ctx.shapes
        g2 = g.reshape(a2.shape[0], -1).to(a2.dtype)
        da = (g2 @ w2.t()).reshape(a_shape) if ctx.needs_input_grad[0] \
            else None
        dw = (a2.t() @ g2).reshape(w_shape) if ctx.needs_input_grad[1] \
            else None
        return da, dw


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`_MatmulF32`: a (..., k) times w (k, ...) -> (..., *w.shape[1:])
    in f32."""
    return _MatmulF32.apply(a, w)


class _ColumnIn(torch.autograd.Function):
    """`MeshContext.column_in`: the region's rows (the identity, or an
    all-gather over "model" of rows split over it) times each weight;
    the backward sums every product's input cotangent in f32, sums
    those over "model" (all-reduce, or reduce-scatter back to this
    rank's rows) and rounds once."""

    @staticmethod
    def forward(ctx, mesh, x, *ws):
        xg = all_gather(x, mesh.mesh, "model") if mesh.rows_over_model \
            else x
        x2 = xg.reshape(-1, xg.shape[-1])
        ctx.save_for_backward(x2, *ws)
        ctx.mesh, ctx.xg_shape = mesh, xg.shape
        return tuple((x2 @ w.reshape(w.shape[0], -1)).reshape(
            xg.shape[:-1] + w.shape[1:]) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x2, *ws = ctx.saved_tensors
        mesh = ctx.mesh
        dx, dws = None, []
        for i, (g, w) in enumerate(zip(gs, ws)):
            if g is None:
                dws.append(None)
                continue
            w2 = w.reshape(w.shape[0], -1)
            g2 = g.reshape(x2.shape[0], -1).to(x2.dtype)
            part = mm_f32(g2, w2.t())
            dx = part if dx is None else dx + part
            dws.append((x2.t() @ g2).reshape(w.shape)
                       if ctx.needs_input_grad[2 + i] else None)
        if dx is not None:
            dx = dx.reshape(ctx.xg_shape)
            if mesh.rows_over_model:
                dx = psum_scatter(dx, mesh.mesh, "model")
            else:
                dx = psum(dx, mesh.mesh, "model")
            dx = dx.to(x2.dtype)
        return (None, dx, *dws)


# torch 2.13 renames the two tensor collectives (same ops underneath)
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, mesh, axes, op) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    out = x.contiguous().clone()
    STATS.add(ALL_REDUCE, _nbytes(out))
    dist.all_reduce(out, op=op, group=mesh.group(axes))
    return out


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of `x` over the ranks along `axes`."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise max of `x` over the ranks along `axes`."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` along `axes` concatenated on `dim` in axis order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    g = mesh.axis_size(axes)
    if g == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((g * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    STATS.add(ALL_GATHER, _nbytes(src))
    _GATHER(out, src, group=mesh.group(axes))
    return out.movedim(0, dim).contiguous()


def psum_scatter(x: torch.Tensor, mesh, axes, dim: int = 0
                 ) -> torch.Tensor:
    """The sum of `x` over the ranks along `axes`, each rank keeping its
    block of `dim` in axis order (``jax.lax.psum_scatter(...,
    scatter_dimension=dim, tiled=True)``)."""
    g = mesh.axis_size(axes)
    if g == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % g:
        raise ValueError(f"psum_scatter: dim {dim} of size {src.shape[0]} "
                         f"does not split over {g} ranks")
    out = torch.empty((src.shape[0] // g,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    STATS.add(REDUCE_SCATTER, _nbytes(src))
    _SCATTER(out, src, group=mesh.group(axes))
    return out.movedim(0, dim).contiguous()


def rank_block(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """This rank's block of `dim` along `axes` (no communication)."""
    g = mesh.axis_size(axes)
    if g == 1:
        return x
    if x.shape[dim] % g:
        raise ValueError(f"rank_block: dim {dim} of size {x.shape[dim]} "
                         f"does not split over {g} ranks")
    n = x.shape[dim] // g
    return x.narrow(dim, mesh.axis_index(axes) * n, n).contiguous()


# ---------------------------------------------------------------------------
# differentiable collectives: the edges of a region whose ranks compute
# different parts of one function (the reference's shard_map bodies).
# Each backward is stated for the cotangent it receives, which is either
# "partial" (each rank holds a summand of the true cotangent) or
# "replicated" (every rank holds the whole true cotangent).
# ---------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
    """Identity forward; backward sums the ranks' partial cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes), None, None


class _Exit(torch.autograd.Function):
    """Sum forward; identity backward (the cotangent of the sum is
    replicated over the axes, and is each summand's cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    """All-gather forward; backward reduce-scatters partial cotangents,
    or takes this rank's block of replicated ones."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        ctx.mesh, ctx.axes, ctx.dim, ctx.grad = mesh, axes, dim, grad
        return all_gather(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "partial":
            dx = psum_scatter(g, ctx.mesh, ctx.axes, dim=ctx.dim)
        else:
            dx = rank_block(g, ctx.mesh, ctx.axes, dim=ctx.dim)
        return dx, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter forward; all-gather backward (each rank's block of
    the sum has its own cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return psum_scatter(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, dim=ctx.dim), None, None, \
            None


class _RankBlock(torch.autograd.Function):
    """This rank's block of a replicated tensor; backward all-gathers the
    blocks' cotangents into the whole one (replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return rank_block(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, dim=ctx.dim), None, None, \
            None


def enter(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """`x`, replicated over `axes`, entering a region whose ranks each use
    it for a part of the result: the backward psums their partial
    cotangents (Megatron's copy-to-region)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _Enter.apply(x, mesh, axes)


def exit_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of the ranks' parts `x` over `axes`, leaving a region: the
    result is replicated, so its cotangent is, and the backward passes it
    on as it is (Megatron's reduce-from-region).  Also the all-reduce of
    a global mean's partial sums: summing the cotangent again would count
    it once per rank."""
    if mesh.axis_size(axes) == 1:
        return x
    return _Exit.apply(x, mesh, axes)


def gather_ad(x: torch.Tensor, mesh, axes, dim: int = 0, *,
              grad: str) -> torch.Tensor:
    """`all_gather` under autograd.  ``grad='partial'``: the gathered
    tensor feeds a part of the result on each rank, and the backward
    reduce-scatters the cotangents; ``grad='replicated'``: every rank
    holds the whole cotangent, and the backward takes its block."""
    if grad not in ("partial", "replicated"):
        raise ValueError(f"grad must be 'partial' or 'replicated', got "
                         f"{grad!r}")
    if mesh.axis_size(axes) == 1:
        return x
    return _AllGather.apply(x, mesh, axes, dim, grad)


def scatter_ad(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """`psum_scatter` under autograd (all-gather backward)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim)


def block_ad(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """`rank_block` of a replicated tensor under autograd (all-gather
    backward)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _RankBlock.apply(x, mesh, axes, dim)
