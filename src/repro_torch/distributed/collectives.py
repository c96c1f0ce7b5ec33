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
reads of its mesh.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, Tuple

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
    layout; else the body is replicated over "model")."""

    mesh: Any
    rows_axes: Tuple[str, ...]
    rows_over_model: bool = False

    @property
    def model(self) -> int:
        """Ranks along "model" (1 on a mesh without that axis)."""
        return self.mesh.shape.get("model", 1)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Every axis that splits this rank's rows from the others'."""
        return self.rows_axes + (("model",) if self.rows_over_model
                                 and self.model > 1 else ())

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
