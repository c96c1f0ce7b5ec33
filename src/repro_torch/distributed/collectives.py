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
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

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
    return out.movedim(0, dim)


def psum_scatter(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of `x` over the ranks along `axes`, each rank keeping its
    block of dim 0 in axis order (``jax.lax.psum_scatter(...,
    tiled=True)``)."""
    g = mesh.axis_size(axes)
    if g == 1:
        return x
    src = x.contiguous()
    if src.shape[0] % g:
        raise ValueError(f"psum_scatter: dim 0 of size {src.shape[0]} does "
                         f"not split over {g} ranks")
    out = torch.empty((src.shape[0] // g,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    STATS.add(REDUCE_SCATTER, _nbytes(src))
    _SCATTER(out, src, group=mesh.group(axes))
    return out
