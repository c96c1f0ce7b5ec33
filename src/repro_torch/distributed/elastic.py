"""Elastic resharding across mesh shapes (port of
`repro.distributed.elastic`).

A tree's leaves are laid out by specs (`sharding.rules`: one entry a
dim, each rank holding its block).  `reshard` moves a tree from one mesh
to another over the same world: it gathers every leaf by its old spec,
then slices this rank's block by the new one.  The checkpoint path does
the same across restarts (`train.loop.resume_or_init` with a layout):
the whole state is restored, then sliced.  `plan_batch` derives the
per-rank batch under a (resized) mesh, so the global batch, and with it
the optimizer's trajectory, stays what it was.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.distributed import collectives as C
from repro_torch.sharding.rules import AxisRules, param_specs, spec_shard


def shard_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `x` under `spec` (a
    contiguous copy)."""
    for dim, (start, length) in enumerate(spec_shard(spec, x.shape, mesh)):
        if length != x.shape[dim]:
            x = x.narrow(dim, start, length)
    return x.contiguous().clone()


def gather_tensor(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block `x` under `spec`
    (all-gathers along each sharded dim, the same result on every
    rank)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = C.all_gather(x, mesh, entry, dim=dim)
    return x


def _map2(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _map2(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(specs, tuple):
        return [_map2(v, s, fn) for v, s in zip(tree, specs)]
    if not isinstance(tree, torch.Tensor):
        return tree
    return fn(tree, specs)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor leaf of a whole tree sliced to this rank's block."""
    return _map2(tree, specs, lambda x, s: shard_tensor(x, s, mesh))


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor leaf of a laid-out tree gathered whole."""
    return _map2(tree, specs, lambda x, s: gather_tensor(x, s, mesh))


def reshard(tree: Any, specs: Any, mesh, new_specs: Any, new_mesh) -> Any:
    """`tree`, laid out by `specs` on `mesh`, laid out by `new_specs` on
    `new_mesh` (two meshes over one world)."""
    return shard_tree(gather_tree(tree, specs, mesh), new_specs, new_mesh)


def reshard_params(params: Any, specs: Any, mesh, new_mesh,
                   rules: Optional[AxisRules] = None) -> Any:
    """Params laid out by `specs` on `mesh` (a torch tensor carries no
    layout of its own), laid out by the rules' `param_specs` on
    `new_mesh`."""
    rules = rules or AxisRules()
    whole = gather_tree(params, specs, mesh)
    new = AxisRules(mesh=new_mesh, rules=rules.rules, zero3=rules.zero3)
    return shard_tree(whole, param_specs(whole, new), new_mesh)


def plan_batch(global_batch: int, mesh,
               batch_axes: Sequence[str] = ("pod", "data")) -> dict:
    """The per-rank batch under `mesh`: raises unless the global batch
    splits evenly over the batch axes it has."""
    ways = 1
    for a in batch_axes:
        if a in mesh.axis_names:
            ways *= mesh.shape[a]
    if global_batch % ways:
        raise ValueError(
            f"global_batch {global_batch} not divisible by batch shards "
            f"{ways} on mesh {dict(mesh.shape)}")
    return {"global_batch": global_batch, "batch_shards": ways,
            "per_shard": global_batch // ways}


