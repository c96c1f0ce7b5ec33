"""Leaves of the port's param trees: nested dicts whose ``blocks`` entry is
a list of per-layer dicts (the JAX package stacks those leaves along a
leading layer axis; `repro_torch.weights` unstacks them).
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple

import torch


def leaves_with_paths(tree: Any, path: Tuple = ()) -> Iterator[
        Tuple[Tuple, torch.Tensor]]:
    """(path, tensor) in a fixed order: dict keys in insertion order, list
    items by index (an int in the path marks a per-layer leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def leaves(tree: Any) -> List[torch.Tensor]:
    return [t for _, t in leaves_with_paths(tree)]


def stacked_rank(path: Tuple, leaf: torch.Tensor) -> int:
    """The rank this leaf has in the JAX package's stacked tree: one more
    for a per-layer leaf (its path runs through a list index)."""
    return leaf.dim() + int(any(isinstance(p, int) for p in path))


def stacked_groups(tree: Any) -> List[Tuple[Tuple, List[int], bool]]:
    """The leaves of the JAX package's stacked tree, in the order of their
    first leaf in `leaves`: ``(path, indices into leaves(tree),
    per_layer)``.  A per-layer leaf's path drops the layer index and its
    indices run over the layers; any other leaf has one index."""
    groups: dict = {}
    for i, (path, _) in enumerate(leaves_with_paths(tree)):
        key = tuple(p for p in path if not isinstance(p, int))
        per_layer = len(key) != len(path)
        groups.setdefault(key, (key, [], per_layer))[1].append(i)
    return list(groups.values())
