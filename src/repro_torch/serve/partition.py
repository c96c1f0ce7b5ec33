"""Specs of the serving cache trees and input batches (port of
`repro.serve.partition`, on the port's cache trees).

The rules are the reference's, evaluated on each leaf's stacked form in
the JAX package's tree (`sharding.rules.stacked_shape`): the batch dim
over ("pod", "data"); KV-head dims over "model"; recurrent state width
over "model"; layer-stack and time / window dims unsharded; paged block
pools (``kp`` / ``vp``) with no batch dim, only their kv-head dim on
"model".  A per-layer leaf's spec drops the layer entry.  Specs only:
no serving path lays out memory by them yet (ROADMAP A9 part 2).
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs.base import Arch
from repro_torch.sharding.rules import (AxisRules, _layer_counts, _map,
                                        _unstack, repair_spec,
                                        stacked_shape)


def _batch(rules: AxisRules):
    return rules._mesh_axes("batch")


def _model(rules: AxisRules):
    return rules._mesh_axes("heads")


def _name(path) -> str:
    """The name the rules read: the leaf's nearest dict key.  Enc-dec's
    cross K/V are a per-layer ``{'k', 'v'}`` here and a ``(k, v)`` tuple
    under ``'cross'`` in the JAX package's tree, read as ``'cross'``."""
    if path and path[0] == "cross":
        return "cross"
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _repaired(tree, rules: AxisRules, assign):
    counts = _layer_counts(tree)

    def fix(path, leaf):
        shape = stacked_shape(path, leaf, counts)
        spec = repair_spec(assign(path, len(shape)), shape, rules.mesh)
        return _unstack(path, spec)
    return _map(tree, fix)


def cache_specs(arch: Arch, cache_tree: Any, rules: AxisRules):
    """Spec tree matching `cache_tree`."""
    b_ax = _batch(rules)
    m_ax = _model(rules)
    scanned = getattr(arch.cfg, "scan_layers", True)

    def assign(path, rank):
        name = _name(path)
        lead = 1 if scanned else 0           # layer-stack axis
        axes = [None] * rank
        if name in ("kp", "vp"):
            if rank >= lead + 4:
                axes[lead + 2] = m_ax
            return tuple(axes)
        bpos = lead if rank > lead else None
        if bpos is not None:
            axes[bpos] = b_ax
        if name in ("k", "v") and rank >= lead + 4:
            axes[lead + 2] = m_ax            # kv heads
        elif name == "h" and rank == lead + 2:
            axes[lead + 1] = m_ax            # rg-lru state width
        elif name == "conv" and rank == lead + 3:
            axes[lead + 2] = m_ax            # conv tail width
        elif name not in ("k", "v", "pos", "len", "conv", "h", "table"):
            if rank >= lead + 2:             # xlstm cells: the head dim
                axes[lead + 1] = m_ax
        return tuple(axes)

    return _repaired(cache_tree, rules, assign)


def batch_specs(arch: Arch, batch_tree: Any, rules: AxisRules):
    """Input-batch specs: the batch dim over ("pod", "data")."""
    del arch
    b_ax = _batch(rules)
    return _repaired(batch_tree, rules,
                     lambda path, rank: (b_ax,) + (None,) * (rank - 1))
