"""TrainState of the port: ``{'params', 'opt', 'step'}`` (port of
`repro.train.state`), and its specs (`state_specs`, with ZeRO-1).

The specs are the reference's, computed on the JAX package's stacked
leaves (`sharding.rules`): a slot takes the spec of the first param of
its shape in the JAX tree's leaf order (dict keys sorted), or of a param
one dim larger with the removed dim's entry dropped (Adafactor's
factored slots), else none.

`layout_specs` is the layout the port applies on a mesh under the
sharded losses (`train.step.TrainLayout`): every leaf by its repaired
spec over "model", every optimizer slot by its own param's (an
Adafactor factored slot's without the dim it removed).  That is
`state_specs` wherever the reference's match by shape lands on the
slot's own param; where an earlier param of the same shape carries
another spec (the lm_head's AdamW moments after an embedding table of
the same shape; a factored slot of a norm scale's shape) the reference
holds the slot elsewhere than its param and GSPMD moves it to the
param's layout for the update, and the port keeps it at its param's
layout, with the same values.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from repro_torch.optim.tree import leaves, stacked_groups


def make_train_state(params, opt_init: Callable) -> Dict[str, Any]:
    """Marks every float param as requiring grad and builds the optimizer
    state; ``step`` is a host int (the schedule is evaluated on the
    host)."""
    for p in leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    return {"params": params, "opt": opt_init(params), "step": 0}


def _slot_spec_from_param(slot_shape, param_shape, spec) -> tuple:
    """Equal shape -> the param's spec; one dim removed (a factored
    slot) -> the spec without that dim's entry; otherwise replicated."""
    if tuple(slot_shape) == tuple(param_shape):
        return spec
    if len(slot_shape) == len(param_shape) - 1:
        removed = None
        j = 0
        for i, s in enumerate(param_shape):
            if j < len(slot_shape) and slot_shape[j] == s:
                j += 1
            elif removed is None:
                removed = i
            else:
                return ()
        if removed is None:
            removed = len(param_shape) - 1
        axes = list(spec) + [None] * (len(param_shape) - len(spec))
        del axes[removed]
        return tuple(axes)
    return ()


def _zero1_spec(shape, spec, mesh, axes) -> tuple:
    """ZeRO-1: an optimizer slot also split over `axes` on its largest
    divisible unsharded dim (params stay as they are)."""
    if len(shape) == 0:
        return spec
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    used = {x for e in spec if e is not None
            for x in ((e,) if isinstance(e, str) else e)}
    if used & set(axes):
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    cands = sorted((j for j in range(len(shape))
                    if parts[j] is None and shape[j] % size == 0
                    and shape[j] >= size), key=lambda j: -shape[j])
    if not cands:
        return spec
    # a PartitionSpec holds a one-axis tuple as the name itself
    parts[cands[0]] = tuple(axes) if len(axes) > 1 else axes[0]
    return tuple(parts)


def _stacked_params(params, rules) -> List[Tuple[Tuple, Tuple[int, ...],
                                                  tuple, List[int], bool]]:
    """(path, stacked shape, stacked spec, indices into leaves,
    per-layer) of every stacked param leaf, in the JAX tree's leaf
    order."""
    from repro_torch.sharding.rules import (_stacked_axes, repair_spec,
                                            stacked_path)
    ps = leaves(params)
    out = []
    for key, idx, per_layer in stacked_groups(params):
        p = ps[idx[0]]
        shape = ((len(idx),) if per_layer else ()) + tuple(p.shape)
        axes = _stacked_axes(stacked_path(key), len(shape))
        spec = repair_spec(rules.param_spec(*axes), shape, rules.mesh)
        out.append((key, shape, spec, idx, per_layer))
    return sorted(out, key=lambda g: tuple(str(k) for k in g[0]))


def state_specs(state: Dict[str, Any], rules, zero1_axes=None):
    """Spec tree matching a TrainState: ``params`` by `param_specs`,
    each optimizer slot by its param's (`zero1_axes`: mesh axes that also
    split the slots, ZeRO-1), ``()`` for the counters and masks.  AdamW's
    moments are per-layer leaves as the params, and ZeRO-1 splits a
    per-layer moment over its own dims; Adafactor's slots are stacked
    leaves already."""
    from repro_torch.sharding.rules import param_specs, repair_spec
    params = state["params"]
    groups = _stacked_params(params, rules)

    def slot_spec(shape) -> tuple:
        for _, pshape, spec, _, _ in groups:
            if tuple(shape) == tuple(pshape):
                return spec
        for _, pshape, spec, _, _ in groups:
            if len(shape) == len(pshape) - 1:
                cand = _slot_spec_from_param(shape, pshape, spec)
                if cand != ():
                    return cand
        return ()

    def zero1(shape, spec) -> tuple:
        if zero1_axes:
            return _zero1_spec(shape, spec, rules.mesh, zero1_axes)
        return spec

    def stacked_slot(shape) -> tuple:
        return zero1(shape, repair_spec(slot_spec(shape), shape, rules.mesh))

    opt = state["opt"]
    if "mu" in opt:                        # AdamW: per-leaf moments
        by_leaf: Dict[int, tuple] = {}
        for _, shape, _, idx, per_layer in groups:
            spec = repair_spec(slot_spec(shape), shape, rules.mesh)
            if per_layer:
                # ZeRO-1 splits a per-layer moment over its own dims (the
                # stacked leaf's layer axis is not a dim of it)
                spec = zero1(shape[1:], tuple(spec[1:]))
            else:
                spec = zero1(shape, spec)
            for i in idx:
                by_leaf[i] = spec
        n = len(leaves(params))
        opt_specs = {"mu": [by_leaf[i] for i in range(n)],
                     "nu": [by_leaf[i] for i in range(n)],
                     "count": (), "mask": ()}
    else:                                  # Adafactor: stacked slots
        opt_specs = {
            "slots": [{k: stacked_slot(tuple(t.shape))
                       for k, t in slots.items()}
                      for slots in opt["slots"]],
            "count": (), "groups": ()}
    return {"params": param_specs(params, rules), "opt": opt_specs,
            "step": ()}


def model_spec(spec) -> tuple:
    """`spec` over "model" alone: other axes' entries None, trailing
    Nones dropped."""
    axes = [e if e == "model" else None for e in spec]
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def layout_specs(params, mesh, adafactor=None) -> Dict[str, Any]:
    """The layout of a train state on `mesh` (anything with ``shape`` and
    ``axis_names``) from WHOLE `params`: ``{'params': {path: spec}}`` of
    every leaf (its per-layer form, over "model" alone: `model_spec` of
    `sharding.rules.param_specs`), and with `adafactor` (an
    `optim.AdafactorConfig`) ``'slots'``: ``{stacked path: {name:
    stacked spec}}`` (the `stacked_groups` paths), each slot by its
    param's stacked spec, a factored slot's without the dim it removes
    (whole where that dim was the cut one).  AdamW's moments are laid
    out as their params."""
    from repro_torch.optim.adafactor import slot_dims
    from repro_torch.sharding.rules import (AxisRules, leaves_with_specs,
                                            param_specs)
    from repro_torch.optim.tree import leaves as leaves_of
    specs = {p: model_spec(s) for p, s in leaves_with_specs(
        param_specs(params, AxisRules(mesh=mesh)))}
    out: Dict[str, Any] = {"params": specs}
    if adafactor is not None:
        ps = leaves_of(params)
        paths = list(specs)
        slots: Dict[tuple, Dict[str, tuple]] = {}
        for key, idx, per_layer in stacked_groups(params):
            spec = specs[paths[idx[0]]]
            shape = ((len(idx),) if per_layer else ()) + tuple(
                ps[idx[0]].shape)
            if per_layer:
                spec = (None,) + spec
            full = list(spec) + [None] * (len(shape) - len(spec))
            slots[key] = {
                name: model_spec(full if removed is None else
                                 full[:removed] + full[removed + 1:])
                for name, removed in slot_dims(shape, adafactor).items()}
        out["slots"] = slots
    return out
