"""Logical-axis sharding rules mapped onto a mesh (port of
`repro.sharding.rules`, as pure functions).

A spec is a tuple with one entry a dim: ``None`` (replicated), a mesh
axis name, or a tuple of names (the dim split over their product);
trailing ``None`` entries are dropped, as `repair_spec` drops them.  The
rules read only ``mesh.shape`` (axis name -> size) and
``mesh.axis_names``, so any object with those two serves (a
`launch.mesh.Mesh`, or a stand-in for a mesh this host cannot build).

The port's param trees hold per-layer leaves in lists (the JAX package
stacks them along a leading layer axis, `repro_torch.weights`).  Every
rule here is evaluated on the JAX package's stacked leaf — its path
without the layer index, its rank with the layer axis — so that the
specs are the reference's; a per-layer leaf's spec then drops the layer
axis's entry, which the rules never shard.

Logical axes:
  batch    -> ("pod", "data")     batch / rows of the loss
  seq      -> None
  embed    -> None | "data"       d_model; "data" under ZeRO-3
  heads    -> "model"             attention q heads
  kv_heads -> "model"             attention kv heads
  ffn      -> "model"             MLP hidden
  vocab    -> "model"             lm_head vocab rows
  expert   -> "model"             MoE expert axis
  rnn      -> "model"             recurrent state width
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence, Tuple

from repro_torch.optim.tree import leaves_with_paths

LogicalAxes = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "rnn": "model",
    "tp": "model",        # generic tensor-parallel dim (embed table d)
    "capacity": None,
    "group": ("pod", "data"),
}

# ZeRO-3 / FSDP: additionally shard the d_model dim of params over data
ZERO3_OVERRIDES = {"embed": "data"}


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Logical axis names -> mesh specs.  ``zero3`` also shards the
    ``embed`` dim of PARAMS over the data axis; activation specs always
    use the base rules."""

    mesh: Any = None
    rules: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    zero3: bool = False

    def with_zero3(self) -> "AxisRules":
        return dataclasses.replace(self, zero3=True)

    def _param_rules(self) -> dict:
        if not self.zero3:
            return self.rules
        r = dict(self.rules)
        r.update(ZERO3_OVERRIDES)
        return r

    def _mesh_axes(self, logical: Optional[str], *, for_params=False):
        if logical is None:
            return None
        table = self._param_rules() if for_params else self.rules
        target = table.get(logical, None)
        if target is None:
            return None
        if isinstance(target, str):
            target = (target,)
        if self.mesh is None:
            # a PartitionSpec holds a one-axis tuple as the name itself
            return tuple(target) if len(target) > 1 else target[0]
        present = tuple(a for a in target if a in self.mesh.axis_names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def spec(self, *logical: Optional[str]) -> Spec:
        return tuple(self._mesh_axes(a) for a in logical)

    def param_spec(self, *logical: Optional[str]) -> Spec:
        return tuple(self._mesh_axes(a, for_params=True) for a in logical)


# (path regex, logical axes of the *unstacked* param); a stacked param
# (leading layer axis) is recognized by its rank and gets a leading None
PARAM_PATH_RULES: Sequence[Tuple[str, Optional[LogicalAxes]]] = (
    # the input embedding shards its d_model dim; the lm_head stays
    # vocab-sharded (the paper's TP)
    (r"embed.*table", (None, "tp")),
    (r"lm_head", ("vocab", "embed")),
    (r"(attn|cross_attn).*wq$", ("embed", "heads", None)),
    (r"(attn|cross_attn).*w[kv]$", ("embed", "kv_heads", None)),
    (r"(attn|cross_attn).*wo$", ("heads", None, "embed")),
    (r"(attn|cross_attn).*b[qkv]$", ("heads", None)),
    (r"(attn|cross_attn).*(q_norm|k_norm)$", (None,)),
    (r"moe.*router", ("embed", "expert")),
    (r"moe.*w[ig]$", ("expert", "embed", None)),
    (r"moe.*wo$", ("expert", None, "embed")),
    (r"mlp.*w[ig]$", ("embed", "ffn")),
    (r"mlp.*wo$", ("ffn", "embed")),
    (r"mlp.*bi$", ("ffn",)),
    (r"mlp.*bo$", ("embed",)),
    (r"conv.*w$", (None, "rnn")),
    (r"mtp.*ln", (None,)),
    (r"rglru.*w[ax]$", ("rnn", None, None)),
    (r"(rglru|lstm|rnn).*", None),  # the rank-based fallback
)

# params whose undivisible axes are replicated, never relocated (empty,
# as the reference's)
NO_RELOCATE_PATTERNS: tuple = ()


def stacked_path(path: Tuple) -> str:
    """The JAX package's path string of a port leaf: the dict keys, the
    layer index dropped."""
    return "/".join(str(p) for p in path if not isinstance(p, int))


def _per_layer(path: Tuple) -> bool:
    return any(isinstance(p, int) for p in path)


def _fallback_axes(rank: int) -> LogicalAxes:
    """Shard the largest-likely dim: the last one on 'rnn' from 2-D."""
    if rank == 0:
        return ()
    if rank == 1:
        return (None,)
    return (None,) * (rank - 1) + ("rnn",)


def _stacked_axes(s: str, rank: int) -> LogicalAxes:
    for pat, axes in PARAM_PATH_RULES:
        if re.search(pat, s):
            if axes is None:
                return _fallback_axes(rank)
            if len(axes) == rank:
                return axes
            if len(axes) == rank - 1:
                return (None,) + tuple(axes)     # stacked over layers
            if len(axes) == rank - 2:
                return (None, None) + tuple(axes)
            break
    if rank <= 1:
        return (None,) * rank
    return _fallback_axes(rank)


def _map(tree, fn):
    """`tree` with each leaf replaced by ``fn(path, leaf)``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return fn(path, node)
    return walk(tree, ())


def _layer_key(path: Tuple) -> Tuple:
    """`path` without its first int, the layer index (later ints index a
    per-layer tuple of leaves, as xlstm's cell states)."""
    for i, p in enumerate(path):
        if isinstance(p, int):
            return path[:i] + path[i + 1:]
    return path


def _layer_counts(tree) -> dict:
    """Per-layer leaves of one stacked leaf -> their number of layers."""
    counts: dict = {}
    for path, _ in leaves_with_paths(tree):
        if _per_layer(path):
            key = _layer_key(path)
            counts[key] = counts.get(key, 0) + 1
    return counts


def stacked_shape(path: Tuple, leaf, counts: dict) -> Tuple[int, ...]:
    """The shape of `leaf`'s stacked leaf in the JAX package's tree."""
    shape = tuple(int(s) for s in leaf.shape)
    if not _per_layer(path):
        return shape
    return (counts[_layer_key(path)],) + shape


def logical_axes_for_params(params):
    """Tree of logical axes matching `params`: the reference's axes of
    each stacked leaf, a per-layer leaf's without its layer axis."""
    def assign(path, leaf):
        rank = leaf.dim() + int(_per_layer(path))
        axes = _stacked_axes(stacked_path(path), rank)
        return tuple(axes[1:]) if _per_layer(path) else tuple(axes)
    return _map(params, assign)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    size = 1
    for a in entry:
        size *= mesh.shape[a]
    return size


def repair_spec(spec: Spec, shape, mesh, relocate: bool = True) -> Spec:
    """Make `spec` divide `shape` evenly: a dim whose size is not a
    multiple of its mesh-axis product moves that entry to the rightmost
    unsharded divisible dim (the GQA head-dim split), or, with nowhere to
    go or ``relocate=False``, drops it.  Trailing Nones are dropped."""
    if mesh is None:
        return tuple(spec)
    axes = list(spec) + [None] * (len(shape) - len(spec))
    for i, entry in enumerate(axes):
        if entry is None:
            continue
        size = _axis_size(mesh, entry)
        if size <= 1 or shape[i] % size == 0:
            continue
        axes[i] = None
        if not relocate:
            continue
        cands = [j for j in range(len(shape) - 1, -1, -1)
                 if axes[j] is None and shape[j] % size == 0
                 and shape[j] >= size]
        if cands:
            axes[cands[0]] = entry
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def _unstack(path: Tuple, spec: Spec) -> Spec:
    """A stacked leaf's spec as its per-layer leaves' (the layer entry
    dropped; the rules never shard it)."""
    if not _per_layer(path):
        return spec
    if spec and spec[0] is not None:
        raise ValueError(f"{stacked_path(path)}: spec {spec} shards the "
                         "layer axis, which a per-layer leaf cannot hold")
    return tuple(spec[1:])


def repair_specs(specs, leaves, mesh, no_relocate=None):
    """`repair_spec` leaf for leaf over matching trees; `specs` and
    `no_relocate` are given for the STACKED leaves (their layer entry
    included) and the result is the port's (per-layer leaves without
    it)."""
    counts = _layer_counts(leaves)
    flat_specs = {p: s for p, s in leaves_with_specs(specs)}
    flat_nr = ({p: v for p, v in leaves_with_paths(no_relocate)}
               if no_relocate is not None else {})

    def fix(path, leaf):
        shape = stacked_shape(path, leaf, counts)
        s = repair_spec(flat_specs[path], shape, mesh,
                        relocate=not flat_nr.get(path, False))
        return _unstack(path, s)
    return _map(leaves, fix)


def leaves_with_specs(specs, path: Tuple = ()):
    """(path, spec) of a spec tree (a spec is a tuple: a leaf)."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from leaves_with_specs(v, path + (k,))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from leaves_with_specs(v, path + (i,))
    else:
        yield path, specs


def param_specs(params, rules: AxisRules):
    """Spec tree matching `params`: the reference's `param_specs` of the
    stacked tree, each per-layer leaf's without its layer entry."""
    def stacked(path, leaf):
        rank = leaf.dim() + int(_per_layer(path))
        return rules.param_spec(*_stacked_axes(stacked_path(path), rank))
    specs = _map(params, stacked)
    no_reloc = _map(params, lambda p, _: any(
        re.search(pat, stacked_path(p)) for pat in NO_RELOCATE_PATTERNS))
    return repair_specs(specs, params, rules.mesh, no_relocate=no_reloc)


def spec_shard(spec: Spec, shape, mesh) -> Tuple[Tuple[int, int], ...]:
    """This rank's block of a tensor of `shape` under `spec` on `mesh`
    (a `launch.mesh.Mesh`): ``(start, length)`` per dim."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append((0, int(n)))
            continue
        ways = _axis_size(mesh, entry)
        if n % ways:
            raise ValueError(f"dim {i} of size {n} does not split over "
                             f"{entry} ({ways} ranks)")
        blk = n // ways
        out.append((mesh.axis_index(entry) * blk, blk))
    return tuple(out)
