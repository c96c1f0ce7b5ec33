"""Move the JAX package's params into the port.

`params_from_jax` takes the JAX param tree after
``jax.tree.map(np.asarray, params)`` — nested dicts of numpy arrays — and
returns the port's params: the same nesting, with the scanned ``blocks``
leaves ``(L, ...)`` (griffin's ``supers``, ``(n_super, ...)``, xlstm's
``pairs``, ``(n_pairs, ...)``, enc-dec's ``enc`` and ``dec``) unstacked
into a list of per-layer (per-super, per-pair) dicts.  Every other
subtree crosses as it is, the MTP heads' head x depth stacked ``mtp``
subtree included (`models/mtp.py` indexes it as JAX does).  Every
layout stays the JAX package's (``wq (d, nq, hd)``, ``wo (nq, hd, d)``,
``lm_head (V_pad, d)``, ...), so the move is a copy with no transposes.
bf16 arrays (numpy's ``bfloat16`` extension dtype) cross as their raw
16-bit words.

The way back: `state_to_host` / `state_to_jax` turn a port train state
(params, AdamW moments or Adafactor slots, the counters) into the flat
dict the JAX package's checkpointer writes, keyed by its path strings
(``params/blocks/attn/wq``, ``params/supers/b0/temporal/rglru/wa``,
``params/rem0/...``, ``params/dec/cross_attn/wk``, ``opt/mu/...``,
``opt/slots/<path>/vr``, ``opt/count``, ``step``) with the per-layer
leaves stacked again;
`state_from_jax` builds a port state from such a dict.  numpy keeps no
bfloat16 of its own, so a bf16 leaf crosses as raw ``|V2`` words: what
``np.savez`` writes for the JAX package's bfloat16.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List

import numpy as np
import torch

from repro_torch.optim.tree import leaves, stacked_groups


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy array (bf16 and the two fp8 types included) as a tensor
    on `device`; the 1- and 2-byte float types move as their bits."""
    a = np.array(a, copy=True, order="C")   # writable, contiguous
    if a.dtype.name == "bfloat16":
        t = _bf16_from_bits(a)
    elif a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        t = torch.from_numpy(a.view(np.uint8)).view(
            getattr(torch, a.dtype.name))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _bf16_from_bits(a: np.ndarray) -> torch.Tensor:
    """bf16 tensor over a contiguous array of 2-byte words."""
    return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy (a view of its memory): bf16 as its raw
    16-bit words in the ``|V2`` dtype."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _layer_count(blocks) -> int:
    while isinstance(blocks, (dict, list, tuple)):
        blocks = (next(iter(blocks.values())) if isinstance(blocks, dict)
                  else blocks[0])
    return blocks.shape[0]


# the JAX package's layer-stacked subtrees: the transformer's scanned
# blocks, griffin's scanned (rec, rec, attn) supers, xlstm's scanned
# (sLSTM, mLSTM) pairs, enc-dec's scanned encoder and decoder blocks
_STACKED = ("blocks", "supers", "pairs", "enc", "dec")


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The port's params from a numpy copy of the (scanned) JAX param
    tree, on `device`."""
    out = {}
    for key, val in tree.items():
        if key in _STACKED:
            out[key] = [_map(val, lambda a, i=i: tensor_from_numpy(a[i],
                                                                   device))
                        for i in range(_layer_count(val))]
        else:
            out[key] = _map(val, lambda a: tensor_from_numpy(a, device))
    return out


def states_from_jax(tree: Dict[str, Any], device="cpu") -> List[Any]:
    """xlstm's serve state from a numpy copy of the JAX package's
    layer-stacked one (``{'slstm', 'mlstm'}`` at the top, every leaf
    ``(n_pairs, B, ...)``, the cells tuples): the port's per-pair list,
    cells as lists."""
    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [unstack(v, i) for v in t]
        return tensor_from_numpy(t[i], device)

    return [unstack(tree, i) for i in range(_layer_count(tree))]


def encdec_caches_from_jax(tree: Dict[str, Any], device="cpu"
                           ) -> Dict[str, Any]:
    """Enc-dec's serve caches from a numpy copy of the JAX package's
    (``{'self': {'k', 'v', 'len'}, 'cross': (k, v)}``, the cross pair
    layer-stacked (L, B, T_enc, nkv, hd)): the self dict as it is, the
    cross pair as the port's per-layer list of ``{'k', 'v'}``."""
    k, v = tree["cross"]
    return {"self": _map(tree["self"],
                         lambda a: tensor_from_numpy(a, device)),
            "cross": [{"k": tensor_from_numpy(k[i], device),
                       "v": tensor_from_numpy(v[i], device)}
                      for i in range(k.shape[0])]}


def _key(prefix: str, path) -> str:
    return prefix + "/".join(map(str, path))


def state_to_host(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A snapshot of the train state `state` in host memory of its own,
    keyed and stacked as the JAX package's state tree: each per-layer
    leaf stacked on its device, then copied to the host; the counters as
    0-d int32.  Copying waits for the device work that wrote the
    tensors, and no later step touches the snapshot.  Keys in the JAX
    tree's flatten order (sorted paths)."""
    params = state["params"]
    groups = stacked_groups(params)
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, flat):
        for path, idx, per_layer in groups:
            ts = [flat[i].detach() for i in idx]
            out[_key(prefix, path)] = (torch.stack(ts).cpu() if per_layer
                                       else ts[0].to("cpu", copy=True))

    put("params/", leaves(params))
    opt = state["opt"]
    if "slots" in opt:                      # Adafactor: stacked already
        for (path, _, _), slot in zip(groups, opt["slots"]):
            for name, t in slot.items():
                out[_key("opt/slots/", path) + "/" + name] = \
                    t.detach().to("cpu", copy=True)
    else:                                   # AdamW: per leaf, as params
        put("opt/mu/", opt["mu"])
        put("opt/nu/", opt["nu"])
    out["opt/count"] = torch.tensor(int(opt["count"]), dtype=torch.int32)
    out["step"] = torch.tensor(int(state["step"]), dtype=torch.int32)
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))


def state_to_jax(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax`, for a whole train state: the
    JAX-keyed flat dict of stacked numpy arrays (bf16 as ``|V2``)."""
    return {k: tensor_to_numpy(t) for k, t in state_to_host(state).items()}


def _loaded(get: Callable[[str], np.ndarray], key: str, shape) -> np.ndarray:
    arr = get(key)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"model {tuple(shape)}")
    return arr


def _tensor(arr: np.ndarray, like: torch.Tensor, device, key: str
            ) -> torch.Tensor:
    """`arr` as a tensor of `like`'s dtype on `device` (default: `like`'s),
    in memory of its own: raw 2-byte words only for a bf16 leaf, any other
    dtype cast as the JAX checkpointer casts (``astype``)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:             # torch wants writable memory
        arr = arr.copy()
    if arr.dtype.kind == "V":
        if like.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise ValueError(f"{key}: raw {arr.dtype.str} words in the "
                             f"checkpoint for a {like.dtype} leaf")
        t = _bf16_from_bits(arr)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    dev = like.device if device is None else torch.device(device)
    t = t.to(dev, copy=True)
    if like.requires_grad:
        t.requires_grad_(True)
    return t


def _rebuild(tree, it: Iterator):
    """`tree`'s structure over the leaves `it` yields, in `leaves`
    order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def state_from_jax(get: Callable[[str], np.ndarray],
                   example: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A port train state laid out as `example` (its structure, shapes and
    dtypes; its tensors may live on the ``meta`` device) from the
    JAX-keyed stacked arrays that ``get(key)`` returns (raising
    `KeyError` for a missing key); a shape mismatch raises `ValueError`.
    Tensors land on `device` (default: each example tensor's own); the
    per-layer leaves are unstacked.  The optimizer's non-state entries
    (AdamW's decay ``mask``, Adafactor's ``groups``) come from
    `example`."""
    params = example["params"]
    groups = stacked_groups(params)

    def load(prefix, like):
        flat = [None] * len(like)
        for path, idx, per_layer in groups:
            key = _key(prefix, path)
            shape = ((len(idx),) if per_layer else ()) + tuple(
                like[idx[0]].shape)
            arr = _loaded(get, key, shape)
            for j, i in enumerate(idx):
                flat[i] = _tensor(arr[j] if per_layer else arr, like[i],
                                  device, key)
        return flat

    ex_opt = example["opt"]
    opt = dict(ex_opt, count=int(get("opt/count")))
    if "slots" in ex_opt:
        opt["slots"] = []
        for (path, _, _), slot in zip(groups, ex_opt["slots"]):
            keys = {name: _key("opt/slots/", path) + "/" + name
                    for name in slot}
            opt["slots"].append({
                name: _tensor(_loaded(get, keys[name], t.shape), t, device,
                              keys[name])
                for name, t in slot.items()})
    else:
        opt["mu"] = load("opt/mu/", ex_opt["mu"])
        opt["nu"] = load("opt/nu/", ex_opt["nu"])
    return {"params": _rebuild(params, iter(load("params/",
                                                 leaves(params)))),
            "opt": opt, "step": int(get("step"))}
