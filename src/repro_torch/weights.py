"""Move the JAX package's params into the port.

`params_from_jax` takes the JAX param tree after
``jax.tree.map(np.asarray, params)`` — nested dicts of numpy arrays — and
returns the port's params: the same nesting, with the scanned ``blocks``
leaves ``(L, ...)`` unstacked into a list of per-layer dicts.  Every other
subtree crosses as it is, the MTP heads' head x depth stacked ``mtp``
subtree included (`models/mtp.py` indexes it as JAX does).  Every
layout stays the JAX package's (``wq (d, nq, hd)``, ``wo (nq, hd, d)``,
``lm_head (V_pad, d)``, ...), so the move is a copy with no transposes.
bf16 arrays (numpy's ``bfloat16`` extension dtype) cross as their raw
16-bit words.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on `device`."""
    a = np.array(a, copy=True, order="C")   # writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _layer_count(blocks) -> int:
    while isinstance(blocks, dict):
        blocks = next(iter(blocks.values()))
    return blocks.shape[0]


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The port's params from a numpy copy of the (scanned) JAX param
    tree, on `device`."""
    out = {}
    for key, val in tree.items():
        if key == "blocks":
            out[key] = [_map(val, lambda a, i=i: tensor_from_numpy(a[i],
                                                                   device))
                        for i in range(_layer_count(val))]
        else:
            out[key] = _map(val, lambda a: tensor_from_numpy(a, device))
    return out
