"""Weight and KV quantization helpers of the serving path (port of
`repro.kernels.quant`).

What bounds a decode step is bytes moved: the lm_head that
`sample_topk`, `score_tokens` and the fused-CE forward stream, and the
paged KV pools.  This module is the one place that says how the head
shrinks:

  * `quantize_weight(w, dtype)`: per-row (= per vocab column of the
    logits) symmetric quantization of a (V, d) projection into int8 or
    fp8, plus an f32 scale vector (V,).  Row scales factor out of the
    d-contraction, ``z[r, v] = s[v] * sum_d h[r, d] * q[v, d]``, so each
    kernel runs its dot on the raw quantized tile (widened to bf16,
    exactly) and multiplies the logits by ``s`` after it: the
    dequantized weight never exists in device memory.
  * `head_quant_dtype(name)`: a ``ServeConfig.head_dtype`` string
    ("int8", "float8_e4m3fn", "float8_e5m2") as a torch dtype.

int8 uses the symmetric [-127, 127] grid (``-128`` unused, like
`models.attention.quantize_kv`), rounding half to even as ``jnp.round``;
fp8 divides by ``amax / finfo.max`` and lets the cast round.  The
quotient never leaves the fp8 range (|w / s| <= finfo.max up to one
rounding), where torch's cast saturates and JAX's gives NaN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_FP8_NAMES = ("float8_e4m3fn", "float8_e5m2")
HEAD_DTYPES = ("int8",) + _FP8_NAMES

_EPS = 1e-8

# the kernels' code for W's element type (`wstream.cuh` ``WKind``)
_WKINDS = {"bfloat16": 0, "int8": 1, "float8_e4m3fn": 2, "float8_e5m2": 3}


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    got = getattr(torch, str(dtype), None)
    if not isinstance(got, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return got


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def head_quant_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """``ServeConfig.head_dtype`` string -> torch dtype, or None for off.

    ``""``, None, "bfloat16" and "float32" serve the lm_head at the model
    dtype.  Unknown names raise, so a mistyped ``--head-dtype`` never
    serves bf16 quietly."""
    if not name or name in ("bfloat16", "float32"):
        return None
    if name not in HEAD_DTYPES:
        raise ValueError(
            f"head_dtype {name!r} not supported; pick one of "
            f"{('',) + HEAD_DTYPES} ('' serves at model dtype)")
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise NotImplementedError(
            f"head_dtype {name!r} is not available in this torch build; "
            "use 'int8'")
    return dt


def quantize_weight(w: torch.Tensor, dtype="int8"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, d) weight -> (quantized (V, d), per-row f32 scale (V,)).

    Row v's scale is ``max_d |w[v, d]| / grid_max``, at least 1e-8 so
    that an all-zero row stays finite; ``dequantize_weight(q, s) ~= w``
    within half a grid step an element."""
    qdtype = _dtype(dtype)
    w32 = w.float()
    amax = w32.abs().amax(dim=-1, keepdim=True)               # (V, 1)
    if qdtype == torch.int8:
        s = torch.clamp_min(amax / 127.0, _EPS)
        q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    elif _name(qdtype) in _FP8_NAMES:
        s = torch.clamp_min(amax / float(torch.finfo(qdtype).max), _EPS)
        q = (w32 / s).to(qdtype)
    else:
        raise ValueError(f"unsupported quantization dtype {_name(qdtype)!r}"
                         f"; pick one of {HEAD_DTYPES}")
    return q, s[:, 0].float()


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The inverse of `quantize_weight`, for tests and oracles only: the
    kernels widen a tile at a time and never form this tensor."""
    return q.float() * scale.float()[:, None]


def is_quantized_dtype(dtype) -> bool:
    """True for the 1-byte storage dtypes."""
    return torch.empty((), dtype=_dtype(dtype)).element_size() == 1


def w_kind(dtype: torch.dtype) -> int:
    """The W-stream kernels' code of a head's element type: 0 bf16, 1
    int8, 2 float8_e4m3fn, 3 float8_e5m2; ValueError for any other."""
    kind = _WKINDS.get(_name(dtype))
    if kind is None:
        raise ValueError(f"the kernel takes a bf16, int8, float8_e4m3fn or "
                         f"float8_e5m2 w, got {dtype}")
    return kind
