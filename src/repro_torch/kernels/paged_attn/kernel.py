"""Paged decode attention over a block-pool KV cache, without gathering it.

Replaces ``repro/kernels/paged_attn/kernel.py:_paged_kernel``, the Pallas
TPU kernel behind ``pallas_paged_attention``, with a hand-written CUDA
kernel for Hopper (`csrc/paged_attn.cu`, built by
`repro_torch.kernels.build`).

Bound on an H100 SXM: the kernel must read each row's live K/V entries
once (plus q, and write the output); at the serving cell's decode shape
(B 8, 8 KV heads, head_dim 128, block 16) a full 512-token chain is
16.8 MB a layer, ~5 us at 3.35 TB/s, and the products are far below the
tensor-core line: it is memory-bound, and at short chains bound by the
latency of a launch and of one dependent chain of loads.  The design
(the source's header): each (row, KV head) chain is split across CTAs,
flash-decoding style (grid (B, nkv, splits), `core.windows.paged_plan`,
held to its C twin before a shape's first launch), so the decode shape
fills the card; K/V stream through a cp.async ring, and scores and
``p @ v`` run on the tensor cores (``mma.sync`` m16n8k16) with the g * Tq
query rows as zero-padded m16 tiles and p kept to f32 precision as two
bf16 halves; the last split of a (row, head) to finish merges the
partials in split order (a counter in global memory, reset by that CTA),
so a call is one launch.  int8 pools (the JAX kernel's ``kp_scale`` /
``vp_scale``) stage int8 rows and each key's two f32 scales through the
same ring; a landed tile widens to bf16 in shared memory (K as
``bf16(k * ks)``, the reference's rounding, and V exactly, its scale
folded into p), so the rest of the kernel is the bf16 one.

Contract (the JAX kernel's): q (B, Tq, nq, hd), kp/vp
(N, bs, nkv, hd), table (B, nb) int32 chains (null block 0 past each
chain), lens (B,) int32 lengths after the Tq appends.  Query ``i`` sits
at ``lens - Tq + i``; rows with ``lens == 0`` give zeros.  Output
(B, Tq, nq, hd) in q's dtype.  With ``kp_scale`` / ``vp_scale`` (both or
neither, (N, bs, nkv, 1) f32) kp/vp hold int8 values: K is dequantized to
q's dtype before the score dot, V in f32 (`_decode_quantized`'s rule).
``pages_per_step`` is the pages of a split (the JAX kernel's pages a
sequential grid step: both set how much of a chain one step of the
kernel owns) and ``tile_keys`` the keys of a K/V tile (64, 32 or 16);
each left None keeps the kernel's own choice, or, with both None, the
tuning cache's winner for the shape (`autotune.lookup_paged_plan`).  A
plan the kernel does not take raises ValueError on every device
(`core.windows.paged_plan_error`); it never runs the own plan instead.

`paged_attention_ref` is the plain PyTorch version.  `paged_attention`
runs it for tensors on the CPU; for CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.windows import SMEM_BYTES, paged_plan, paged_plan_error
from repro_torch.kernels import build
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

MAX_HEAD_DIM = 256
LAUNCHES = build.counter("paged_attn")

_configured = set()
# per device: the (B, nkv) split counters, which the kernel leaves zero
_counts = {}


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attn")
    if id(lib) not in _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attn_launch.argtypes = [p] * 10 + [i] * 8 + [f, i, f, i,
                                                               i, p]
        lib.paged_attn_launch.restype = i
        lib.paged_attn_error_string.argtypes = [i]
        lib.paged_attn_error_string.restype = ctypes.c_char_p
        _configured.add(id(lib))
    return lib


def _split_counts(dev: torch.device, pairs: int) -> torch.Tensor:
    """At least `pairs` int32 zeros on `dev`, kept across calls: the last
    split of a (row, KV head) to finish resets its counter.  Calls on
    one device share them, so they run on one stream at a time."""
    counts = _counts.get(dev)
    if counts is None or counts.numel() < pairs:
        counts = _counts[dev] = torch.zeros((max(pairs, 64),),
                                            dtype=torch.int32, device=dev)
    return counts


def _check_cuda_args(q, kp, vp, table, lens, kp_scale=None, vp_scale=None):
    tensors = {"q": q, "kp": kp, "vp": vp, "table": table, "lens": lens}
    quant = kp_scale is not None
    if quant:
        tensors.update(kp_scale=kp_scale, vp_scale=vp_scale)
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1 or not q.is_cuda:
        raise ValueError("q, kp, vp, table and lens must lie on one CUDA "
                         "device, got " + ", ".join(
                             f"{k} {t.device}" for k, t in tensors.items()))
    pool_dtype = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 q, got {q.dtype}")
    for name, t in (("kp", kp), ("vp", vp)):
        if t.dtype != pool_dtype:
            raise ValueError(f"the kernel takes {'int8' if quant else 'bf16'}"
                             f" {name}{' with scale pools' if quant else ''}"
                             f", got {t.dtype}")
    if quant:
        want = tuple(kp.shape[:-1]) + (1,)
        for name, t in (("kp_scale", kp_scale), ("vp_scale", vp_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name} must be {want} f32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
        if q.shape[-1] % 16:
            raise ValueError(f"int8 pools need head_dim % 16 == 0, got "
                             f"{q.shape[-1]}")
    for name, t in (("table", table), ("lens", lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"need q (B, Tq, nq, hd) and kp/vp (N, bs, nkv, "
                         f"hd), got {tuple(q.shape)}, {tuple(kp.shape)}, "
                         f"{tuple(vp.shape)}")
    b, tq, nq, hd = q.shape
    n_pool, bs, nkv, hd_kv = kp.shape
    if hd_kv != hd or nq % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(kp.shape)} (head_dim, nq % nkv == 0)")
    if table.dim() != 2 or table.shape[0] != b or lens.shape != (b,):
        raise ValueError(f"need table (B, nb) and lens (B,) for B={b}, got "
                         f"{tuple(table.shape)} and {tuple(lens.shape)}")
    if min(b, tq, n_pool, bs, table.shape[1]) < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, pools "
                         f"{tuple(kp.shape)}, table {tuple(table.shape)}")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"the kernel needs head_dim % 8 == 0 and <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.data_ptr() % 16 or kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("q, kp and vp must be 16-byte aligned")


def paged_attention(
    q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
    table: torch.Tensor, lens: torch.Tensor, *,
    kp_scale: Optional[torch.Tensor] = None,
    vp_scale: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None,
    pages_per_step: Optional[int] = None,
    tile_keys: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention of q (B, Tq, nq, hd) over the block chains of
    kp/vp (N, bs, nkv, hd) -> (B, Tq, nq, hd) in q's dtype.

    CPU tensors go to `paged_attention_ref`.  CUDA tensors go to the
    kernel, which takes bf16 q and pools, int32 table and lens, all
    contiguous on one device, ``hd % 8 == 0`` and ``hd <= 256``, or int8
    pools with their (N, bs, nkv, 1) f32 scale pools `kp_scale` /
    `vp_scale` and ``hd % 16 == 0``; it raises ValueError on anything
    else.  A scale pool without the other raises on every device, and so
    does a `pages_per_step` / `tile_keys` plan the kernel does not
    take."""
    if (kp_scale is None) != (vp_scale is None):
        raise ValueError("kp_scale and vp_scale come together: one was "
                         "given without the other")
    quant = kp_scale is not None
    b, tq, nq, hd = q.shape
    bs, nkv = kp.shape[1], kp.shape[2]
    nb = table.shape[1]
    rows = (nq // max(nkv, 1)) * tq
    pps, kt = pages_per_step or 0, tile_keys or 0
    if not (pps or kt):
        from repro_torch.kernels.paged_attn.autotune import lookup_paged_plan
        kt, pps = lookup_paged_plan(b, tq, nq, nkv, hd, nb, bs, q.dtype,
                                    q.device, "int8" if quant else None)
    else:
        why = paged_plan_error(b, nkv, nb, bs, hd, rows, quant, pps, kt)
        if why is not None:
            raise ValueError(f"unsupported paged_attn plan (pages_per_step "
                             f"{pages_per_step}, tile_keys {tile_keys}): "
                             f"{why}")
    if q.device.type == "cpu":
        with build.kernel_scope("paged_attn"):
            return paged_attention_ref(q, kp, vp, table, lens,
                                       softcap=softcap, kp_scale=kp_scale,
                                       vp_scale=vp_scale)
    _check_cuda_args(q, kp, vp, table, lens, kp_scale, vp_scale)
    n_pool = kp.shape[0]
    plan = paged_plan(b, nkv, nb, bs, hd, rows, quant, pps, kt)
    if plan.smem_bytes > SMEM_BYTES:
        raise ValueError(f"{plan.smem_bytes} bytes of shared memory a block "
                         f"(head_dim {hd}, {rows} query rows a KV head) "
                         f"exceed the card's {SMEM_BYTES}")
    lib = _lib()
    build.check_plan_twin(lib, "paged_attn_plan",
                          (b, nkv, nb, bs, hd, rows, int(quant), pps, kt),
                          plan)
    with build.kernel_scope("paged_attn"):
        dev = q.device
        out = torch.empty_like(q)
        part = (torch.empty((b * nkv * plan.splits * rows * (hd + 2),),
                            dtype=torch.float32, device=dev)
                if plan.splits > 1 else None)
        counts = _split_counts(dev, b * nkv)
        with torch.cuda.device(dev):          # a no-op on the current device
            err = lib.paged_attn_launch(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                kp_scale.data_ptr() if quant else None,
                vp_scale.data_ptr() if quant else None, table.data_ptr(),
                lens.data_ptr(), out.data_ptr(),
                part.data_ptr() if part is not None else None,
                counts.data_ptr(), b, tq, nq, nkv, hd, n_pool, bs, nb,
                1.0 / math.sqrt(hd), int(softcap is not None),
                float(softcap or 0.0), pps, kt,
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError("paged_attn launch failed: "
                               + lib.paged_attn_error_string(err).decode())
        LAUNCHES.inc()
    return out
