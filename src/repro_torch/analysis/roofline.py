"""Roofline terms for one NVIDIA H100 SXM (port of
`repro.analysis.roofline`, same dataclass and formulas).

    compute    = FLOPs / peak FLOP/s                  [s]
    memory     = bytes / HBM bandwidth                [s]
    collective = collective bytes / NVLink bandwidth  [s]

The constants are the H100 SXM data sheet's: dense bf16 tensor cores
989e12 FLOP/s, HBM3 3.35e12 B/s, NVLink 900 GB/s both directions
(450e9 B/s each way).  `chip_smoke.py`'s bounds read them from here.
`HBM_BYTES` is the card's memory when a CUDA device is present (read on
first use, so importing this module touches no device), else the data
sheet's 80 GB.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# H100 SXM constants (per card)
PEAK_FLOPS = 989e12          # dense bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s each way (900 GB/s both)
DATASHEET_HBM_BYTES = 80 * 10 ** 9


def hbm_bytes() -> int:
    """Device memory of card 0 when one is present, else the data
    sheet's 80 GB."""
    import torch
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return DATASHEET_HBM_BYTES


def __getattr__(name):
    if name == "HBM_BYTES":
        return hbm_bytes()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    model_flops_per_device: float = 0.0
    analytic_compute_s: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": max(self.compute_s, self.analytic_compute_s),
                 "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound on the step time."""
        return (max(self.compute_s, self.analytic_compute_s)
                + self.memory_s + self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute-time / modeled-step-time: 1.0 == compute-bound
        at peak tensor-core rate with everything else fully overlapped."""
        useful = self.model_flops_per_device / PEAK_FLOPS
        denom = max(self.step_time_s, 1e-12)
        return min(useful / denom, 1.0)

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "analytic_compute_s": self.analytic_compute_s,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops_per_device": self.model_flops_per_device,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_from_stats(flops: float, bytes_accessed: float,
                        collective_bytes: float,
                        model_flops_per_device: float = 0.0,
                        analytic_flops_per_device: float = 0.0) -> Roofline:
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_accessed / HBM_BW,
        collective_s=collective_bytes / NVLINK_BW,
        flops=flops,
        bytes_accessed=bytes_accessed,
        collective_bytes=collective_bytes,
        model_flops_per_device=model_flops_per_device,
        analytic_compute_s=analytic_flops_per_device / PEAK_FLOPS,
    )


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (the 6*N*D / 2*N*D convention)
# ---------------------------------------------------------------------------


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D for inference forward passes."""
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * float(n_active_params) * float(tokens)


def attention_flops(n_layers: int, n_heads: int, head_dim: int,
                    seq: int, batch: int, kind: str,
                    window: Optional[int] = None,
                    n_attn_layers: Optional[int] = None) -> float:
    """Score+PV matmul FLOPs (causal halves the full T^2)."""
    la = n_attn_layers if n_attn_layers is not None else n_layers
    eff = min(window, seq) if window else seq
    per_layer = 2 * 2 * batch * n_heads * head_dim * seq * eff * 0.5
    total = per_layer * la
    return total * (3.0 if kind == "train" else 1.0)
