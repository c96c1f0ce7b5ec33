"""Shared configuration types for the fused projection->prediction loss
(port of `repro.core.types`).

Every implementation of the port (`canonical`, `streaming`, `kernel`)
consumes the same :class:`LossConfig`, so they are interchangeable and
are verified against each other and against the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static configuration of the fused output-projection + CE loss.

    Attributes:
      reduction: 'mean' | 'sum' | 'none'.  'mean' averages over
        non-ignored rows.
      ignore_index: target value marking rows excluded from the loss.
      label_smoothing: epsilon of standard label smoothing (needs the sum
        of the valid logits, one extra running statistic).
      z_loss: coefficient of the auxiliary z-loss ``z * lse^2``.
      logit_softcap: optional ``cap * tanh(z / cap)`` on every logit.
      valid_vocab: number of real vocabulary entries; rows of W beyond it
        are padding, masked to -inf everywhere.  None means W.shape[0].
      block_v: vocabulary chunk of the streaming implementation.
      accum_dtype: accumulator dtype of the online-softmax state.
      grad_filter_eps: threshold of the gradient-filtered backward
        (`core/filtering.py`; 0.0 is the exact backward).  The canonical
        loss ignores it.
    """

    reduction: str = "mean"
    ignore_index: int = IGNORE_INDEX
    label_smoothing: float = 0.0
    z_loss: float = 0.0
    logit_softcap: Optional[float] = None
    valid_vocab: Optional[int] = None
    block_v: int = 2048
    accum_dtype: str = "float32"
    grad_filter_eps: float = 0.0

    def __post_init__(self):
        if self.reduction not in ("mean", "sum", "none"):
            raise ValueError(f"bad reduction {self.reduction!r}")
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError("label_smoothing must be in [0, 1)")
        if self.z_loss < 0.0:
            raise ValueError("z_loss must be >= 0")
        if self.logit_softcap is not None and self.logit_softcap <= 0.0:
            raise ValueError("logit_softcap must be > 0")
        if self.block_v <= 0:
            raise ValueError("block_v must be positive")
        if self.grad_filter_eps < 0.0:
            raise ValueError("grad_filter_eps must be >= 0")
        if self.grad_filter_eps > 0.0 and self.label_smoothing > 0.0:
            raise ValueError(
                "grad_filter_eps is incompatible with label_smoothing: "
                "the smoothing gradient is dense over the vocabulary")

    @property
    def filter_grads(self) -> bool:
        """True when the backward would run the tile-filtered recompute."""
        return self.grad_filter_eps > 0.0

    def resolve_vocab(self, padded_vocab: int) -> int:
        v = self.valid_vocab if self.valid_vocab is not None else padded_vocab
        if v > padded_vocab:
            raise ValueError(
                f"valid_vocab={v} exceeds weight rows {padded_vocab}")
        return v

