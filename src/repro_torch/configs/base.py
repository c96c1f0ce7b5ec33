"""Architecture registry base types (serving subset of `repro.configs.base`).

Every architecture provides `get_config()` (the exact public config) and
`reduced()` (same family, tiny dims — used by the CPU tests).  The
dry-run shape grid stays in the JAX package (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.types import LossConfig

# encoder frames a request of an enc-dec serving engine holds (the
# decoder gets the prompt), unless `ServeConfig.enc_len` says otherwise
ENCDEC_SERVE_ENC_LEN = 4096


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    """Block-plan autotuning knobs of training (the JAX package's).

    Attributes:
      enabled: tune the fused-CE forward's launch plan at startup
        (`kernels.fused_ce.autotune`); when False the step takes the
        tuning cache's winner where one exists, else the kernel's own.
      cache_path: persistent JSON cache location.  None -> the default
        (``$REPRO_TUNING_CACHE`` or ``~/.cache/repro/blockplans.json``);
        ``""`` -> a process-local in-memory cache.
      trial_budget: candidate plans timed a key at most; <= 0 measures
        nothing (the kernel's own plan).
      trial_iters: timings a candidate (the minimum is kept).
    """

    enabled: bool = False
    cache_path: Optional[str] = None
    trial_budget: int = 8
    trial_iters: int = 2


@dataclasses.dataclass(frozen=True)
class MTPConfig:
    """Multi-token-prediction heads over the shared trunk.

    Horizon 0 is the trunk's own next-token prediction; head h in
    1..n_heads predicts the token at offset h+1 through `head_depth`
    residual MLP blocks and the shared lm_head (`models/mtp.py`); the
    self-speculative engines draft from them.
    """

    n_heads: int = 0
    head_depth: int = 1
    d_ff: int = 0
    loss_weights: tuple = ()
    track_accuracy: bool = False

    def __post_init__(self):
        if self.n_heads < 0:
            raise ValueError("mtp.n_heads must be >= 0")
        if self.head_depth < 1:
            raise ValueError("mtp.head_depth must be >= 1")
        if self.loss_weights and len(self.loss_weights) != self.n_heads:
            raise ValueError(
                f"mtp.loss_weights has {len(self.loss_weights)} entries "
                f"for {self.n_heads} heads (use () for all-1.0)")
        if any(w < 0 for w in self.loss_weights):
            raise ValueError("mtp.loss_weights must be >= 0")

    def resolved_weights(self) -> tuple:
        return tuple(self.loss_weights) or (1.0,) * self.n_heads

    def resolved_d_ff(self, d_model: int) -> int:
        return self.d_ff or 2 * d_model


@dataclasses.dataclass(frozen=True)
class Arch:
    """One selectable architecture (--arch <id>)."""

    arch_id: str
    family: str                   # transformer | griffin | xlstm | encdec
    cfg: Any                      # family config dataclass
    tags: tuple = ()
    vocab_pad_multiple: int = 256  # lm_head rows padded to this multiple
    mtp: MTPConfig = MTPConfig()

    @property
    def vocab_size(self) -> int:
        return self.cfg.vocab_size

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    def loss_config(self, **kw) -> LossConfig:
        """The fused loss's config: pad rows of the lm_head masked."""
        kw.setdefault("valid_vocab", self.vocab_size)
        return LossConfig(**kw)


def with_mtp(arch: Arch, n_heads: int, **kw) -> Arch:
    """`arch` with an `MTPConfig(n_heads=n_heads, **kw)` block attached."""
    return dataclasses.replace(arch, mtp=MTPConfig(n_heads=n_heads, **kw))
