"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304; alternating
sLSTM + mLSTM blocks.  [arXiv:2405.04517]

Sub-quadratic: constant-size recurrent state (14.4 MB a slot at full
depth, whatever the context length); no KV cache.
"""

from repro_torch.configs.base import Arch
from repro_torch.models.xlstm import XLSTMConfig


def get_config(**overrides) -> Arch:
    cfg = XLSTMConfig(
        name="xlstm-125m",
        d_model=768, n_layers=12, num_heads=4,
        vocab_size=50304, chunk=256,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("xlstm-125m", "xlstm", cfg, tags=("ssm",))


def reduced() -> Arch:
    cfg = XLSTMConfig(
        name="xlstm-125m-reduced",
        d_model=48, n_layers=4, num_heads=3,
        vocab_size=211, chunk=16)
    return Arch("xlstm-125m", "xlstm", cfg, tags=("ssm",),
                vocab_pad_multiple=16)
