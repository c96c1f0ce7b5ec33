"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU + local attention 1:2.

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 vocab=256000,
local window 2048.  [arXiv:2402.19427]

Sub-quadratic: runs the long_500k decode cell (RG-LRU state + 2048-slot
ring KV cache — constant memory in sequence length).
"""

from repro_torch.configs.base import Arch
from repro_torch.models.griffin import GriffinConfig


def get_config(**overrides) -> Arch:
    cfg = GriffinConfig(
        name="recurrentgemma-9b",
        d_model=4096, n_layers=38,
        num_heads=16, num_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000,
        window=2048,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("recurrentgemma-9b", "griffin", cfg, tags=("hybrid",))


def reduced() -> Arch:
    cfg = GriffinConfig(
        name="recurrentgemma-reduced",
        d_model=48, n_layers=8,
        num_heads=4, num_kv_heads=1, head_dim=12,
        d_ff=96, vocab_size=512, window=16,
        chunk_q=16, chunk_k=16)
    return Arch("recurrentgemma-9b", "griffin", cfg, tags=("hybrid",),
                vocab_pad_multiple=16)
