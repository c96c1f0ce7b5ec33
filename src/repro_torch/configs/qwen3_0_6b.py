"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8, head_dim=128,
qk_norm) d_ff=3072 vocab=151936.  [hf:Qwen/Qwen3 family]

The vocab-dominated regime: the embedding + lm_head hold ~50% of all
parameters — the paper's best case.
"""

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig


def get_config(**overrides) -> Arch:
    cfg = TransformerConfig(
        name="qwen3-0.6b",
        d_model=1024, n_layers=28,
        num_heads=16, num_kv_heads=8, head_dim=128,
        d_ff=3072, vocab_size=151936,
        qk_norm=True, rope_theta=1.0e6,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("qwen3-0.6b", "transformer", cfg, tags=("dense",))


def reduced() -> Arch:
    cfg = TransformerConfig(
        name="qwen3-0.6b-reduced",
        d_model=64, n_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512,
        qk_norm=True, chunk_q=32, chunk_k=32)
    return Arch("qwen3-0.6b", "transformer", cfg, tags=("dense",),
                vocab_pad_multiple=16)
