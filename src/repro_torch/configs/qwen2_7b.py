"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4, head_dim=128)
d_ff=18944 vocab=152064, QKV bias.  [arXiv:2407.10671]
"""

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig


def get_config(**overrides) -> Arch:
    cfg = TransformerConfig(
        name="qwen2-7b",
        d_model=3584, n_layers=28,
        num_heads=28, num_kv_heads=4, head_dim=128,
        d_ff=18944, vocab_size=152064,
        qkv_bias=True, rope_theta=1.0e6,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("qwen2-7b", "transformer", cfg, tags=("dense",))


def reduced() -> Arch:
    cfg = TransformerConfig(
        name="qwen2-7b-reduced",
        d_model=64, n_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        qkv_bias=True, chunk_q=32, chunk_k=32)
    return Arch("qwen2-7b", "transformer", cfg, tags=("dense",),
                vocab_pad_multiple=16)
