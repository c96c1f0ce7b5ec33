"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40: MHA) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5 family]
"""

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig


def get_config(**overrides) -> Arch:
    cfg = TransformerConfig(
        name="qwen1.5-32b",
        d_model=5120, n_layers=64,
        num_heads=40, num_kv_heads=40, head_dim=128,
        d_ff=27392, vocab_size=152064,
        qkv_bias=True, rope_theta=1.0e6,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("qwen1.5-32b", "transformer", cfg, tags=("dense",))


def reduced() -> Arch:
    cfg = TransformerConfig(
        name="qwen1.5-32b-reduced",
        d_model=64, n_layers=2,
        num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        qkv_bias=True, chunk_q=32, chunk_k=32)
    return Arch("qwen1.5-32b", "transformer", cfg, tags=("dense",),
                vocab_pad_multiple=16)
