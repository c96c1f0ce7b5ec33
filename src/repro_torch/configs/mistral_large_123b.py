"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8,
head_dim=128) d_ff=28672 vocab=32768.
[hf:mistralai/Mistral-Large-Instruct-2407]
"""

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig


def get_config(**overrides) -> Arch:
    cfg = TransformerConfig(
        name="mistral-large-123b",
        d_model=12288, n_layers=88,
        num_heads=96, num_kv_heads=8, head_dim=128,
        d_ff=28672, vocab_size=32768,
        rope_theta=1.0e6,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("mistral-large-123b", "transformer", cfg, tags=("dense",))


def reduced() -> Arch:
    cfg = TransformerConfig(
        name="mistral-large-reduced",
        d_model=96, n_layers=2,
        num_heads=6, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=512,
        chunk_q=32, chunk_k=32)
    return Arch("mistral-large-123b", "transformer", cfg, tags=("dense",),
                vocab_pad_multiple=16)
