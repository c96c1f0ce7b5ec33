"""internvl2-1b [vlm] — InternViT frontend (STUBBED: input_specs provides
256 precomputed patch embeddings) + Qwen2-0.5B-class LM backbone:
24L d_model=896 14H (GQA kv=2, head_dim=64) d_ff=4864 vocab=151655.
[arXiv:2404.16821]
"""

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig

PATCH_TOKENS = 256


def get_config(**overrides) -> Arch:
    cfg = TransformerConfig(
        name="internvl2-1b",
        d_model=896, n_layers=24,
        num_heads=14, num_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151655,
        qkv_bias=True, rope_theta=1.0e6,
        frontend_len=PATCH_TOKENS,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("internvl2-1b", "transformer", cfg, tags=("vlm",))


def reduced() -> Arch:
    cfg = TransformerConfig(
        name="internvl2-1b-reduced",
        d_model=64, n_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=515,   # deliberately ragged: exercises padding
        qkv_bias=True, frontend_len=8,
        chunk_q=32, chunk_k=32)
    return Arch("internvl2-1b", "transformer", cfg, tags=("vlm",),
                vocab_pad_multiple=16)
