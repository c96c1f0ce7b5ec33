"""qwen3-moe-235b-a22b [moe] — Qwen3 MoE flagship.

94L d_model=4096 64H (GQA kv=4, head_dim=128, qk_norm) MoE 128 experts
top-8 (expert d_ff=1536), vocab=151936.  [hf:Qwen/Qwen3-30B-A3B family]
"""

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig


def get_config(**overrides) -> Arch:
    cfg = TransformerConfig(
        name="qwen3-moe-235b-a22b",
        d_model=4096, n_layers=94,
        num_heads=64, num_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151936,
        num_experts=128, top_k=8, d_ff_expert=1536,
        qk_norm=True, rope_theta=1.0e6,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("qwen3-moe-235b-a22b", "transformer", cfg, tags=("moe",))


def reduced() -> Arch:
    cfg = TransformerConfig(
        name="qwen3-moe-reduced",
        d_model=64, n_layers=3,
        num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=48, vocab_size=512,
        num_experts=8, top_k=4, d_ff_expert=48,
        qk_norm=True, chunk_q=32, chunk_k=32)
    return Arch("qwen3-moe-235b-a22b", "transformer", cfg, tags=("moe",),
                vocab_pad_multiple=16)
