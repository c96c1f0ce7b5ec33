"""arctic-480b [moe] — Snowflake Arctic: dense-MoE hybrid.

35L d_model=7168 56H (GQA kv=8, head_dim=128) dense d_ff=4864,
MoE 128 experts top-2 (expert d_ff=4864) in PARALLEL with the dense FFN
residual every layer.  vocab=32000.  [hf:Snowflake/snowflake-arctic-base]
"""

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig


def get_config(**overrides) -> Arch:
    cfg = TransformerConfig(
        name="arctic-480b",
        d_model=7168, n_layers=35,
        num_heads=56, num_kv_heads=8, head_dim=128,
        d_ff=4864, vocab_size=32000,
        num_experts=128, top_k=2, d_ff_expert=4864,
        dense_ff_residual=True,
        rope_theta=10000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("arctic-480b", "transformer", cfg, tags=("moe",))


def reduced() -> Arch:
    cfg = TransformerConfig(
        name="arctic-480b-reduced",
        d_model=64, n_layers=2,
        num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=512,
        num_experts=8, top_k=2, d_ff_expert=48,
        dense_ff_residual=True,
        chunk_q=32, chunk_k=32)
    return Arch("arctic-480b", "transformer", cfg, tags=("moe",),
                vocab_pad_multiple=16)
