"""paper-lm — the paper's own experimental regime (Table 1/2).

A d_model=4096 LLaMA-7B-class decoder whose vocabulary is selectable over
the paper's sweep {32768, 65536, 131072, 262144}.
"""

from repro_torch.configs.base import Arch
from repro_torch.models.transformer import TransformerConfig


def get_config(vocab_size: int = 131072, **overrides) -> Arch:
    cfg = TransformerConfig(
        name=f"paper-lm-v{vocab_size}",
        d_model=4096, n_layers=32,
        num_heads=32, num_kv_heads=32, head_dim=128,
        d_ff=11008, vocab_size=vocab_size,
        rope_theta=10000.0,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("paper-lm", "transformer", cfg, tags=("dense", "paper"))


def reduced() -> Arch:
    cfg = TransformerConfig(
        name="paper-lm-reduced",
        d_model=128, n_layers=2,
        num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=1024,
        chunk_q=32, chunk_k=32)
    return Arch("paper-lm", "transformer", cfg, tags=("dense", "paper"),
                vocab_pad_multiple=16)
