"""seamless-m4t-medium [audio] — encoder-decoder; speech frontend STUBBED
(input_specs provides precomputed frame embeddings).  12L encoder + 12L
decoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 — the largest
vocabulary in the pool (fused-CE stress case).  [arXiv:2308.11596]
"""

from repro_torch.configs.base import Arch
from repro_torch.models.encdec import EncDecConfig


def get_config(**overrides) -> Arch:
    cfg = EncDecConfig(
        name="seamless-m4t-medium",
        d_model=1024, n_enc_layers=12, n_dec_layers=12,
        num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=256206,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        **overrides)
    return Arch("seamless-m4t-medium", "encdec", cfg, tags=("audio",))


def reduced() -> Arch:
    cfg = EncDecConfig(
        name="seamless-reduced",
        d_model=48, n_enc_layers=2, n_dec_layers=2,
        num_heads=4, num_kv_heads=4, head_dim=12,
        d_ff=96, vocab_size=517,   # ragged vocab: exercises padding
        chunk_q=32, chunk_k=32)
    return Arch("seamless-m4t-medium", "encdec", cfg, tags=("audio",),
                vocab_pad_multiple=16)
