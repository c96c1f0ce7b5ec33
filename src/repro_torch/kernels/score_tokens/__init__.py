"""Token-scoring kernel (Hopper CUDA) and its plain versions."""

from repro_torch.kernels.score_tokens.kernel import LAUNCHES, score_stats
from repro_torch.kernels.score_tokens.ops import score_tokens
from repro_torch.kernels.score_tokens.ref import score_stats_ref
