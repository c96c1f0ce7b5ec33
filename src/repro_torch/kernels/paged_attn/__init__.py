"""Paged decode-attention kernel (Hopper CUDA) and its plain version."""

from repro_torch.kernels.paged_attn.autotune import (autotune_paged_plan,
                                                     lookup_paged_plan,
                                                     plan_pages_per_step)
from repro_torch.kernels.paged_attn.kernel import LAUNCHES, paged_attention
from repro_torch.kernels.paged_attn.ref import (gather_paged_kv,
                                                paged_attention_ref)
