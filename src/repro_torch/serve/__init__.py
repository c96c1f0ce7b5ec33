"""Serving stack of the port: slot engine, scheduler, streaming samplers."""

from repro_torch.serve.engine import Engine, ServeConfig, resolve_device
from repro_torch.serve.sampler import (sample_tokens, streaming_topk,
                                       top_p_mask)
from repro_torch.serve.scheduler import ContinuousScheduler
