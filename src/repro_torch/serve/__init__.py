"""Serving stack of the port: slot and paged engines, the block pool, the
scheduler, streaming samplers, speculative engines, request modes."""

from repro_torch.serve.engine import Engine, ServeConfig, resolve_device
from repro_torch.serve.kvpool import (BlockPool, PagedConfig, PoolExhausted,
                                      PrefixCache, paged_config)
from repro_torch.serve.modes import (BeamGroup, BestOfGroup, Hypothesis,
                                     allowed_ids_mask, parse_mask_spec)
from repro_torch.serve.paged import PagedEngine, PagedSelfSpecEngine
from repro_torch.serve.sampler import (sample_tokens, streaming_topk,
                                       top_p_mask)
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.spec import (SelfSpecEngine, SpecConfig, SpecEngine,
                                    small_draft)
