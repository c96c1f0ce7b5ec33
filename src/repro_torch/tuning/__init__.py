"""Persistent kernel-tuning state: the block-plan cache (port of
`repro.tuning`)."""

from repro_torch.tuning.cache import (TuningCache, backend_tag,
                                      default_cache_path, get_cache,
                                      plan_key)

__all__ = ["TuningCache", "get_cache", "plan_key", "default_cache_path",
           "backend_tag"]
