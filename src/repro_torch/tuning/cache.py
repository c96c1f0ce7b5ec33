"""Persistent block-plan tuning cache (port of `repro.tuning.cache`).

Maps a problem key -- ``(n_rows, vocab, d, dtype, backend, op)`` -- to
the empirically best `BlockPlan` the autotuner (`kernels/plan_tuner.py`)
found for one kernel.  The file is the JAX package's: JSON, ``version``
1, ``entries`` of ``block_rows``, ``block_v``, ``vmem_bytes`` and ``us``;
each kernel's ``autotune.py`` says what its two fields mean.  One file
may hold both packages' entries: the backend is part of the key, and the
port's tags (`backend_tag`: ``cuda`` on the card, ``torch_cpu`` on the
CPU) are none of JAX's, so a plan timed for a Pallas kernel (``cpu``,
``gpu``, ``tpu``) never resolves as a plan of a port kernel.

A missing or corrupt cache file is a cold cache: every consumer falls
back to its kernel's own plan.

Beside the entries, `RESOLVED` memoizes the hot paths' resolutions (one
`get` a key and process, see `plan_tuner.lookup_cached`); any write to
any cache, and a new singleton, clear it.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional

from repro_torch import obs
from repro_torch.core.windows import BlockPlan

_VERSION = 1
_ENV_PATH = "REPRO_TUNING_CACHE"
_DISABLED = ("", "0", "off", "none")
_MEMORY_KEY = ":memory:"

# hot-path resolutions: memo key -> plan; cleared on every write
RESOLVED: Dict[Any, Any] = {}


def backend_tag(device) -> str:
    """The key's backend for tensors on `device`: ``cuda`` or
    ``torch_cpu`` (no JAX backend is called so)."""
    kind = str(getattr(device, "type", device)).split(":")[0]
    return "cuda" if kind == "cuda" else "torch_cpu"


def plan_key(n_rows: int, vocab: int, d: int, dtype: str,
             backend: str, op: str = "ce",
             wdtype: Optional[str] = None) -> str:
    """Canonical cache key: ``"<n>x<V>x<d>:<dtype>[+<wdtype>]:<backend>[:<op>]"``,
    the JAX package's format.

    ``op`` namespaces entries per kernel family (``topk<k>``,
    ``score<P>``, ``pattn<bs>``; the default ``"ce"`` is elided), and
    ``wdtype`` names the streamed operand's dtype where it differs from
    the activations' (a 1-byte lm_head or KV pool), so that no plan
    resolves for another kernel or precision."""
    base = f"{int(n_rows)}x{int(vocab)}x{int(d)}:{dtype}"
    if wdtype is not None:
        base += f"+{wdtype}"
    base += f":{backend}"
    return base if op == "ce" else f"{base}:{op}"


def default_cache_path() -> Optional[str]:
    """Default on-disk location; ``REPRO_TUNING_CACHE`` overrides it
    (``""`` / ``"off"`` / ``"0"`` / ``"none"``: a process-local
    in-memory cache)."""
    env = os.environ.get(_ENV_PATH)
    if env is not None:
        return None if env.strip().lower() in _DISABLED else env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro",
                        "blockplans.json")


class TuningCache:
    """JSON-backed plan memo; in-memory only when ``path`` is None.

    Thread-safe; loading is lazy, so constructing a cache never touches
    the filesystem.  ``save()`` writes atomically (tmp file + rename)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._loaded = False

    # -- persistence --------------------------------------------------

    def _merge_from_disk_locked(self) -> None:
        """Fold the on-disk entries in; in-process entries win."""
        if not self.path:
            return
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return  # missing/corrupt file == cold cache
        if isinstance(raw, dict) and raw.get("version") == _VERSION:
            entries = raw.get("entries", {})
            if isinstance(entries, dict):
                for k, v in entries.items():
                    self._entries.setdefault(k, v)

    def _load_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._merge_from_disk_locked()

    def save(self) -> None:
        """Persist to ``self.path`` (no-op for in-memory caches).

        Merge-on-save: the file is re-read under the lock and folded in
        (in-process entries win) before the atomic replace, so two
        processes tuning different kernels against one file keep each
        other's entries."""
        if not self.path:
            return
        target = os.path.abspath(self.path)
        with self._lock:
            self._loaded = True
            self._merge_from_disk_locked()
            payload = {"version": _VERSION, "entries": dict(self._entries)}
        os.makedirs(os.path.dirname(target), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(target),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, target)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- accessors ----------------------------------------------------

    def get(self, key: str) -> Optional[BlockPlan]:
        with self._lock:
            self._load_locked()
            e = self._entries.get(key)
        reg = obs.get_registry()
        if not isinstance(e, dict):
            reg.counter("tuning_cache.misses_total",
                        help="plan-cache lookups with no entry").inc()
            return None
        try:
            plan = BlockPlan(int(e["block_rows"]), int(e["block_v"]),
                             int(e.get("vmem_bytes", 0)))
        except (KeyError, TypeError, ValueError):
            reg.counter("tuning_cache.misses_total",
                        help="plan-cache lookups with no entry").inc()
            return None
        reg.counter("tuning_cache.hits_total",
                    help="plan-cache lookups served from memo").inc()
        return plan

    def put(self, key: str, plan: BlockPlan,
            us: Optional[float] = None) -> None:
        entry = {"block_rows": int(plan.block_rows),
                 "block_v": int(plan.block_v),
                 "vmem_bytes": int(plan.vmem_bytes)}
        if us is not None:
            entry["us"] = round(float(us), 2)
        with self._lock:
            self._load_locked()
            self._entries[key] = entry
        RESOLVED.clear()

    def clear(self) -> None:
        with self._lock:
            self._loaded = True
            self._entries.clear()
        RESOLVED.clear()

    def __len__(self) -> int:
        with self._lock:
            self._load_locked()
            return len(self._entries)


_SINGLETONS: Dict[str, TuningCache] = {}
_SINGLETONS_LOCK = threading.Lock()


def get_cache(path: Optional[str] = None) -> TuningCache:
    """Process-wide singleton cache per resolved path.

    ``path=None`` -> the default location (honouring
    ``REPRO_TUNING_CACHE``); ``path=""`` -> a shared in-memory cache."""
    if path is None:
        path = default_cache_path()
    if not path:
        key, real = _MEMORY_KEY, None
    else:
        real = os.path.abspath(os.path.expanduser(path))
        key = real
    with _SINGLETONS_LOCK:
        cache = _SINGLETONS.get(key)
        if cache is None:
            cache = _SINGLETONS[key] = TuningCache(real)
            RESOLVED.clear()
        return cache
