"""Fault tolerance: preemption handling, straggler detection, retries
(port of `repro.distributed.fault`; the JAX module imports no JAX, but
the port keeps its own copy).

PreemptionHandler — installs SIGTERM/SIGINT handlers; the train loop polls
`should_stop` at step boundaries and checkpoints before exiting.

StragglerMonitor — EMA of step time; flags steps slower than
`threshold x EMA`.  On one device it feeds metrics and logs: the
*detection* half of straggler mitigation, whose *recovery* half is
checkpoint-restore.

retry — exponential backoff for transient host-side failures (data source
hiccups, checkpoint filesystem blips).
"""

from __future__ import annotations

import logging
import signal
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.fault")


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._signals = signals
        self._installed = False

    def install(self):
        if self._installed:
            return self
        for s in self._signals:
            try:
                signal.signal(s, self._handler)
            except ValueError:        # non-main thread (tests)
                pass
        self._installed = True
        return self

    def _handler(self, signum, frame):
        del frame
        log.warning("received signal %s: requesting graceful stop", signum)
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def request_stop(self):
        self._stop = True


class StragglerMonitor:
    def __init__(self, ema_decay: float = 0.9, threshold: float = 3.0,
                 warmup_steps: int = 5,
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None):
        self.ema_decay = ema_decay
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.on_straggler = on_straggler
        self._ema: Optional[float] = None
        self._seen = 0
        self.flagged: list = []

    def record(self, step: int, step_time: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self._seen += 1
        if self._ema is None:
            self._ema = step_time
            return False
        is_straggler = (self._seen > self.warmup_steps
                        and step_time > self.threshold * self._ema)
        if is_straggler:
            self.flagged.append((step, step_time, self._ema))
            log.warning("straggler at step %d: %.3fs vs EMA %.3fs",
                        step, step_time, self._ema)
            if self.on_straggler:
                self.on_straggler(step, step_time, self._ema)
        else:
            self._ema = (self.ema_decay * self._ema
                         + (1 - self.ema_decay) * step_time)
        return is_straggler


def retry(fn: Callable, *args, retries: int = 3, base_delay: float = 0.5,
          exceptions=(OSError, IOError), **kwargs):
    """Run fn with exponential-backoff retries on transient errors."""
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except exceptions as e:                  # pragma: no cover - timing
            if attempt == retries:
                raise
            delay = base_delay * (2 ** attempt)
            log.warning("retry %d/%d after %s (sleep %.2fs)",
                        attempt + 1, retries, e, delay)
            time.sleep(delay)
