"""Training loop (port of `repro.train.loop`, single device).

Runs the steps, times each one to the end of its device work, and feeds
the `train.*` instruments of `repro_torch.obs` (the JAX package's names:
``train.step_time_s``, ``train.tokens_per_sec``, ``train.loss``,
``train.steps_total``, ``train.tokens_total``) and one ``train.step``
span a step.  The checkpointer, the preemption handler and the
straggler monitor of the reference wait for a later slice.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from repro_torch import obs

log = logging.getLogger("repro_torch.train")


def _sync(metrics: Dict[str, Any]) -> None:
    loss = metrics.get("loss")
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def train_loop(
    *,
    state,
    step_fn: Callable,
    data: Iterable,
    num_steps: int,
    log_every: int = 10,
    metrics_hook: Optional[Callable[[int, Dict[str, float]], None]] = None,
    on_start: Optional[Callable[[], Any]] = None,
):
    """Runs steps ``state['step']`` .. ``num_steps - 1``; returns
    (state, history), history holding ``(step, metrics)`` of the logged
    steps (every `log_every`-th and the first) as floats."""
    history = []
    start_step = int(state["step"])

    reg = obs.get_registry()
    tracer = obs.get_tracer()
    m_step_t = reg.histogram("train.step_time_s",
                             help="wall-clock per optimizer step")
    m_tps = reg.gauge("train.tokens_per_sec",
                      help="tokens consumed per second, last step")
    m_loss = reg.gauge("train.loss", help="loss at last logged step")
    m_steps = reg.counter("train.steps_total", help="optimizer steps run")
    m_tokens = reg.counter("train.tokens_total",
                           help="tokens consumed by training")

    if on_start is not None:
        t0 = time.perf_counter()
        on_start()
        log.info("startup hook finished in %.2fs", time.perf_counter() - t0)

    it = iter(data)
    for i in range(start_step, num_steps):
        t0 = time.perf_counter()
        with tracer.step_span("train.step", i):
            batch = next(it)
            state, metrics = step_fn(state, batch)
            _sync(metrics)       # the step ends when its device work does
        dt = time.perf_counter() - t0
        m_step_t.observe(dt)
        m_steps.inc()
        tokens = batch.get("tokens") if isinstance(batch, dict) else None
        n_tok = tokens.numel() if tokens is not None else 0
        if n_tok:
            m_tokens.inc(n_tok)
            m_tps.set(n_tok / dt if dt > 0 else 0.0)

        if (i + 1) % log_every == 0 or i == start_step:
            m = {k: float(v) for k, v in metrics.items()}
            m["step_time_s"] = dt
            if "loss" in m:
                m_loss.set(m["loss"])
            history.append((i, m))
            log.info("step %d: %s", i,
                     {k: round(v, 5) for k, v in m.items()})
            if metrics_hook:
                metrics_hook(i, m)
    return state, history
