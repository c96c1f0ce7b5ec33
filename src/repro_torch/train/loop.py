"""Training loop (port of `repro.train.loop`).

Runs the steps, times each one to the end of its device work, and feeds
the `train.*` instruments of `repro_torch.obs` (the JAX package's names:
``train.step_time_s``, ``train.tokens_per_sec``, ``train.loss``,
``train.steps_total``, ``train.tokens_total``) and one ``train.step``
span a step.  A logged step carries every metric the step returned, as
the JAX loop logs them: the per-horizon ``ce_h*`` / ``acc_h*`` of MTP
runs beside loss, ce, aux, grad_norm and lr.

As in the reference, every step's time goes to the straggler monitor,
the state is saved asynchronously after every `checkpoint_every`-th step
and when the preemption handler (SIGTERM / SIGINT, installed on entry)
asks to stop, the loop then breaks, and the last save is waited for
before returning.  `resume_or_init` restores the newest complete
checkpoint.  A resumed run starts its data over, as the reference's
does: `train_loop` calls ``iter(data)`` afresh, so the run resumed at
step s trains step s on the data's first batch, not its s-th.

On a mesh (`train.step.TrainLayout`) every rank runs the loop on its
own part of the state; a checkpoint gathers the whole state into rank
0's host memory leaf by leaf (every rank takes part) and rank 0 writes
it, in the reference's files (``shard_0.npz``); `resume_or_init` reads
each leaf of the file and keeps this rank's part of it, whatever mesh
shape wrote it, and a fresh init cuts the params before it makes the
optimizer state: no rank holds a whole optimizer state.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed.fault import PreemptionHandler, StragglerMonitor

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
    checkpointer: Optional[Checkpointer] = None,
    checkpoint_every: int = 100,
    log_every: int = 10,
    preemption: Optional[PreemptionHandler] = None,
    straggler: Optional[StragglerMonitor] = None,
    metrics_hook: Optional[Callable[[int, Dict[str, float]], None]] = None,
    on_start: Optional[Callable[[], Any]] = None,
    layout=None,
):
    """Runs steps ``state['step']`` .. ``num_steps - 1``; returns
    (state, history), history holding ``(step, metrics)`` of the logged
    steps (every `log_every`-th and the first) as floats.  With a
    `layout` (`train.step.TrainLayout`) the checkpoints gather the whole
    state and only rank 0 holds a `checkpointer`."""
    preemption = (preemption or PreemptionHandler()).install()
    straggler = straggler or StragglerMonitor()
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
        straggler.record(i, dt)
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

        if (checkpointer or layout) and ((i + 1) % checkpoint_every == 0
                                         or preemption.should_stop):
            whole = layout.gather_state(state) if layout else state
            if checkpointer:
                checkpointer.save_async(i + 1, whole)

        if preemption.should_stop:
            log.warning("preempted at step %d — checkpoint flushed", i)
            break

    if checkpointer:
        checkpointer.wait()
    return state, history


def resume_or_init(checkpointer: Optional[Checkpointer], init_fn,
                   generator: torch.Generator, device="cpu"):
    """Restore the latest checkpoint if there is one, else
    ``init_fn(generator, device)``.  The example state of the restore is
    ``init_fn`` on the ``meta`` device (shapes, dtypes and the
    optimizer's structure, no allocation, no random draws), and the
    restore builds the tensors on `device`.  Where ``init_fn`` makes a
    rank's part (its ``layout``, a `TrainLayout`, from
    `train.step.build_train_step` on a mesh) the restore reads each file
    leaf's block (`TrainLayout.select`) into that cut example."""
    layout = getattr(init_fn, "layout", None)
    if checkpointer is not None and checkpointer.latest_step() is not None:
        example = init_fn(torch.Generator(), "meta")
        state, step = checkpointer.restore(
            example, device=device,
            select=None if layout is None else layout.select)
        log.info("resumed from step %d", step)
        return state
    return init_fn(generator, device)
