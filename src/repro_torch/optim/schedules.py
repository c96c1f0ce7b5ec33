"""Learning-rate schedules: pure functions of the int step (port of
`repro.optim.schedules`), evaluated on the host in f32 arithmetic as the
JAX package evaluates them on the device; they return Python floats."""

from __future__ import annotations

import numpy as np

_f = np.float32


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _f(step)
        warm = _f(peak_lr) * step / _f(max(warmup_steps, 1))
        t = (step - _f(warmup_steps)) / _f(max(total_steps - warmup_steps, 1))
        t = np.clip(t, _f(0.0), _f(1.0))
        cos = _f(final_frac) + _f(1 - final_frac) * _f(0.5) * (
            _f(1.0) + np.cos(_f(np.pi) * t))
        return float(warm if step < warmup_steps else _f(peak_lr) * cos)
    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    def fn(step):
        step = _f(step)
        warm = _f(peak_lr) * step / _f(max(warmup_steps, 1))
        t = (step - _f(warmup_steps)) / _f(max(total_steps - warmup_steps, 1))
        lin = _f(peak_lr) * np.clip(_f(1.0) - t, _f(0.0), _f(1.0))
        return float(warm if step < warmup_steps else lin)
    return fn


def warmup_rsqrt(peak_lr: float, warmup_steps: int):
    def fn(step):
        step = _f(step)
        warm = _f(peak_lr) * step / _f(max(warmup_steps, 1))
        rs = _f(peak_lr) * np.sqrt(_f(warmup_steps) / max(step, _f(1.0)))
        return float(warm if step < warmup_steps else rs)
    return fn


def constant(lr: float):
    def fn(step):
        del step
        return float(_f(lr))
    return fn
