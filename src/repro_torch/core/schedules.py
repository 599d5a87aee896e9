"""Learning-rate schedules, from ``src/repro/core/schedules.py``: functions
of the int step that return a Python float.  They run on the host (the
port keeps the step count there), in f32 as the JAX functions compute."""
from __future__ import annotations

import math
from typing import Callable

import numpy as np


def constant(lr: float) -> Callable[[int], float]:
    return lambda step: float(np.float32(lr))


def cosine_with_warmup(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_fraction: float = 0.1,
) -> Callable[[int], float]:
    """The paper's schedule: linear warmup then cosine decay."""
    f = np.float32

    def fn(step: int) -> float:
        s = f(step)
        if s < warmup_steps:
            return float(f(peak_lr) * s / f(max(warmup_steps, 1)))
        progress = (s - f(warmup_steps)) / f(max(total_steps - warmup_steps, 1))
        progress = min(max(progress, f(0.0)), f(1.0))
        cos = f(final_fraction) + f(1 - final_fraction) * f(0.5) * (
            f(1) + f(math.cos(math.pi * float(progress)))
        )
        return float(f(peak_lr) * cos)

    return fn
