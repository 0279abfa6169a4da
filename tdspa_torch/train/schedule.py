"""Learning-rate schedule (port of ``tdspa/train/schedule.py``): linear warmup
from 0, then cosine decay to 0, as optax's ``join_schedules`` of a
``linear_schedule`` and a ``cosine_decay_schedule``."""

from __future__ import annotations

import math

import numpy as np


def create_learning_rate_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """step -> learning rate (an f32 value, as optax computes it).

    optax's linear schedule with ``transition_steps <= 0`` is the constant 0;
    the cosine decays over ``max(total_steps - warmup_steps, 1)`` steps.
    """
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            count = min(max(step, 0), warmup_steps)
            value = base_lr * count / warmup_steps
        else:
            count = min(step - warmup_steps, decay_steps)
            value = base_lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return float(np.float32(value))

    return schedule
