"""Learning-rate schedules (port of ``tdspa/train/schedule.py``): the trainer's
linear warmup from 0, then cosine decay to 0, as optax's ``join_schedules`` of
a ``linear_schedule`` and a ``cosine_decay_schedule``; and optax's
``warmup_cosine_decay_schedule``, which the matcher's training uses."""

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


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value`` over
    the rest of ``decay_steps`` (which counts the warmup). step -> an f32 value.
    """
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine needs decay_steps > warmup_steps, got {decay_steps=} and "
                         f"{warmup_steps=}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:  # optax's polynomial schedule of power 1
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            value = (init_value - peak_value) * frac + peak_value
        else:
            count = min(step - warmup_steps, cosine_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
            value = peak_value * ((1.0 - alpha) * cosine + alpha)
        return float(np.float32(value))

    return schedule
