"""Learning-rate schedules as plain functions of the optimizer step;
counterpart of ``seed_story_tpu/train/scheduler.py`` (the reference's
linear / cosine / constant registry plus cosine with a min-ratio floor)."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def get_cosine_schedule_with_warmup(learning_rate: float, num_warmup_steps: int,
                                    num_training_steps: int, min_lr_ratio: float = 0.0,
                                    num_cycles: float = 0.5) -> Schedule:
    """Linear warmup from 0, then a cosine down to ``min_lr_ratio * lr`` at
    ``num_training_steps``, held there after."""

    def schedule(step: int) -> float:
        step = min(step, num_training_steps)
        if step < num_warmup_steps:
            return learning_rate * step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return learning_rate * (min_lr_ratio + (1.0 - min_lr_ratio) * cos)

    return schedule


def get_scheduler(name: str, learning_rate: float, num_warmup_steps: int = 0,
                  num_training_steps: int = 0, min_lr_ratio: float = 0.0) -> Schedule:
    if name in ("cosine", "cosine_with_min_lr"):
        return get_cosine_schedule_with_warmup(learning_rate, num_warmup_steps,
                                               num_training_steps, min_lr_ratio)
    if name == "linear":
        # as the JAX package resolves it: held at lr for the warmup steps, then
        # linear to 0 over num_training_steps
        steps = max(1, num_training_steps)

        def linear(step: int) -> float:
            done = min(max(step - num_warmup_steps, 0), steps)
            return learning_rate * (1.0 - done / steps)

        return linear
    if name == "constant":
        return lambda step: learning_rate
    if name == "constant_with_warmup":
        return lambda step: learning_rate * min(1.0, step / max(1, num_warmup_steps))
    raise ValueError(f"unknown scheduler {name}")
