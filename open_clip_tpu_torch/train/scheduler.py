"""Learning-rate schedules as plain step -> lr functions (counterpart of
``open_clip_tpu/train/scheduler.py``): warm-up then cosine, constant, or constant
with a polynomial cool-down. The warm-up gives ``base_lr * (step + 1) / warmup``,
and the optimizer reads the schedule at its own count, which is 0 on the first
step.
"""

from __future__ import annotations

import math
from typing import Callable


def _warmup(step: int, base_lr: float, warmup_length: int) -> float:
    return base_lr * (step + 1) / max(warmup_length, 1)


def const_lr(base_lr: float, warmup_length: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        return _warmup(step, base_lr, warmup_length) if step < warmup_length else base_lr

    return schedule


def cosine_lr(base_lr: float, warmup_length: int, steps: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warmup_length:
            return _warmup(step, base_lr, warmup_length)
        frac = (step - warmup_length) / max(steps - warmup_length, 1)
        return 0.5 * (1 + math.cos(math.pi * min(max(frac, 0.0), 1.0))) * base_lr

    return schedule


def const_lr_cooldown(base_lr: float, warmup_length: int, steps: int, cooldown_steps: int,
                      cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warmup_length:
            return _warmup(step, base_lr, warmup_length)
        start_cooldown = steps - cooldown_steps
        if step < start_cooldown:
            return base_lr
        frac = min(max((step - start_cooldown) / max(cooldown_steps, 1), 0.0), 1.0)
        return (1 - frac) ** cooldown_power * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return schedule


def create_scheduler(name: str, base_lr: float, warmup: int, total_steps: int,
                     **kw) -> Callable[[int], float]:
    if name == "cosine":
        return cosine_lr(base_lr, warmup, total_steps)
    if name == "const":
        return const_lr(base_lr, warmup)
    if name == "const-cooldown":
        return const_lr_cooldown(base_lr, warmup, total_steps, **kw)
    raise ValueError(f"unknown scheduler {name!r}")
