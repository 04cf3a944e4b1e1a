"""Learning-rate schedules, ``lr = sched(num_update)``.

Counterpart of ``mxnet_tpu/lr_scheduler.py``: fixed, factor, multi-factor and
cosine schedules with the same arithmetic.
"""

from __future__ import annotations

import math

__all__ = ["LRScheduler", "LearningRateScheduler", "FixedScheduler",
           "FactorScheduler", "MultiFactorScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FixedScheduler(LRScheduler):
    def __call__(self, num_update):
        return self.base_lr


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates."""

    def __init__(self, step, factor=0.9, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor

    def __call__(self, num_update):
        return self.base_lr * (self.factor ** (num_update // self.step))


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each milestone in ``step`` (sorted update counts)."""

    def __init__(self, step, factor=0.1, base_lr=0.01):
        super().__init__(base_lr)
        self.steps = sorted(step)
        self.factor = factor

    def __call__(self, num_update):
        passed = sum(1 for s in self.steps if num_update >= s)
        return self.base_lr * (self.factor ** passed)


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, final_lr=0.0, warmup=0, base_lr=0.01):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup = warmup

    def __call__(self, num_update):
        if num_update < self.warmup:
            return self.base_lr * (num_update + 1) / max(1, self.warmup)
        t = min(1.0, (num_update - self.warmup) / max(1, self.max_update - self.warmup))
        return self.final_lr + 0.5 * (self.base_lr - self.final_lr) * (1 + math.cos(math.pi * t))


# reference alias (misc.py names the base class LearningRateScheduler)
LearningRateScheduler = LRScheduler
