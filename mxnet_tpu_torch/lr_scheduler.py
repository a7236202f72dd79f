"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``):
Factor, MultiFactor, Poly, Cosine and a linear Warmup around another
scheduler.  A scheduler maps the optimizer's update count to a learning
rate; the optimizer sets its ``base_lr`` from ``learning_rate``."""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmupScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("lr clamped to %.2e", self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01):
        super().__init__(base_lr)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise ValueError("steps must be increasing")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind < len(self.step) and \
                num_update > self.step[self.cur_step_ind]:
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr *= self.factor
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * \
                (1.0 - num_update / self.max_update) ** self.power
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay from ``base_lr`` to ``final_lr`` over ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0):
        super().__init__(base_lr)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            frac = num_update / self.max_update
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) \
                * (1 + math.cos(math.pi * frac)) / 2
        return self.base_lr


class WarmupScheduler(LRScheduler):
    """Linear warmup wrapping another scheduler."""

    def __init__(self, warmup_steps, scheduler: LRScheduler):
        super().__init__(scheduler.base_lr)
        self.warmup_steps = warmup_steps
        self.scheduler = scheduler

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.scheduler.base_lr * (num_update + 1) / self.warmup_steps
        return self.scheduler(num_update - self.warmup_steps)
