"""Learning-rate schedule.

Counterpart of `mal_tpu.train.lr_schedule.warmup_step_schedule`, the
reference's `WarmupStepLRScheduler` (`manydepth/lr_scheduler.py:30-71`):
linear warmup from `init_lr` to `peak_lr` over `warmup_steps`, then a 10x
decay every `decay_steps`. `mal_tpu` evaluates it in float32 inside optax;
this one computes the same float32 value on the host.
"""

from __future__ import annotations

import math

import numpy as np


def warmup_step_schedule(init_lr: float = 1e-10, peak_lr: float = 1e-4,
                         warmup_steps: int = 500, decay_steps: int = 48000,
                         decay_scale: float = 0.1):
    """step -> learning rate, a Python float."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        warm = f32(init_lr) + f32(peak_lr - init_lr) * f32(min(s, f32(warmup_steps))) \
            / f32(max(warmup_steps, 1))
        n_decays = f32(math.floor(max(s, f32(0.0)) / f32(decay_steps)))
        return float(f32(warm * f32(decay_scale) ** n_decays))
    return schedule


def make_schedule(cfg):
    """The reference's default schedule (`manydepth/trainer.py:194-232`),
    which the benchmark's configurations train with."""
    return warmup_step_schedule(cfg.init_lr, cfg.learning_rate,
                                cfg.warmup_steps, cfg.decay_steps)
