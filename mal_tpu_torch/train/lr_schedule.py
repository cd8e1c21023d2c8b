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


def step_lr_schedule(peak_lr: float, step_size_epochs: int,
                     steps_per_epoch: int, decay_scale: float = 0.1):
    """torch `StepLR(optimizer, scheduler_step_size, 0.1)` stepped once per
    epoch (`dualrefine/trainer.py:104-105,272`; manydepth `--step_lr`):
    lr = peak * 0.1^floor(epoch / step_size), in float32 as
    `mal_tpu.train.lr_schedule.step_lr_schedule` evaluates it."""
    if steps_per_epoch <= 0:
        raise ValueError("step_lr_schedule needs steps_per_epoch > 0 "
                         "(the trainer sets Config.steps_per_epoch from "
                         "len(train_loader))")
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = np.floor(f32(step) / f32(steps_per_epoch))
        n_decays = np.floor(f32(epoch) / f32(max(step_size_epochs, 1)))
        return float(f32(f32(peak_lr) * f32(decay_scale) ** f32(n_decays)))
    return schedule


def make_schedule(cfg):
    """The learning-rate schedule `cfg.lr_scheduler` names
    (`mal_tpu/train/state.py:130-154`)."""
    if cfg.lr_scheduler == "step":
        return step_lr_schedule(cfg.learning_rate, cfg.scheduler_step_size,
                                cfg.steps_per_epoch)
    if cfg.lr_scheduler == "warmup_step":
        return warmup_step_schedule(cfg.init_lr, cfg.learning_rate,
                                    cfg.warmup_steps, cfg.decay_steps)
    # --cos selects CosineAnnealingWarmupRestarts, whose class is missing
    # from the reference snapshot (`manydepth/trainer.py:194`)
    raise NotImplementedError(
        f"lr_scheduler={cfg.lr_scheduler!r}: only 'warmup_step' and 'step' "
        "exist ('cos' is broken in the reference snapshot)")
