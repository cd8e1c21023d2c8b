"""Training state: the model (parameters and BN statistics), the optimizer,
the depth-bin tracker and the loss balancer.

Counterpart of `mal_tpu.train.state`. `mal_tpu`'s state is an immutable
pytree that each step replaces; here the model and optimizer are updated in
place and the step returns the same `TrainState`, with its `step`, `bins`
and `balancer` advanced.
"""

from __future__ import annotations

import dataclasses

import torch

from mal_tpu_torch.config import Config
from mal_tpu_torch.device import resolve_device
from mal_tpu_torch.losses import LossBalancerState
from mal_tpu_torch.models.mal_model import MALModel
from mal_tpu_torch.parallel import mesh
from mal_tpu_torch.train.lr_schedule import make_schedule

Tensor = torch.Tensor


@dataclasses.dataclass
class DepthBinTracker:
    """EMA over the per-step batch min / max teacher depth, the functional
    form of the reference's torchmetrics `DepthBins`
    (`manydepth/trainer.py:75-103`), with DualRefine's mean and median EMAs
    (`dualrefine/trainer.py:82-83,357-372`): write-only state in the
    reference, but its checkpoint carries them."""
    min_depth: Tensor     # ()
    max_depth: Tensor     # ()
    updated: Tensor       # () bool
    mean_depth: Tensor    # (), starts at 1
    median_depth: Tensor  # (), starts at 1

    @classmethod
    def create(cls, min_depth: float = 0.1, max_depth: float = 10.0,
               device=None) -> "DepthBinTracker":
        def scalar(v: float) -> Tensor:
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(scalar(min_depth), scalar(max_depth),
                   torch.zeros((), dtype=torch.bool, device=device),
                   scalar(1.0), scalar(1.0))

    def update(self, mono_depth: Tensor, opt_min_depth: float,
               ema: float = 0.99, track_stats: bool = False
               ) -> "DepthBinTracker":
        """mono_depth: (B, 1, H, W) teacher depth of the batch.

        `track_stats` adds the mean and median EMAs with the reference's
        quirks (`dualrefine/trainer.py:357-363`): the mean reduces batch
        element 0 only, the median is the batch mean of each image's median
        of its row medians, torch's lower median for even lengths.

        In a data-parallel step `mono_depth` is this rank's shard and the
        batch means are the global batch's; element 0 is rank 0's."""
        per_img_min = mono_depth.amin(dim=(1, 2, 3))
        per_img_max = mono_depth.amax(dim=(1, 2, 3))
        mn = (mesh.global_mean(per_img_min) * 0.9).clamp(min=opt_min_depth)
        mx = mesh.global_mean(per_img_max) * 1.1
        mean_d, median_d = self.mean_depth, self.median_depth
        if track_stats:
            d = mono_depth[:, 0]                                  # (B, H, W)
            row_med = d.median(dim=-1).values                     # (B, H)
            new_median = mesh.global_mean(row_med.median(dim=-1).values)
            mean_d = mean_d * ema + mesh.from_rank0(d[0].mean()) * (1.0 - ema)
            median_d = median_d * ema + new_median * (1.0 - ema)
        return DepthBinTracker(self.min_depth * ema + mn * (1.0 - ema),
                               self.max_depth * ema + mx * (1.0 - ema),
                               torch.ones_like(self.updated), mean_d, median_d)

    def load(self, extras: dict) -> None:
        """Set the statistics a checkpoint carries (`min_depth_bin`,
        `max_depth_bin` and, DualRefine's, `mean_depth_bin` /
        `median_depth_bin`), in place; marks the tracker updated."""
        with torch.no_grad():
            for field in ("min", "max", "mean", "median"):
                if f"{field}_depth_bin" in extras:
                    getattr(self, f"{field}_depth").fill_(
                        float(extras[f"{field}_depth_bin"]))
            self.updated.fill_(True)


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module   # MALModel, DynDepthModel or DEQDepthPose
    optimizer: torch.optim.Optimizer
    bins: DepthBinTracker
    balancer: LossBalancerState
    # DualRefine from `freeze_teacher_epoch`: the optimizer holds the
    # refinement student only (`make_optimizer(freeze_backbone=True)`)
    frozen_backbone: bool = False


def sanitize_grads(params) -> None:
    """Set non-finite gradient entries to 0 before Adam
    (`mal_tpu.train.state.sanitize_grads`): a degenerate projective sample
    can give a gradient whose square overflows Adam's second moment."""
    for p in params:
        if p.grad is not None:
            p.grad = torch.where(torch.isfinite(p.grad), p.grad, 0.0)


def apply_gradients(optimizer: torch.optim.Optimizer, lr: float,
                    clip_norm: float = 0.0) -> None:
    """One optimizer update at `lr` from the parameters' `.grad`, in
    optax's order (`mal_tpu/train/state.py:155-159`): the non-finite
    entries set to 0, then, with `clip_norm`, every gradient scaled by
    clip_norm / norm where their global norm reaches it
    (`optax.clip_by_global_norm`), then Adam. The norm covers the
    optimizer's parameters only, so a frozen sub-net, which it leaves out,
    does not count, as under `mal_tpu`'s `multi_transform`."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    sanitize_grads(params)
    if clip_norm:
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < clip_norm, 1.0, clip_norm / norm)
        for g in grads:
            g.mul_(scale)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


# DualRefine's refinement student (`depth_pose.py:84-87`: what
# freeze_backbone keeps training)
DUALREF_STUDENT = ("conv2", "context", "hidden", "update_block")


def trainable_parameters(cfg: Config, model: torch.nn.Module) -> list:
    """The parameters the optimizer updates: all but the top-level sub-nets
    that a freeze option keeps fixed (`mal_tpu/train/state.py:169-177`;
    `train_teacher_only` freezes the student, `dynamicdepth/trainer.py:
    138-141`, whose `reduce_conv` is part of `encoder` here)."""
    frozen: tuple[str, ...] = ()
    if cfg.freeze_teacher_and_pose:
        frozen = ("mono_encoder", "mono_depth", "pose_encoder", "pose")
    elif cfg.freeze_pose:
        frozen = ("pose_encoder", "pose")
    if cfg.train_teacher_only:
        frozen += ("encoder", "depth")
    return [p for name, p in model.named_parameters()
            if name.split(".")[0] not in frozen]


def make_optimizer(cfg: Config, model: torch.nn.Module,
                   freeze_backbone: bool = False) -> torch.optim.Adam:
    """Adam (optax's defaults: betas 0.9 / 0.999, eps 1e-8 outside the
    square root) over the trainable parameters. The train step sets the
    learning rate before each update; a frozen sub-net is left out, so it
    neither moves nor advances Adam's moments, as optax's `set_to_zero`
    partition does. `freeze_backbone` (DualRefine from
    `freeze_teacher_epoch`) trains the refinement student only,
    `DUALREF_STUDENT` (`mal_tpu/train/state.py:128-134`)."""
    make_schedule(cfg)   # raises for a schedule that does not exist
    return adam(student_parameters(model) if freeze_backbone
                else trainable_parameters(cfg, model), cfg.init_lr)


def adam(params: list, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def student_parameters(model: torch.nn.Module) -> list:
    """DualRefine's refinement student, what its frozen optimizer trains."""
    return [p for name, p in model.named_parameters()
            if name.split(".")[0] in DUALREF_STUDENT]


def create_train_state(cfg: Config, device: str | torch.device | None = None,
                       generator: torch.Generator | None = None,
                       init_weights: bool = True) -> TrainState:
    """A fresh state on `device` (default: the GPU, raising if there is
    none), with weights drawn from `generator` (default: seed 0; not with
    `init_weights=False`, for a state loaded next): a `MALModel`, or a
    `DynDepthModel` for `method="dynamicdepth"`, a `DEQDepthPose` for
    `method="dualrefine"`."""
    device = resolve_device(device)
    if cfg.method == "dualrefine":
        from mal_tpu_torch.dualref.model import DEQDepthPose

        model = DEQDepthPose(cfg, device=device, generator=generator,
                             init_weights=init_weights)
    elif cfg.method == "dynamicdepth":
        from mal_tpu_torch.dynamic.model import DynDepthModel

        model = DynDepthModel(cfg, device=device, generator=generator,
                              init_weights=init_weights)
    else:
        model = MALModel(cfg, device=device, generator=generator,
                         init_weights=init_weights)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model),
                      bins=DepthBinTracker.create(device=device),
                      balancer=LossBalancerState.create(device=device))
