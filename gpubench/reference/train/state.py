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

from gpubench.reference.config import Config
from gpubench.reference.device import resolve_device
from gpubench.reference.losses import LossBalancerState
from gpubench.reference.models.mal_model import MALModel

Tensor = torch.Tensor


@dataclasses.dataclass
class DepthBinTracker:
    """EMA over the per-step batch min / max teacher depth, the functional
    form of the reference's torchmetrics `DepthBins`
    (`manydepth/trainer.py:75-103`)."""
    min_depth: Tensor     # ()
    max_depth: Tensor     # ()
    updated: Tensor       # () bool

    @classmethod
    def create(cls, min_depth: float = 0.1, max_depth: float = 10.0,
               device=None) -> "DepthBinTracker":
        def scalar(v: float) -> Tensor:
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(scalar(min_depth), scalar(max_depth),
                   torch.zeros((), dtype=torch.bool, device=device))

    def update(self, mono_depth: Tensor, opt_min_depth: float,
               ema: float = 0.99) -> "DepthBinTracker":
        """mono_depth: (B, 1, H, W) teacher depth of the global batch."""
        per_img_min = mono_depth.amin(dim=(1, 2, 3))
        per_img_max = mono_depth.amax(dim=(1, 2, 3))
        mn = (per_img_min.mean() * 0.9).clamp(min=opt_min_depth)
        mx = per_img_max.mean() * 1.1
        return DepthBinTracker(self.min_depth * ema + mn * (1.0 - ema),
                               self.max_depth * ema + mx * (1.0 - ema),
                               torch.ones_like(self.updated))


@dataclasses.dataclass
class TrainState:
    step: int
    model: MALModel
    optimizer: torch.optim.Optimizer
    bins: DepthBinTracker
    balancer: LossBalancerState


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


def trainable_parameters(cfg: Config, model: torch.nn.Module) -> list:
    """The parameters the optimizer updates: all but the top-level sub-nets
    that a freeze option keeps fixed (`mal_tpu/train/state.py:169-177`)."""
    frozen: tuple[str, ...] = ()
    if cfg.freeze_teacher_and_pose:
        frozen = ("mono_encoder", "mono_depth", "pose_encoder", "pose")
    elif cfg.freeze_pose:
        frozen = ("pose_encoder", "pose")
    return [p for name, p in model.named_parameters()
            if name.split(".")[0] not in frozen]


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam (optax's defaults: betas 0.9 / 0.999, eps 1e-8 outside the
    square root) over the trainable parameters. The train step sets the
    learning rate before each update; a frozen sub-net is left out, so it
    neither moves nor advances Adam's moments, as optax's `set_to_zero`
    partition does."""
    return torch.optim.Adam(trainable_parameters(cfg, model), lr=cfg.init_lr,
                            betas=(0.9, 0.999), eps=1e-8)


def create_train_state(cfg: Config, device: str | torch.device | None = None
                       ) -> TrainState:
    """A fresh state on `device` (default: the GPU, raising if there is
    none): a `MALModel` with torch's default initialisation, whose weights
    the benchmark sets from the seed next."""
    device = resolve_device(device)
    model = MALModel(cfg, device=device)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model),
                      bins=DepthBinTracker.create(device=device),
                      balancer=LossBalancerState.create(device=device))
