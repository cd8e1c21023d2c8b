"""Self-supervised depth losses and the MAL hints (PyTorch, NCHW).

Counterpart of the parts of `mal_tpu.losses` that the ManyDepth+MAL step
reaches: SSIM+L1 reprojection with min-reprojection automasking
(`manydepth/loss_utils.py:27-55`), edge-aware smoothness
(`manydepth/layers.py:210-223`), the teacher and student losses with the
distillation hint (`manydepth/loss_utils.py:57-281`) and the two-term loss
balancer as a state object (`manydepth/loss_utils.py:283-345`).

Images and loss maps are channels-first here: images (B, 3, H, W), loss and
depth maps (B, 1, H, W), masks without a channel axis (B, H, W). The
automask tie-break noise is an argument, so that tests can feed the same
draws to both packages.

The reference steps on the global batch in one process, so every
reduction over the batch is the plain mean (the port's data-parallel
shares of it, `parallel/mesh.py`, are not copied).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from gpubench.reference.ops.ssim import ssim

Tensor = torch.Tensor


def reprojection_loss(pred: Tensor, target: Tensor) -> Tensor:
    """0.85 * SSIM + 0.15 * L1, averaged over channels -> (B, 1, H, W)."""
    l1 = (target - pred).abs().mean(dim=1, keepdim=True)
    s = ssim(pred, target).mean(dim=1, keepdim=True)
    return 0.85 * s + 0.15 * l1


def l1_reprojection_loss(pred: Tensor, target: Tensor) -> Tensor:
    """`--no_ssim` photometric loss (`manydepth/trainer.py:1217-1218`)."""
    return (target - pred).abs().mean(dim=1, keepdim=True)


def smooth_loss(disp: Tensor, img: Tensor) -> Tensor:
    """Edge-aware smoothness of a disparity map. Scalar."""
    grad_disp_x = (disp[:, :, :, :-1] - disp[:, :, :, 1:]).abs()
    grad_disp_y = (disp[:, :, :-1] - disp[:, :, 1:]).abs()
    grad_img_x = (img[:, :, :, :-1] - img[:, :, :, 1:]).abs().mean(1, keepdim=True)
    grad_img_y = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return grad_disp_x.mean() + grad_disp_y.mean()


def normalized_smooth_loss(disp: Tensor, img: Tensor) -> Tensor:
    mean_disp = disp.mean(dim=(2, 3), keepdim=True)
    return smooth_loss(disp / (mean_disp + 1e-7), img)


def automask(reproj: Tensor, identity: Tensor) -> Tensor:
    """1 where the warped reprojection beats the identity (static-scene)
    loss (`manydepth/loss_utils.py:27-44`)."""
    return (reproj <= identity).to(reproj.dtype)


def min_reprojection(preds: Sequence[Tensor], target: Tensor,
                     reproj_fn=reprojection_loss) -> Tensor:
    """Per-pixel min over the reprojection losses -> (B, 1, H, W)."""
    losses = torch.cat([reproj_fn(p, target) for p in preds], dim=1)
    return losses.amin(dim=1, keepdim=True)


def _reduce_sources(maps: Sequence[Tensor], avg: bool) -> Tensor:
    """The per-pixel min (mean with `avg`) over per-source loss maps."""
    stacked = torch.cat(list(maps), dim=1)
    if avg:
        return stacked.mean(dim=1, keepdim=True)
    return stacked.amin(dim=1, keepdim=True)


def masked_mean(values: Tensor, mask: Tensor, eps: float = 1e-7) -> Tensor:
    """sum(values x mask) / (sum(mask) + eps)."""
    return (values * mask).sum() / (mask.sum() + eps)


class MonoLossOut(NamedTuple):
    loss: Tensor          # scalar total (reproj + smooth)
    reproj_loss: Tensor   # scalar masked reprojection
    smooth: Tensor        # scalar smoothness
    min_reproj: Tensor    # (B, 1, H, W) min reprojection (for distillation)


def mono_losses(noise: Tensor | None, disp: Tensor, color: Tensor,
                warped: Sequence[Tensor], identity: Sequence[Tensor],
                syn: Sequence[Tensor] = (), smoothness_weight: float = 1e-3,
                reproj_fn=reprojection_loss,
                avg_reprojection: bool = False,
                disable_automasking: bool = False) -> MonoLossOut:
    """Teacher losses (`manydepth/loss_utils.py:57-129`).

    `noise` (B, 1, H, W) is a standard-normal draw; 1e-5 of it breaks the
    automask's ties, as `jax.random.normal(rng, ...) * 1e-5` does in
    `mal_tpu`. `syn`: the temporal hint's synthesized frames, extra
    min-reprojection candidates. `avg_reprojection` takes the per-pixel
    mean over source frames instead of the min (monodepth2's semantics).
    """
    reproj_maps = [reproj_fn(p, color) for p in list(warped) + list(syn)]
    reproj_min = _reduce_sources(reproj_maps, avg_reprojection)
    if disable_automasking:
        mask = torch.ones_like(reproj_min)
    else:
        identity_maps = [reproj_fn(p, color) for p in identity]
        ident_min = _reduce_sources(identity_maps, avg_reprojection)
        mask = automask(reproj_min, ident_min + noise * 1e-5)

    reproj = masked_mean(reproj_min, mask)
    sm = normalized_smooth_loss(disp, color)
    total = reproj + smoothness_weight * sm
    return MonoLossOut(total, reproj, sm, reproj_min)


class MultiLossOut(NamedTuple):
    loss: Tensor             # scalar (reproj + consistency + smooth)
    distil_loss: Tensor      # scalar distillation loss
    reproj_loss: Tensor
    consistency_loss: Tensor
    smooth: Tensor
    consistency_mask: Tensor  # (B, 1, H, W) 1 where consistency applies


def multi_losses(disp: Tensor, color: Tensor, warped: Sequence[Tensor],
                 multi_depth: Tensor, mono_depth: Tensor,
                 consistency_mask_in: Tensor, augmentation_mask: Tensor,
                 mono_min_reproj: Tensor, syn: Sequence[Tensor] = (),
                 ensemble_min_reproj: Tensor | None = None,
                 dual_distil_mono_depth: Tensor | None = None,
                 smoothness_weight: float = 1e-3, reproj_fn=reprojection_loss,
                 avg_reprojection: bool = False) -> MultiLossOut:
    """Student losses and the MAL distillation hint
    (`manydepth/loss_utils.py:131-281`).

    consistency_mask_in (B, H, W): cost-volume confidence x matching mask;
    augmentation_mask (B, 1, 1, 1); syn: the temporal hint's synthesized
    frames (`main_temporal`), extra min-reprojection candidates. The
    distillation target is the per-pixel argmin over the {mono, ensemble,
    multi} reprojection errors.
    """
    reproj_maps = [reproj_fn(p, color) for p in list(warped) + list(syn)]
    multi_min_reproj = _reduce_sources(reproj_maps, avg_reprojection)

    mask = consistency_mask_in[:, None] * (1.0 - augmentation_mask)
    consistency_mask = 1.0 - mask

    reproj = masked_mean(multi_min_reproj, mask)
    consistency = ((multi_depth - mono_depth).abs()
                   * consistency_mask).mean()
    sm = normalized_smooth_loss(disp, color)
    loss = reproj + consistency + smoothness_weight * sm

    # --- distillation hint ---
    if ensemble_min_reproj is None:
        all_reproj = torch.cat([mono_min_reproj, multi_min_reproj], dim=1)
        idx = all_reproj.argmin(dim=1, keepdim=True)
        mono_term = (dual_distil_mono_depth if dual_distil_mono_depth
                     is not None else mono_depth)
        distil_depth = torch.where(idx == 0, mono_term, multi_depth)
    else:
        all_reproj = torch.cat(
            [mono_min_reproj, ensemble_min_reproj, multi_min_reproj], dim=1)
        idx = all_reproj.argmin(dim=1, keepdim=True)
        ensemble_depth = (mono_depth + multi_depth) / 2.0
        distil_depth = torch.where(idx == 0, mono_depth, ensemble_depth)
        distil_depth = torch.where(idx == 2, multi_depth, distil_depth)

    distil = ((distil_depth - multi_depth).abs()
              * (1.0 - consistency_mask)).mean()
    return MultiLossOut(loss, distil, reproj, consistency, sm, consistency_mask)


def matching_mask(mono_depth: Tensor, lowest_cost_disp: Tensor) -> Tensor:
    """(B, H, W) mask where the argmin-cost depth and the teacher agree
    within 2x. mono_depth (B, 1, H, W); lowest_cost_disp (B, H, W).
    Reference: `manydepth/trainer.py:1066-1076`."""
    matching_depth = 1.0 / lowest_cost_disp[:, None]
    m = ((matching_depth - mono_depth) / mono_depth) < 1.0
    m &= ((mono_depth - matching_depth) / matching_depth) < 1.0
    return m[:, 0].to(mono_depth.dtype)


# ---------------------------------------------------------------------------
# Automatic two-term loss re-balancing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LossBalancerState:
    """Device-resident state of the ECCV'20-style two-loss re-balancer; the
    running sums give the reference's within-epoch mean of `train_scores`."""
    w: Tensor            # (2,) loss weights
    running_sum: Tensor  # (2,) per-loss sums this epoch
    count: Tensor        # () iterations accumulated
    prev_total: Tensor   # () previous weighted total loss
    prev_mean: Tensor    # (2,) previous per-loss cumulative means
    initialized: Tensor  # () bool

    @classmethod
    def create(cls, device=None) -> "LossBalancerState":
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(w=torch.full((2,), 0.5, device=device),
                   running_sum=zeros(2), count=zeros(), prev_total=zeros(),
                   prev_mean=zeros(2),
                   initialized=torch.zeros((), dtype=torch.bool, device=device))

def loss_balance(state: LossBalancerState, loss_list: Tensor,
                 lambda_adjust: Tensor | float):
    """Weighted total (keeps the gradient) and the updated balancer state.

    loss_list: (2,) [original_loss, distil_loss]; the statistics use
    detached values. lambda_adjust:
    max(start + epoch * slope, min) (`manydepth/trainer.py:458`).
    """
    total = state.w[0] * loss_list[0] + state.w[1] * loss_list[1]

    stats = loss_list.detach()
    running = state.running_sum + stats
    count = state.count + 1.0
    mean = running / count
    cur_total = (mean * state.w).sum()

    # first call: initialise the weights so that each term contributes 1/2
    w_init = cur_total * 0.5 / mean.clamp(min=1e-12)

    # later calls: bounded multiplicative adjustment
    has_prev = state.prev_total > 0
    ratio = torch.where(
        has_prev,
        (cur_total / state.prev_total.clamp(min=1e-12))
        * (state.prev_mean / mean.clamp(min=1e-12)),
        torch.ones_like(mean))
    adjust = (1.0 + lambda_adjust * (ratio - 1.0)).clamp(0.5, 2.0)
    w_adj = torch.where(has_prev, state.w * adjust, state.w)

    new_w = torch.where(state.initialized, w_adj, w_init)
    new_state = LossBalancerState(
        w=new_w, running_sum=running, count=count,
        prev_total=(mean * new_w).sum(), prev_mean=mean,
        initialized=torch.ones_like(state.initialized))
    return total, new_state
