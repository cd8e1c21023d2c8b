"""The DualRefine training step, frozen from the port's
`mal_tpu_torch/dualref/step.py`, a re-design of
`dualrefine/trainer.py:274-767` (process_batch, compute_losses,
compute_pose_update_losses), with the reference's default path and quirks:

- scales (0, 2, 3) over a normaliser of 4: scale 1 is skipped by an
  explicit `continue` (`trainer.py:547-548`) but counts in /num_scales;
  scales 0 and 2 supervise states 0..n_losses, scale 3 state 0 only;
- warps: the disparity upsampled to full resolution (bilinear), depth by
  `disp_to_depth`, frame -1 inverse-warped with the pixel-centre projection
  and `grid_sample(border, align_corners=False)` (`layers.py:216-226`);
  state 0 pairs with the initial pose T0, states > 0 with the refined T*;
- frame +1 (frame_ids (0, -1, 1)) warps with the pose-net-only pose, and
  the loss takes the per-pixel minimum over both frames;
- states > 0: the automask times the nearest-resized consistency mask, and
  the consistency term |D_k - detach(D_0)| on the complement;
- the accumulation quirk: `total_loss += loss` sits inside the state loop
  while `loss` accumulates over states (`trainer.py:624-632`), so state k
  counts (n_losses + 1 - k) times;
- the pose-update loss (`trainer.py:699-767`): T* warps frame -1 with the
  refined depth, with gradients, automasked, added on top;
- smoothness on the raw scale-s disparity against the scale-s colour
  (`color_s{2,3}` from the batch when present, else a bilinear resize of
  frame 0), weighted 1 / 2^s;
- the depth bins with the mean and median EMAs (`trainer.py:350-372`).

The automask tie-break noise (standard normal, scaled by 1e-5) is the
step's one (B, 1, H, W) draw, `draws["automask_noise"]`, which every
automask uses. One process on the global batch: every reduction over the
batch is the plain mean.
"""

from __future__ import annotations

from typing import Callable

import torch

from gpubench.reference import losses
from gpubench.reference.device import resolve_device
from gpubench.reference.dualrefine import geometry
from gpubench.reference.models.mal_model import to_nchw
from gpubench.reference.ops.interp import (grid_sample, resize_bilinear,
                                           resize_nearest)
from gpubench.reference.train.lr_schedule import make_schedule
from gpubench.reference.train.state import TrainState, apply_gradients

Tensor = torch.Tensor

NUM_SCALES = 4   # the reference's scales [0, 1, 2, 3]; scale 1 adds 0


def warp_frame_center(src: Tensor, depth: Tensor, T: Tensor, K: Tensor,
                      inv_K: Tensor) -> Tensor:
    """Inverse-warp `src` (B, 3, H, W) by depth (B, 1, H, W) and pose T with
    DualRefine's conventions: pixel-centre projection, border padding,
    align_corners=False."""
    B, _, H, W = src.shape
    points = geometry.backproject(depth, inv_K, H, W)
    grid = geometry.project_3d_center(points, K, T, H, W)
    return grid_sample(src, grid, padding_mode="border", align_corners=False)


def make_dualref_loss_fn(cfg, model) -> Callable:
    """`loss_fn(batch, noise) -> (total, aux)`, the reference's per-batch
    training loss; running it updates the BN statistics, as a training
    forward does. `batch` is the port's NHWC batch; `noise` the (B, 1, H,
    W) standard-normal draw."""
    use_p1 = len(cfg.frame_ids) > 2 and cfg.frame_ids[2] == 1
    n_losses = cfg.deq_n_losses

    def loss_fn(batch: dict, noise: Tensor):
        b = to_nchw(batch)
        aug, color = b["color_aug"], b["color"]
        out, (pose0, pose_star) = model(
            aug["0"], aug["-1"], b["K"], invert=True, train=True,
            image3=aug["1"] if use_p1 else None)
        pose_p1 = out.get("pose_p1")
        color0, colorm1 = color["0"], color["-1"]
        colorp1 = color["1"] if use_p1 else None
        B, _, H, W = color0.shape
        K, inv_K = b["K"], b["inv_K"]

        cmask_full = None
        if "consistency_mask" in out:
            cmask_full = resize_nearest(
                out["consistency_mask"].to(color0.dtype), H, W)
        ident_map = losses.reprojection_loss(colorm1, color0)
        if use_p1:
            ident_map = torch.minimum(
                ident_map, losses.reprojection_loss(colorp1, color0))

        def warp_p1(depth: Tensor, k: int) -> Tensor:
            T = pose_p1 if k == 0 else pose_p1.detach()
            return warp_frame_center(colorp1, depth, T, K, inv_K)

        state_depths: dict = {}

        def state_loss(scale: int, k: int):
            disp_s = out[f"disp_{scale}_{k}"]
            disp_full = (disp_s if disp_s.shape[-2] == H
                         else resize_bilinear(disp_s, H, W))
            _, depth = geometry.disp_to_depth(disp_full, cfg.min_depth,
                                              cfg.max_depth)
            T = pose0 if k == 0 else pose_star
            r = losses.reprojection_loss(
                warp_frame_center(colorm1, depth, T, K, inv_K), color0)
            if use_p1:
                r = torch.minimum(r, losses.reprojection_loss(
                    warp_p1(depth, k), color0))
            mask = losses.automask(r, ident_map + noise * 1e-5)
            consistency = torch.zeros((), device=color0.device)
            if k > 0:
                if cmask_full is not None:
                    mask = mask * cmask_full
                consistency = (
                    (depth - state_depths[(scale, 0)].detach()).abs()
                    * (1.0 - mask)).mean()
            reproj = losses.masked_mean(r, mask)
            if f"color_s{scale}" in b:
                color_s = b[f"color_s{scale}"].permute(0, 3, 1, 2)
            elif scale == 0:
                color_s = color0
            else:
                color_s = resize_bilinear(color0, H // 2 ** scale,
                                          W // 2 ** scale)
            sm = losses.normalized_smooth_loss(disp_s, color_s)
            return (reproj + consistency
                    + cfg.disparity_smoothness * sm / (2 ** scale),
                    reproj, depth, consistency)

        total = torch.zeros((), device=color0.device)
        metrics: dict = {}
        for scale in (0, 2, 3):
            loss_acc = torch.zeros((), device=color0.device)
            for k in (range(n_losses + 1) if scale < 3 else range(1)):
                L, reproj, depth, consistency = state_loss(scale, k)
                state_depths[(scale, k)] = depth
                loss_acc = loss_acc + L
                total = total + loss_acc      # the accumulation quirk
                if scale == 0:
                    metrics[f"reproj_{k}"] = reproj.detach()
                    if k > 0:
                        metrics["consistency_loss"] = consistency.detach()
        total = total / NUM_SCALES

        if cfg.disable_pose_updates:
            # skipped under --disable_pose_updates (`trainer.py:334-340`)
            pose_loss = torch.zeros((), device=color0.device)
        else:
            key = f"disp_0_{n_losses}"
            _, depth_p = geometry.disp_to_depth(
                out[key] if key in out else out["disp_0_0"], cfg.min_depth,
                cfg.max_depth)
            r_p = losses.reprojection_loss(
                warp_frame_center(colorm1, depth_p, pose_star, K, inv_K),
                color0)
            if use_p1:
                # frame +1's prediction here is the (scale 0, state 0) warp
                # (`trainer.py:715`)
                r_p = torch.minimum(r_p, losses.reprojection_loss(
                    warp_p1(state_depths[(0, 0)], 0), color0))
            m_p = losses.automask(r_p, ident_map + noise * 1e-5)
            pose_loss = losses.masked_mean(r_p, m_p)
            total = total + pose_loss

        metrics["pose_loss"] = pose_loss.detach()
        metrics.setdefault("consistency_loss",
                           torch.zeros((), device=color0.device))
        metrics["loss"] = total.detach()
        return total, {"depth0": state_depths[(0, 0)].detach(),
                       "metrics": metrics}

    return loss_fn


def fill_missing_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for each of the optimizer's parameters that the loss
    does not reach, so that Adam holds a state for every parameter and
    moves none of these."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_train_step(cfg, device: str | torch.device | None = None,
                    seg_fn=None) -> Callable:
    """`train_step(state, batch, epoch=0.0, generator=None, draws=None) ->
    (state, metrics)`, the ManyDepth reference's call, on `device`
    (default: the GPU, raising if there is none): the loss, its backward,
    `fill_missing_grads`, Adam at the schedule's rate, and the depth bins with the mean and
    median EMAs. `draws` holds "automask_noise" (B, 1, H, W)."""
    if seg_fn is not None:
        raise ValueError("DualRefine's step takes no segmenter")
    device = resolve_device(device)
    schedule = make_schedule(cfg)

    def train_step(state: TrainState, batch: dict, epoch: float = 0.0,
                   generator=None, draws: dict | None = None):
        del epoch, generator   # the draws come in `draws`
        if batch["K"].device != device:
            raise ValueError(f"batch is on {batch['K'].device}, the step "
                             f"runs on {device}")
        model = state.model
        model.zero_grad(set_to_none=True)
        total, aux = make_dualref_loss_fn(cfg, model)(
            batch, draws["automask_noise"])
        total.backward()
        fill_missing_grads(state.optimizer)
        apply_gradients(state.optimizer, schedule(state.step),
                        cfg.grad_clip_norm)
        if cfg.adaptive_bins:
            state.bins = state.bins.update(aux["depth0"], cfg.min_depth,
                                           cfg.depth_bin_ema)
        state.step += 1
        metrics = dict(aux["metrics"])
        metrics["min_depth_bin"] = state.bins.min_depth
        metrics["max_depth_bin"] = state.bins.max_depth
        return state, metrics

    return train_step
