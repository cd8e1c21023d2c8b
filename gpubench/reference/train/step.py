"""The MAL training step, copied from the port's `train/step.py` for the
reference: the ManyDepth + MAL path in one process on the global batch
(the port's pareto, remat, instance cache, data-parallel reductions,
DynamicDepth and DualRefine are not copied), the step
`mal_tpu_torch.train.step.make_train_step` makes for
`Config(temporal=..., distil=True, loss_blc=True)`."""

from __future__ import annotations

from typing import Callable

import torch

from gpubench.reference import geometry, losses
from gpubench.reference.config import Config
from gpubench.reference.device import resolve_device
from gpubench.reference.models.mal_model import MALModel, to_nchw
from gpubench.reference.ops.interp import grid_sample
from gpubench.reference.ops.precision import compute_dtype_of
from gpubench.reference.temporal import image_synthesis
from gpubench.reference.train.lr_schedule import make_schedule
from gpubench.reference.train.state import TrainState, apply_gradients

Tensor = torch.Tensor


def check_supported(cfg: Config, seg_fn: Callable | None = None) -> None:
    """Raise for what this copy does not run."""
    if (cfg.temporal or cfg.main_temporal) and seg_fn is None:
        raise ValueError("cfg.temporal requires a segmentation seg_fn")


def _all_photometric_warps(cfg: Config, batch: dict, outputs: dict,
                           depth_specs) -> list[list[Tensor]]:
    """Warped adjacent frames for each (depth (B, 1, H, W), detach_T) spec,
    sharing one back-projection per depth (`step.py:56-86`).

    In fast mode the frames are sampled from their bf16 roundings while the
    coordinates, the bilinear weights and the result stay fp32
    (`mal_tpu/train/step.py:67-84`). `F.grid_sample` takes one type for
    frame and grid, so the rounded frame is read back as fp32: the numbers
    of `mal_tpu`'s bf16 gather, without its halved traffic."""
    B, _, H, W = batch["color"]["0"].shape
    payload = compute_dtype_of(cfg.compute_dtype)
    out = []
    for depth, detach in depth_specs:
        points = geometry.backproject(depth, batch["inv_K"], H, W)
        warped = []
        for f in cfg.frame_ids[1:]:
            T = outputs[f"cam_T_cam/0/{f}"]
            if detach:
                T = T.detach()
            grid = geometry.project_3d(points, batch["K"], T, H, W)
            frame = batch["color"][str(f)]
            if payload is not None:
                frame = frame.to(payload).float()
            warped.append(grid_sample(frame, grid, padding_mode="border"))
        out.append(warped)
    return out


def make_loss_fn(cfg: Config, model: MALModel,
                 seg_fn: Callable | None = None) -> Callable:
    """`loss_fn(batch, min_d, max_d, balancer, epoch, aug_draw=None,
    noise=None, generator=None) -> (total, aux)`: the loss assembly of
    `Trainer.process_batch` (`manydepth/trainer.py:555-644`). Running it
    updates the BN statistics, as the forward of a training step does.

    aug_draw: (B,) uniform draw of the matching augmentation; noise:
    (B, 1, H, W) standard-normal automask tie-break draw. Each is drawn
    from `generator` when not given. `seg_fn(images (B, H, W, 3)) ->
    Instances` is the frozen segmenter of the temporal hint, required when
    `temporal` or `main_temporal` is on (`segment/mask2former.py:
    make_seg_fn`, or a test's stand-in).
    """
    check_supported(cfg, seg_fn)
    train_teacher = not cfg.freeze_teacher_and_pose
    train_pose = train_teacher and not cfg.freeze_pose
    reproj_fn = (losses.l1_reprojection_loss if cfg.no_ssim
                 else losses.reprojection_loss)

    def temporal_syn(warped: list[Tensor], inst_cur):
        """Synthesized frames from one pair of warped frames
        (`dyn_utils.py:121-170`); the segmenter sees them detached, and
        `inst_cur` is shared between the teacher's and the student's call.
        Returns the two frames and the (B,) items with a matched pair."""
        inst_last, inst_next = (seg_fn(w.detach().permute(0, 2, 3, 1))
                                for w in warped)
        syn_l, syn_n, has = image_synthesis(
            warped[0], warped[1], inst_cur, inst_last, inst_next,
            cfg.ins_threshold,
            payload_dtype=compute_dtype_of(cfg.compute_dtype))
        return [syn_l, syn_n], has

    def loss_fn(batch: dict, min_d: Tensor, max_d: Tensor,
                balancer: losses.LossBalancerState, epoch: float,
                aug_draw: Tensor | None = None, noise: Tensor | None = None,
                generator: torch.Generator | None = None):
        outputs = model(batch, min_d, max_d, aug_draw=aug_draw,
                        generator=generator, train=True,
                        train_teacher=train_teacher, train_pose=train_pose)
        # the current frame's instances, shared by both syntheses: one
        # segmenter forward
        inst_cur = None
        if cfg.temporal or cfg.main_temporal:
            inst_cur = seg_fn(batch["color"]["0"])
        batch = to_nchw(batch)
        color0 = batch["color"]["0"]
        identity = [batch["color"][str(f)] for f in cfg.frame_ids[1:]]
        mono_disp = outputs["mono_disp"].permute(0, 3, 1, 2)
        disp = outputs["disp"].permute(0, 3, 1, 2)

        _, mono_depth = geometry.disp_to_depth(mono_disp, cfg.min_depth,
                                               cfg.max_depth)
        _, multi_depth = geometry.disp_to_depth(disp, cfg.min_depth,
                                                cfg.max_depth)
        depth_specs = [(mono_depth, False), (multi_depth, True)]
        use_ens = cfg.distil and cfg.use_ensemble
        if use_ens:
            disp_ens = ((mono_disp + disp) / 2.0).detach()
            _, ens_depth = geometry.disp_to_depth(disp_ens, cfg.min_depth,
                                                  cfg.max_depth)
            depth_specs.append((ens_depth, True))
        warps = _all_photometric_warps(cfg, batch, outputs, depth_specs)

        # --- teacher ---
        if noise is None and not cfg.disable_automasking:
            noise = torch.randn(mono_depth.shape, generator=generator,
                                device=mono_depth.device)
        syn_items = torch.zeros((), device=color0.device)
        mono_syn = []
        if cfg.temporal:
            mono_syn, has = temporal_syn(warps[0], inst_cur)
            syn_items = syn_items + has.sum()
        mono_out = losses.mono_losses(
            noise, mono_disp, color0, warps[0], identity, syn=mono_syn,
            smoothness_weight=cfg.disparity_smoothness, reproj_fn=reproj_fn,
            avg_reprojection=cfg.avg_reprojection,
            disable_automasking=cfg.disable_automasking)

        # --- student ---
        mono_depth_sg = mono_depth.detach()
        if cfg.disable_motion_masking:
            cmask = torch.ones_like(outputs["consistency_mask"])
        else:
            cmask = outputs["consistency_mask"] * losses.matching_mask(
                mono_depth_sg, outputs["lowest_cost"])
        ens_reproj = None
        if use_ens:
            with torch.no_grad():
                ens_reproj = losses.min_reprojection(warps[2], color0,
                                                     reproj_fn=reproj_fn)
        multi_syn = []
        if cfg.main_temporal:
            multi_syn, has = temporal_syn(warps[1], inst_cur)
            syn_items = syn_items + has.sum()
        multi_out = losses.multi_losses(
            disp, color0, warps[1], multi_depth, mono_depth_sg, cmask,
            outputs["augmentation_mask"], mono_out.min_reproj.detach(),
            syn=multi_syn,
            ensemble_min_reproj=ens_reproj,
            dual_distil_mono_depth=mono_depth if cfg.dual_distil else None,
            smoothness_weight=cfg.disparity_smoothness, reproj_fn=reproj_fn,
            avg_reprojection=cfg.avg_reprojection)

        # --- total loss (`trainer.py:624-642`) ---
        ori_loss = multi_out.loss
        if train_teacher:
            ori_loss = ori_loss + mono_out.loss
        new_balancer = balancer
        if cfg.distil and cfg.loss_blc:
            lam = max(cfg.lambda_for_adjust_start
                      + float(epoch) * cfg.lambda_for_adjust_slope,
                      cfg.lambda_for_adjust_min)
            total, new_balancer = losses.loss_balance(
                balancer, torch.stack([ori_loss, multi_out.distil_loss]), lam)
            # the reference re-adds the weighted scalar once per batch item
            # (`loss_utils.py:303-312`), so the objective is B x the sum,
            # B the global batch
            total = total * color0.shape[0]
        elif cfg.distil:
            # the reference's plain-distil total counts the mono loss twice
            # (aliased "loss/0" / "loss" keys, `loss_utils.py:277-279`)
            total = multi_out.loss + multi_out.distil_loss
            if train_teacher:
                total = total + 2.0 * mono_out.loss
        else:
            total = ori_loss

        aux = {
            "balancer": new_balancer,
            "mono_depth": mono_depth_sg,
            "metrics": {
                "loss": total.detach(),
                "ori_loss": ori_loss.detach(),
                "mono_reproj": mono_out.reproj_loss.detach(),
                "multi_reproj": multi_out.reproj_loss.detach(),
                "consistency_loss": multi_out.consistency_loss.detach(),
                "distil_loss": multi_out.distil_loss.detach(),
                "w_ori": new_balancer.w[0],
                "w_distil": new_balancer.w[1],
                # items whose synthesis had a matched instance pair, summed
                # over the teacher's and the student's synthesis
                "syn_items": syn_items,
            },
        }
        return total, aux

    return loss_fn


def make_train_step(cfg: Config, device: str | torch.device | None = None,
                    seg_fn: Callable | None = None) -> Callable:
    """`train_step(state, batch, epoch=0.0, generator=None, draws=None)
    -> (state, metrics)` on `device` (default: the GPU, raising if there
    is none). `seg_fn` as in `make_loss_fn`.

    `draws` may hold "matching_aug" (B,) and "automask_noise" (B, 1, H, W)
    to inject the step's random draws. The learning rate of step n is the
    schedule at n, counted before the increment, as optax counts it (so
    step 0 trains at `init_lr`).
    """
    check_supported(cfg, seg_fn)
    device = resolve_device(device)
    train_teacher = not cfg.freeze_teacher_and_pose
    schedule = make_schedule(cfg)

    def train_step(state: TrainState, batch: dict, epoch: float = 0.0,
                   generator: torch.Generator | None = None,
                   draws: dict | None = None):
        if batch["K"].device != device:
            raise ValueError(f"batch is on {batch['K'].device}, the step "
                             f"runs on {device}")
        draws = draws or {}
        model = state.model
        loss_fn = make_loss_fn(cfg, model, seg_fn)

        model.zero_grad(set_to_none=True)
        total, aux = loss_fn(batch, state.bins.min_depth, state.bins.max_depth,
                             state.balancer, epoch,
                             aug_draw=draws.get("matching_aug"),
                             noise=draws.get("automask_noise"),
                             generator=generator)
        total.backward()
        apply_gradients(state.optimizer, schedule(state.step),
                        cfg.grad_clip_norm)

        # adaptive depth bins from the teacher (`trainer.py:631-634`)
        if cfg.adaptive_bins and train_teacher:
            state.bins = state.bins.update(aux["mono_depth"], cfg.min_depth,
                                           cfg.depth_bin_ema)
        state.balancer = aux["balancer"]
        state.step += 1
        metrics = dict(aux["metrics"])
        metrics["min_depth_bin"] = state.bins.min_depth
        metrics["max_depth_bin"] = state.bins.max_depth
        return state, metrics

    return train_step
