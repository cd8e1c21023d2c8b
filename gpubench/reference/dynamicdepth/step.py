"""The DynamicDepth training step, copied from the port's
`mal_tpu_torch/dynamic/step.py` (`dynamicdepth/trainer.py:432-660`): the
teacher's and the student's photometric losses over the DOMD-processed
adjacent frames, the distillation hint, Adam, and the depth bins' EMA from
the teacher. No loss balancer: the total is the student's loss, the
teacher's unless `tempv2` drops it, and the distillation term."""

from __future__ import annotations

import torch

from gpubench.reference import geometry, losses
from gpubench.reference.device import resolve_device
from gpubench.reference.dynamicdepth import losses as dyn_losses
from gpubench.reference.models.mal_model import to_nchw
from gpubench.reference.train.lr_schedule import make_schedule
from gpubench.reference.train.state import TrainState, apply_gradients

Tensor = torch.Tensor


def make_dynamic_loss_fn(cfg, model):
    """`loss_fn(batch, min_d, max_d, aug_draw, noise) -> (total, aux)`,
    aug_draw (B,) and noise (B, 1, H, W) the step's draws. Running it
    updates the BN statistics, as a training step's forward does."""
    train_teacher = not cfg.freeze_teacher_and_pose

    def loss_fn(batch: dict, min_d: Tensor, max_d: Tensor, aug_draw: Tensor,
                noise: Tensor):
        outputs = model(batch, min_d, max_d, aug_draw,
                        train_teacher=train_teacher)
        nb = to_nchw(batch)
        color0 = nb["color"]["0"]
        adj = {f: outputs[f"domd_color/{f}"].permute(0, 3, 1, 2)
               for f in (-1, 1)}
        mono_disp = outputs["mono_disp"].permute(0, 3, 1, 2)
        disp = outputs["disp"].permute(0, 3, 1, 2)
        _, mono_depth = geometry.disp_to_depth(mono_disp, cfg.min_depth,
                                               cfg.max_depth)
        _, multi_depth = geometry.disp_to_depth(disp, cfg.min_depth,
                                                cfg.max_depth)

        def warps(sources, depth, detach):
            out = []
            for src, f in zip(sources, cfg.frame_ids[1:]):
                T = outputs[f"cam_T_cam/0/{f}"]
                out.append(dyn_losses.warp_frame(
                    src, depth, T.detach() if detach else T, nb["K"],
                    nb["inv_K"]))
            return out

        identity = [adj[f] for f in cfg.frame_ids[1:]]
        # under the default no_teacher_warp the teacher warps and compares
        # frame -1 untouched and, as "+1", the DOMD'd frame -1 (an upstream
        # copy-paste, `trainer.py:504-505,528-529,936-955`)
        mono_sources = identity
        if cfg.no_teacher_warp and not cfg.no_warp and "doj_mask" in batch:
            mono_sources = [nb["color"]["-1"], adj[-1]]
        mono_warped = warps(mono_sources, mono_depth, False)
        multi_warped = warps(identity, multi_depth, True)

        maps = {}
        if cfg.zero_img:
            # the reference mutates the frame-0 target in call order:
            # teacher warps, teacher identity, student warps
            w_maps, tgt = dyn_losses.zero_img_reproj_sequence(color0,
                                                              mono_warped)
            i_maps, tgt = dyn_losses.zero_img_reproj_sequence(tgt,
                                                              mono_sources)
            maps = {"reproj_maps": w_maps, "identity_maps": i_maps,
                    "smooth_color": tgt}
        mono_out = dyn_losses.mono_losses(
            noise, mono_disp, color0, mono_warped, mono_sources,
            cfg.disparity_smoothness, cfg.disable_automasking,
            cfg.selec_reproj, **maps)

        mono_depth_sg = mono_depth.detach()
        if cfg.disable_motion_masking:
            cmask = torch.ones_like(outputs["consistency_mask"])
        else:
            cmask = outputs["consistency_mask"] * losses.matching_mask(
                mono_depth_sg, outputs["lowest_cost"])
        maps = {}
        if cfg.zero_img:
            mw_maps, tgt = dyn_losses.zero_img_reproj_sequence(tgt,
                                                               multi_warped)
            maps = {"reproj_maps": mw_maps, "smooth_color": tgt}
        multi_out = dyn_losses.multi_losses(
            disp, color0, multi_warped, multi_depth, mono_depth_sg, cmask,
            outputs["augmentation_mask"], mono_out.min_reproj.detach(),
            cfg.disparity_smoothness, cfg.selec_reproj, **maps)

        # the teacher-loss merge (`trainer.py:631-643`)
        total = multi_out.loss
        if train_teacher and not cfg.tempv2:
            total = mono_out.loss if cfg.no_multi_loss else total + mono_out.loss
        if cfg.distil:
            total = total + multi_out.distil_loss
        return total, {"mono_depth": mono_depth_sg,
                       "metrics": {"loss": total.detach()}}

    return loss_fn


def make_train_step(cfg, device: str | torch.device | None = None,
                    seg_fn=None):
    """`train_step(state, batch, epoch=0.0, generator=None, draws=None)
    -> (state, metrics)`, the ManyDepth reference's call, with `draws`
    holding "matching_aug" (B,) and "automask_noise" (B, 1, H, W). The
    depth bins follow the teacher only while it trains."""
    if seg_fn is not None:
        raise ValueError("DynamicDepth's step takes no segmenter: its masks "
                         "come with the batch")
    device = resolve_device(device)
    train_teacher = not cfg.freeze_teacher_and_pose
    schedule = make_schedule(cfg)

    def train_step(state: TrainState, batch: dict, epoch: float = 0.0,
                   generator=None, draws: dict | None = None):
        del epoch, generator   # no balancer; the draws come in `draws`
        if batch["K"].device != device:
            raise ValueError(f"batch is on {batch['K'].device}, the step "
                             f"runs on {device}")
        model = state.model
        model.zero_grad(set_to_none=True)
        total, aux = make_dynamic_loss_fn(cfg, model)(
            batch, state.bins.min_depth, state.bins.max_depth,
            draws["matching_aug"], draws["automask_noise"])
        total.backward()
        apply_gradients(state.optimizer, schedule(state.step),
                        cfg.grad_clip_norm)
        if cfg.adaptive_bins and train_teacher:
            state.bins = state.bins.update(aux["mono_depth"], cfg.min_depth,
                                           cfg.depth_bin_ema)
        state.step += 1
        metrics = dict(aux["metrics"])
        metrics["min_depth_bin"] = state.bins.min_depth
        metrics["max_depth_bin"] = state.bins.max_depth
        return state, metrics

    return train_step
