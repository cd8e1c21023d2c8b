"""The DynamicDepth training step (PyTorch).

Counterpart of `mal_tpu.dynamic.step`, itself a functional re-design of
`dynamicdepth/trainer.py:432-660` (`process_batch`): the teacher's and the
student's photometric losses run over the DOMD-processed adjacent frames
(objects moved to their warped positions, old positions blanked), so that
dynamic objects stop breaking the static-scene assumption. No loss
balancer: the total is the student's loss, the teacher's unless `tempv2`
drops it, and the distillation and feature-metric terms when on.

Random draws as in `mal_tpu_torch.train.step`: the matching augmentation's
uniform and the automask noise come from `generator`, or from `draws`.
"""

from __future__ import annotations

from typing import Callable

import torch

from mal_tpu_torch import geometry, losses
from mal_tpu_torch.config import Config
from mal_tpu_torch.device import resolve_device
from mal_tpu_torch.dynamic.model import DynDepthModel
from mal_tpu_torch.models.mal_model import to_nchw
from mal_tpu_torch.parallel import mesh
from mal_tpu_torch.train.lr_schedule import make_schedule
from mal_tpu_torch.train.state import TrainState, apply_gradients
from mal_tpu_torch.train.step import check_supported, data_parallel, warp_frame

Tensor = torch.Tensor


def make_dynamic_loss_fn(cfg: Config, model: DynDepthModel,
                         doj_fn: Callable | None = None) -> Callable:
    """`loss_fn(batch, min_d, max_d, aug_draw=None, noise=None,
    generator=None) -> (total, aux)`: the loss assembly of
    `mal_tpu/dynamic/step.py:39-166`. Running it updates the BN statistics,
    as the forward of a training step does. aug_draw (B,) and noise
    (B, 1, H, W) as in `mal_tpu_torch.train.step.make_loss_fn`.

    `doj_fn(images (B, H, W, 3)) -> (B, H, W)` makes the dynamic-object
    masks online (`cfg.online_doj`, `segment/doj.py:make_doj_fn`) in place
    of the dataset's precomputed ones: `doj_mask` and `doj_mask{f:+d}` of
    each adjacent frame, before the model runs
    (`mal_tpu/dynamic/step.py:25-45`)."""
    check_supported(cfg)
    if cfg.online_doj and doj_fn is None:
        raise ValueError("cfg.online_doj requires a doj_fn "
                         "(segment/doj.py:make_doj_fn)")
    train_teacher = not cfg.freeze_teacher_and_pose

    def loss_fn(batch: dict, min_d: Tensor, max_d: Tensor,
                aug_draw: Tensor | None = None, noise: Tensor | None = None,
                generator: torch.Generator | None = None):
        if doj_fn is not None:
            batch = dict(batch)
            batch["doj_mask"] = doj_fn(batch["color"]["0"])
            for f in cfg.frame_ids[1:]:
                batch[f"doj_mask{f:+d}"] = doj_fn(batch["color"][str(f)])
        outputs = model(batch, min_d, max_d, aug_draw=aug_draw,
                        generator=generator, train=True,
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
                out.append(warp_frame(src, depth, T.detach() if detach else T,
                                      nb["K"], nb["inv_K"]))
            return out

        identity = [adj[f] for f in cfg.frame_ids[1:]]
        # under the reference's default no_teacher_warp (store_false, so
        # True) the teacher warps and compares the `ori_color` frames:
        # frame -1 untouched, and as "+1" the DOMD'd frame -1, an upstream
        # copy-paste (`trainer.py:504-505,528-529,936-955`); only the
        # student sees the DOMD'd frames
        mono_sources = identity
        if (cfg.no_teacher_warp and not cfg.train_teacher_only
                and not cfg.no_warp and "doj_mask" in batch):
            mono_sources = [nb["color"]["-1"], adj[-1]]
        mono_warped = warps(mono_sources, mono_depth, False)
        multi_warped = warps(identity, multi_depth, True)

        if noise is None and not cfg.disable_automasking:
            noise = torch.randn(mono_depth.shape, generator=generator,
                                device=mono_depth.device)
        maps = {}
        if cfg.zero_img:
            # the reference's zero_img mutates the shared frame-0 target in
            # call order: teacher warps, teacher identity (the smoothness
            # sees the result), student warps (`trainer.py:958-966`)
            w_maps, tgt = losses.zero_img_reproj_sequence(color0, mono_warped)
            i_maps, tgt = losses.zero_img_reproj_sequence(tgt, mono_sources)
            maps = {"reproj_maps": w_maps, "identity_maps": i_maps,
                    "smooth_color": tgt}
        mono_out = losses.mono_losses(
            noise, mono_disp, color0, mono_warped, mono_sources,
            smoothness_weight=cfg.disparity_smoothness,
            disable_automasking=cfg.disable_automasking,
            selec_reproj=cfg.selec_reproj, **maps)

        mono_depth_sg = mono_depth.detach()
        if cfg.disable_motion_masking:
            cmask = torch.ones_like(outputs["consistency_mask"])
        else:
            cmask = outputs["consistency_mask"] * losses.matching_mask(
                mono_depth_sg, outputs["lowest_cost"])
        maps = {}
        if cfg.zero_img:
            # the student's automask is replaced by ones x consistency, so
            # its identity maps go unused
            mw_maps, tgt = losses.zero_img_reproj_sequence(tgt, multi_warped)
            maps = {"reproj_maps": mw_maps, "smooth_color": tgt}
        multi_out = losses.multi_losses(
            disp, color0, multi_warped, multi_depth, mono_depth_sg, cmask,
            outputs["augmentation_mask"], mono_out.min_reproj.detach(),
            smoothness_weight=cfg.disparity_smoothness,
            selec_reproj=cfg.selec_reproj, **maps)

        # the teacher-loss merge (`trainer.py:631-643`): tempv2 drops the
        # teacher's losses; no_multi_loss replaces the student's with them
        total = multi_out.loss
        if train_teacher and not cfg.tempv2:
            total = mono_out.loss if cfg.no_multi_loss else total + mono_out.loss
        if cfg.distil:
            total = total + multi_out.distil_loss
        feat_l = torch.zeros((), device=total.device)
        if cfg.feat_loss:
            feat_l = losses.feature_metric_loss(
                outputs["feat"].permute(0, 3, 1, 2), color0, cfg.feat_dis,
                cfg.feat_cvt)
            total = total + feat_l

        aux = {"mono_depth": mono_depth_sg,
               "metrics": {
                   "loss": total.detach(),
                   "mono_reproj": mono_out.reproj_loss.detach(),
                   "multi_reproj": multi_out.reproj_loss.detach(),
                   "consistency_loss": multi_out.consistency_loss.detach(),
                   "distil_loss": multi_out.distil_loss.detach(),
                   "feat_loss": feat_l.detach(),
               }}
        return total, aux

    return loss_fn


def make_dynamic_train_step(cfg: Config,
                            device: str | torch.device | None = None,
                            doj_fn: Callable | None = None) -> Callable:
    """`train_step(state, batch, epoch=0.0, generator=None, draws=None)
    -> (state, metrics)` on `device` (default: the GPU, raising if there is
    none), with `state.model` a `DynDepthModel`, `draws` as in
    `mal_tpu_torch.train.step.make_train_step` and `doj_fn` as in
    `make_dynamic_loss_fn`. The depth bins follow the teacher only while it
    trains (`mal_tpu/dynamic/step.py:191-195`)."""
    device = resolve_device(device)
    make_dynamic_loss_fn(cfg, None, doj_fn)   # raises for what is refused
    train_teacher = not cfg.freeze_teacher_and_pose
    schedule = make_schedule(cfg)

    @data_parallel(cfg)
    def train_step(state: TrainState, batch: dict, epoch: float = 0.0,
                   generator: torch.Generator | None = None,
                   draws: dict | None = None):
        del epoch   # no balancer, no epoch-dependent schedule
        if batch["K"].device != device:
            raise ValueError(f"batch is on {batch['K'].device}, the step "
                             f"runs on {device}")
        draws = draws or {}
        model = state.model
        model.zero_grad(set_to_none=True)
        total, aux = make_dynamic_loss_fn(cfg, model, doj_fn)(
            batch, state.bins.min_depth, state.bins.max_depth,
            aug_draw=draws.get("matching_aug"),
            noise=draws.get("automask_noise"), generator=generator)
        total.backward()
        mesh.all_reduce_grads(model.parameters())
        apply_gradients(state.optimizer, schedule(state.step),
                        cfg.grad_clip_norm)
        if cfg.adaptive_bins and train_teacher:
            state.bins = state.bins.update(aux["mono_depth"], cfg.min_depth,
                                           cfg.depth_bin_ema)
        state.step += 1
        metrics = mesh.sum_metrics(aux["metrics"])
        metrics["min_depth_bin"] = state.bins.min_depth
        metrics["max_depth_bin"] = state.bins.max_depth
        return state, metrics

    return train_step
