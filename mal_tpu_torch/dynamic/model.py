"""The DynamicDepth model (PyTorch): DOMD-warped inputs and the
occlusion-aware cost volume.

Counterpart of `mal_tpu.dynamic.model.DynDepthModel`, itself a re-design of
`dynamicdepth/trainer.py:86-905`: predict the poses, run the teacher,
forward-warp the dynamic objects into the adjacent frames with the teacher's
depth (DOMD, `domd.py`), then build the occlusion-aware cost volume over the
DOMD-processed lookup frame (`cost_volume.py`, kernel K6 on the card).

The sub-nets are `MALModel`'s, under its names: the matching encoder is the
port's `ResnetEncoderMatching` (`encoder.layer0.0`, ...,
`encoder.reduce_conv.0`), so the state dict keeps the reference layout;
only its matching step differs. The batch is `MALModel`'s plus `doj_mask`,
`doj_mask-1` and `doj_mask+1` (B, H, W), the dynamic-object masks; outputs
keep `mal_tpu`'s layouts (images and disparities channels-last).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mal_tpu_torch import geometry
from mal_tpu_torch.config import Config
from mal_tpu_torch.device import resolve_device
from mal_tpu_torch.dynamic.cost_volume import (
    occlusion_aware_cost_volume, occlusion_aware_cost_volume_kernel)
from mal_tpu_torch.dynamic.domd import domd_warp_inputs
from mal_tpu_torch.models.depth_decoder import DepthDecoder
from mal_tpu_torch.models.encoders import ResnetEncoder, ResnetEncoderMatching
from mal_tpu_torch.models.mal_model import init_like_flax, to_nchw
from mal_tpu_torch.models.pose_decoder import PoseDecoder
from mal_tpu_torch.ops.cost_volume import (compute_depth_bins,
                                           confidence_mask_from_cost,
                                           indices_to_disparity)
from mal_tpu_torch.ops.interp import resize_nearest
from mal_tpu_torch.ops.precision import compute_dtype_of

Tensor = torch.Tensor


class DynDepthModel(nn.Module):
    """The DynamicDepth model on `device` (default: the GPU, raising if
    there is none), weights drawn from `generator` (default: seed 0) on the
    CPU, then moved (not with `init_weights=False`, as `MALModel`).
    `cfg.compute_dtype="bfloat16"` runs the trunks and
    decoders in bf16, as `MALModel` does; the cost volume stays fp32."""

    def __init__(self, cfg: Config, device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 init_weights: bool = True):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dtype = compute_dtype_of(cfg.compute_dtype)
        self.encoder = ResnetEncoderMatching(cfg.num_layers, cfg.num_depth_bins,
                                             cfg.depth_binning, dtype)
        self.depth = DepthDecoder(self.encoder.num_ch_enc, dtype=dtype)
        self.mono_encoder = ResnetEncoder(18, dtype=dtype)
        self.mono_depth = DepthDecoder(self.mono_encoder.num_ch_enc,
                                       dtype=dtype)
        self.pose_encoder = ResnetEncoder(18, num_input_images=2, dtype=dtype)
        self.pose = PoseDecoder(self.pose_encoder.num_ch_enc[-1], 2, dtype)
        if init_weights:
            init_like_flax(self, generator or torch.Generator().manual_seed(0))
        self.to(device)

    def _pose_from_pair(self, img_a: Tensor, img_b: Tensor):
        axisangle, translation = self.pose(
            self.pose_encoder(torch.cat([img_a, img_b], dim=1))[-1])
        return axisangle[:, 0, 0], translation[:, 0, 0]

    def forward(self, inputs: dict, min_depth_bin: Tensor,
                max_depth_bin: Tensor, aug_draw: Tensor | None = None,
                generator: torch.Generator | None = None, train: bool = True,
                train_teacher: bool = True,
                is_train_phase: bool = True) -> dict:
        """`mal_tpu/dynamic/model.py:61-173`. The matching augmentation's
        uniform draw (B,) is `aug_draw` when given, else drawn from
        `generator`. `train` selects batch statistics in every BatchNorm
        (the teacher's only while it trains); `is_train_phase=False` (eval)
        leaves frame +1 unwarped."""
        cfg = self.cfg
        inputs = to_nchw(inputs)
        aug = inputs["color_aug"]
        B, _, H, W = aug["0"].shape
        self.pose_encoder.train(train)
        self.mono_encoder.train(train and train_teacher)
        self.encoder.train(train)
        outputs: dict[str, Tensor] = {}

        # photometric poses, and the matching pose, whose chain differs from
        # MALModel's (`mal_tpu/dynamic/model.py:70-83`)
        for f_i in cfg.frame_ids[1:]:
            pair = ((aug[str(f_i)], aug["0"]) if f_i < 0
                    else (aug["0"], aug[str(f_i)]))
            aa, t = self._pose_from_pair(*pair)
            outputs[f"cam_T_cam/0/{f_i}"] = \
                geometry.transformation_from_parameters(aa, t, invert=f_i < 0)
        with torch.no_grad():
            aa, t = self._pose_from_pair(aug["-1"], aug["0"])
            rel_m1 = geometry.transformation_from_parameters(aa, t, invert=True)
            missing = aug["-1"].abs().sum(dim=(1, 2, 3)) == 0
            rel_m1 = torch.where(missing[:, None, None], 0.0, rel_m1)
        outputs["relative_pose/-1"] = rel_m1
        lookup_frames = aug["-1"][:, None]                    # (B, 1, 3, H, W)
        relative_poses = rel_m1[:, None]

        # --- matching augmentation (`mal_tpu/dynamic/model.py:89-101`) ---
        if train and not cfg.no_matching_augmentation:
            if aug_draw is None:
                aug_draw = torch.rand(B, generator=generator,
                                      device=rel_m1.device)
            static_cam = aug_draw < cfg.aug_static_camera_p
            zero_cv = ~static_cam & (aug_draw < cfg.aug_static_camera_p
                                     + cfg.aug_zero_cost_volume_p)
            lookup_frames = torch.where(
                static_cam[:, None, None, None, None],
                inputs["color"]["0"][:, None], lookup_frames)
            relative_poses = torch.where(zero_cv[:, None, None, None], 0.0,
                                         relative_poses)
            aug_mask = (static_cam | zero_cv).to(torch.float32)
        else:
            aug_mask = torch.zeros(B, device=rel_m1.device)
        outputs["augmentation_mask"] = aug_mask[:, None, None, None]

        # --- teacher ---
        mono_disp = self.mono_depth(self.mono_encoder(aug["0"]))
        if not train_teacher:
            mono_disp = mono_disp.detach()
        outputs["mono_disp"] = mono_disp.permute(0, 2, 3, 1)

        # --- DOMD warp of the adjacent frames (`trainer.py:492-537`) ---
        color_m1, color_p1 = inputs["color"]["-1"], inputs["color"]["1"]
        if "doj_mask" in inputs and not cfg.no_warp:
            color_m1, color_p1, lookup_frames = domd_warp_inputs(
                cfg, inputs, mono_disp, outputs["cam_T_cam/0/-1"],
                outputs["cam_T_cam/0/1"], aug_mask, lookup_frames,
                is_train=is_train_phase)
        outputs["domd_color/-1"] = color_m1.permute(0, 2, 3, 1)
        outputs["domd_color/1"] = color_p1.permute(0, 2, 3, 1)

        # --- occlusion-aware cost volume ---
        enc = self.encoder
        feats = enc.feature_extraction(aug["0"])
        cur_feats = feats[-1]                                 # (B, 64, h, w)
        with torch.no_grad():
            lookup = enc.feature_extraction(lookup_frames.flatten(0, 1))[-1]
            lookup = lookup.permute(0, 2, 3, 1).unflatten(0, (B, -1))
            K2 = geometry.scale_intrinsics(inputs["K"], 2)
            inv_K2 = torch.linalg.inv_ex(K2).inverse
            bins = compute_depth_bins(min_depth_bin, max_depth_bin,
                                      cfg.num_depth_bins, cfg.depth_binning)
            args = (cur_feats.permute(0, 2, 3, 1), lookup, relative_poses,
                    K2, inv_K2, bins, lookup_frames, aug_mask)
            if not cfg.cv_pool:
                cost, missing_mask = occlusion_aware_cost_volume_kernel(
                    *args, cv_min=cfg.cv_min, set_1=cfg.cv_set_1,
                    pool_th=cfg.cv_pool_th)
            else:
                cost, missing_mask = occlusion_aware_cost_volume(
                    *args, cv_min=cfg.cv_min, set_1=cfg.cv_set_1, pool=True,
                    pool_r=cfg.cv_pool_radius, pool_th=cfg.cv_pool_th)
            confidence = confidence_mask_from_cost(cost, missing_mask)
            lowest_cost = indices_to_disparity(cost, bins)
            cost = cost * confidence[:, None]
        outputs["lowest_cost"] = resize_nearest(lowest_cost[:, None], H, W)[:, 0]
        outputs["consistency_mask"] = resize_nearest(
            confidence[:, None], H, W)[:, 0]

        y = enc.reduce_conv(torch.cat([cur_feats, cost.to(cur_feats.dtype)], 1))
        deep = []
        for layer in (enc.layer2, enc.layer3, enc.layer4):
            y = layer(y)
            deep.append(y)
        features = feats + deep
        # the 1/4-resolution tap of the feature-metric loss
        # (`dynamicdepth/trainer.py:594`: outputs["feat"] = features[-4])
        outputs["feat"] = features[-4].permute(0, 2, 3, 1)
        outputs["disp"] = self.depth(features).permute(0, 2, 3, 1)
        return outputs

    @torch.no_grad()
    def eval_forward(self, inputs: dict, min_depth_bin: Tensor,
                     max_depth_bin: Tensor) -> dict:
        """The forward as `mal_tpu/dynamic/evaluate.py:108-116` runs it:
        running BN statistics, no matching augmentation, frame +1 left
        unwarped."""
        self.eval()
        return self(inputs, min_depth_bin, max_depth_bin, train=False,
                    is_train_phase=False)


def doj_metrics(depth_pred: Tensor, depth_gt: Tensor, doj_mask: Tensor,
                min_depth: float = 1e-3, max_depth: float = 80.0) -> dict:
    """The seven depth metrics over the GT-valid pixels inside the
    dynamic-object mask (`dynamicdepth/trainer.py:1158-1255`)."""
    mask = (depth_gt > min_depth) & (depth_gt < max_depth) & (doj_mask > 0)
    pred = depth_pred.clamp(min_depth, max_depth)
    n = mask.sum()

    def m(x):
        return torch.where(mask, x, 0.0).sum() / n.clamp(min=1)

    thresh = torch.maximum(depth_gt / pred, pred / depth_gt)
    return {
        "doj/abs_rel": m((depth_gt - pred).abs() / depth_gt.clamp(min=1e-6)),
        "doj/sq_rel": m((depth_gt - pred) ** 2 / depth_gt.clamp(min=1e-6)),
        "doj/rmse": torch.sqrt(m((depth_gt - pred) ** 2)),
        "doj/a1": m((thresh < 1.25).to(torch.float32)),
        "doj/a2": m((thresh < 1.25 ** 2).to(torch.float32)),
        "doj/a3": m((thresh < 1.25 ** 3).to(torch.float32)),
        "doj/count": n,
    }
