"""The DynamicDepth model, copied from the port's
`mal_tpu_torch/dynamic/model.py` (`dynamicdepth/trainer.py:86-905`):
predict the poses, run the teacher, forward-warp the dynamic objects into
the adjacent frames with the teacher's depth (DOMD, `domd.py`), then build
the occlusion-aware cost volume over the DOMD-processed lookup frame with
the plain twin (`cost_volume.py`) where the port launches K6.

The sub-nets are the ManyDepth reference's, under the port's names and in
its order, so that `traffic.fill_weights` sets both sides alike. The batch
is the ManyDepth batch plus `doj_mask`, `doj_mask-1` and `doj_mask+1`
(B, H, W); images and disparities come out channels-last."""

from __future__ import annotations

import torch
import torch.nn as nn

from gpubench.reference import geometry
from gpubench.reference.device import resolve_device
from gpubench.reference.dynamicdepth.cost_volume import (
    occlusion_aware_cost_volume)
from gpubench.reference.dynamicdepth.domd import domd_warp_inputs
from gpubench.reference.models.depth_decoder import DepthDecoder
from gpubench.reference.models.encoders import (ResnetEncoder,
                                                ResnetEncoderMatching)
from gpubench.reference.models.mal_model import to_nchw
from gpubench.reference.models.pose_decoder import PoseDecoder
from gpubench.reference.ops.cost_volume import (compute_depth_bins,
                                                confidence_mask_from_cost,
                                                indices_to_disparity)
from gpubench.reference.ops.interp import resize_nearest
from gpubench.reference.ops.precision import compute_dtype_of

Tensor = torch.Tensor


def matching_augmentation(cfg, aug_draw: Tensor):
    """The matching augmentation (`trainer.py:365-390`) from its uniform
    draw (B,): (static_cam, zero_cv, aug_mask), the items whose lookup
    frame is frame 0 itself, those whose matching pose is zeroed, and 1.0
    where either holds (no occlusion handling there)."""
    if cfg.no_matching_augmentation:
        none = torch.zeros_like(aug_draw, dtype=torch.bool)
        return none, none, none.to(torch.float32)
    static_cam = aug_draw < cfg.aug_static_camera_p
    zero_cv = ~static_cam & (aug_draw < cfg.aug_static_camera_p
                             + cfg.aug_zero_cost_volume_p)
    return static_cam, zero_cv, (static_cam | zero_cv).to(torch.float32)


class DynDepthModel(nn.Module):
    """The DynamicDepth model on `device`, with torch's default
    initialisation: the benchmark sets every weight from the seed next."""

    def __init__(self, cfg, device: str | torch.device | None = None):
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
        self.to(device)

    def _pose_from_pair(self, img_a: Tensor, img_b: Tensor):
        axisangle, translation = self.pose(
            self.pose_encoder(torch.cat([img_a, img_b], dim=1))[-1])
        return axisangle[:, 0, 0], translation[:, 0, 0]

    def forward(self, inputs: dict, min_depth_bin: Tensor,
                max_depth_bin: Tensor, aug_draw: Tensor,
                train_teacher: bool = True) -> dict:
        """The training forward, every BatchNorm on batch statistics, with
        the matching augmentation's uniform draw `aug_draw` (B,)."""
        cfg = self.cfg
        inputs = to_nchw(inputs)
        aug = inputs["color_aug"]
        B, _, H, W = aug["0"].shape
        self.pose_encoder.train(True)
        self.mono_encoder.train(train_teacher)
        self.encoder.train(True)
        outputs: dict[str, Tensor] = {}

        # the photometric poses, and the matching pose from frame -1
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

        static_cam, zero_cv, aug_mask = matching_augmentation(cfg, aug_draw)
        lookup_frames = torch.where(static_cam[:, None, None, None, None],
                                    inputs["color"]["0"][:, None],
                                    lookup_frames)
        relative_poses = torch.where(zero_cv[:, None, None, None], 0.0,
                                     relative_poses)
        outputs["augmentation_mask"] = aug_mask[:, None, None, None]

        # the teacher
        mono_disp = self.mono_depth(self.mono_encoder(aug["0"]))
        if not train_teacher:
            mono_disp = mono_disp.detach()
        outputs["mono_disp"] = mono_disp.permute(0, 2, 3, 1)

        # the DOMD warp of the adjacent frames (`trainer.py:492-537`)
        color_m1, color_p1 = inputs["color"]["-1"], inputs["color"]["1"]
        if "doj_mask" in inputs and not cfg.no_warp:
            color_m1, color_p1, lookup_frames = domd_warp_inputs(
                cfg, inputs, mono_disp, outputs["cam_T_cam/0/-1"],
                outputs["cam_T_cam/0/1"], aug_mask, lookup_frames)
        outputs["domd_color/-1"] = color_m1.permute(0, 2, 3, 1)
        outputs["domd_color/1"] = color_p1.permute(0, 2, 3, 1)

        # the occlusion-aware cost volume
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
            cost, missing_mask = occlusion_aware_cost_volume(
                cur_feats.permute(0, 2, 3, 1), lookup, relative_poses, K2,
                inv_K2, bins, lookup_frames, aug_mask, cv_min=cfg.cv_min,
                set_1=cfg.cv_set_1, pool=cfg.cv_pool,
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
        outputs["disp"] = self.depth(feats + deep).permute(0, 2, 3, 1)
        return outputs
