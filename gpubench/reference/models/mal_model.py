"""The composed MAL multi-frame depth model (PyTorch).

Counterpart of `mal_tpu.models.mal_model.MALModel`, itself a re-design of
`manydepth/networks/repdepth.py:23-338` (`RepDepth`): the six sub-nets
(matching encoder, depth decoder, mono encoder / decoder, pose encoder /
decoder), photometric and gradient-free matching poses, the per-sample
matching augmentation, and the teacher and cost-volume student paths.

Batch format, as in `mal_tpu` (images NHWC):
  inputs = {
    "color":     {str(f): (B, H, W, 3)},   # non-augmented frames
    "color_aug": {str(f): (B, H, W, 3)},
    "K":         (B, 4, 4),                # full-resolution intrinsics
    "inv_K":     (B, 4, 4),
  }
Outputs keep `mal_tpu`'s layouts too: disparities (B, H, W, 1), the cost-
volume maps (B, H, W), poses (B, 4, 4). Inside, images are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gpubench.reference import geometry
from gpubench.reference.config import Config
from gpubench.reference.device import resolve_device
from gpubench.reference.models.depth_decoder import DepthDecoder
from gpubench.reference.models.encoders import ResnetEncoder, ResnetEncoderMatching
from gpubench.reference.models.pose_decoder import PoseDecoder
from gpubench.reference.ops.interp import resize_nearest
from gpubench.reference.ops.precision import compute_dtype_of

Tensor = torch.Tensor


def to_nchw(batch: dict) -> dict:
    """The batch with every image dict turned channels-first (B, 3, H, W)."""
    out = dict(batch)
    for key in ("color", "color_aug"):
        out[key] = {f: img.permute(0, 3, 1, 2).contiguous()
                    for f, img in batch[key].items()}
    return out


class MALModel(nn.Module):
    """The ManyDepth+MAL model on `device` (default: the GPU, raising if
    there is none), with torch's default initialisation: the benchmark sets
    every weight from the seed next (`traffic.fill_weights`).
    `cfg.compute_dtype="bfloat16"` (fast mode) runs the trunks and the
    decoders' convolutions in bf16 on fp32 parameters
    (`mal_tpu/models/mal_model.py:42`); the poses, the disparities and
    the cost volume stay fp32."""

    def __init__(self, cfg: Config, device: str | torch.device | None = None):
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

    # ------------------------------------------------------------------
    def _pose_from_pair(self, img_a: Tensor, img_b: Tensor):
        """Axis-angle + translation (B, 3) each from a temporally ordered pair."""
        stacked = torch.cat([img_a, img_b], dim=1)
        axisangle, translation = self.pose(self.pose_encoder(stacked)[-1])
        return axisangle[:, 0, 0], translation[:, 0, 0]

    def _matching_poses(self, color: dict, zero_missing: bool) -> dict:
        """Chained matching poses over the lookup frames (`repdepth.py:176-226`);
        an all-zero lookup image (a missing frame) gets an all-zero pose."""
        rel_pose: dict[int, Tensor] = {}
        for fi in self.cfg.matching_ids[1:]:
            if fi < 0:
                aa, t = self._pose_from_pair(color[str(fi)], color[str(fi + 1)])
                pose = geometry.transformation_from_parameters(aa, t, invert=True)
                if fi != -1:
                    pose = pose @ rel_pose[fi + 1]
            else:
                aa, t = self._pose_from_pair(color[str(fi - 1)], color[str(fi)])
                pose = geometry.transformation_from_parameters(aa, t)
                if fi != 1:
                    pose = pose @ rel_pose[fi - 1]
            if zero_missing:
                missing = color[str(fi)].abs().sum(dim=(1, 2, 3)) == 0
                pose = torch.where(missing[:, None, None],
                                   torch.zeros_like(pose), pose)
            rel_pose[fi] = pose
        return rel_pose

    def predict_poses(self, aug: dict) -> dict:
        """Photometric-loss poses and gradient-free matching poses
        (`repdepth.py:141-227`). aug: NCHW images by frame id."""
        outputs: dict[str, Tensor] = {}
        for f_i in self.cfg.frame_ids[1:]:
            if f_i < 0:
                aa, t = self._pose_from_pair(aug[str(f_i)], aug["0"])
            else:
                aa, t = self._pose_from_pair(aug["0"], aug[str(f_i)])
            outputs[f"cam_T_cam/0/{f_i}"] = \
                geometry.transformation_from_parameters(aa, t, invert=f_i < 0)
        with torch.no_grad():
            for fi, pose in self._matching_poses(aug, True).items():
                outputs[f"relative_pose/{fi}"] = pose
        return outputs

    # ------------------------------------------------------------------
    def forward(self, inputs: dict, min_depth_bin: Tensor,
                max_depth_bin: Tensor, aug_draw: Tensor | None = None,
                generator: torch.Generator | None = None, train: bool = True,
                train_teacher: bool = True, train_pose: bool = True) -> dict:
        """The training forward (`mal_model.py:134-188`).

        The matching augmentation's uniform draw (B,) is `aug_draw` when
        given, else drawn from `generator`. `train` selects batch statistics
        (and their EMA updates) in every BatchNorm; the teacher and the pose
        net use them only while they train.
        """
        cfg = self.cfg
        inputs = to_nchw(inputs)
        aug = inputs["color_aug"]
        B = aug["0"].shape[0]

        self.pose_encoder.train(train and train_teacher and train_pose)
        self.mono_encoder.train(train and train_teacher)
        self.encoder.train(train)

        outputs = self.predict_poses(aug)
        if not (train_teacher and train_pose):
            outputs = {k: v.detach() for k, v in outputs.items()}

        relative_poses = torch.stack(
            [outputs[f"relative_pose/{fi}"] for fi in cfg.matching_ids[1:]], 1)
        lookup_frames = torch.stack(
            [aug[str(fi)] for fi in cfg.matching_ids[1:]], 1)  # (B, F, 3, H, W)

        # --- matching augmentation (`repdepth.py:277-295`) ---
        if train and not cfg.no_matching_augmentation:
            if aug_draw is None:
                aug_draw = torch.rand(B, generator=generator,
                                      device=relative_poses.device)
            static_cam = aug_draw < cfg.aug_static_camera_p
            zero_cv = ~static_cam & (aug_draw < cfg.aug_static_camera_p
                                     + cfg.aug_zero_cost_volume_p)
            replace = inputs["color"]["0"][:, None].expand_as(lookup_frames)
            lookup_frames = torch.where(static_cam[:, None, None, None, None],
                                        replace, lookup_frames)
            relative_poses = torch.where(zero_cv[:, None, None, None],
                                         torch.zeros_like(relative_poses),
                                         relative_poses)
            aug_mask = (static_cam | zero_cv).to(torch.float32)
        else:
            aug_mask = torch.zeros(B, device=relative_poses.device)
        outputs["augmentation_mask"] = aug_mask[:, None, None, None]

        # --- teacher (mono) path ---
        mono_disp = self.mono_depth(self.mono_encoder(aug["0"]))
        if not train_teacher:
            mono_disp = mono_disp.detach()
        outputs["mono_disp"] = mono_disp.permute(0, 2, 3, 1)

        # --- student (multi-frame cost volume) path ---
        K2 = geometry.scale_intrinsics(inputs["K"], 2)
        inv_K2 = torch.linalg.inv_ex(K2).inverse
        features, lowest_cost, confidence = self.encoder(
            aug["0"], lookup_frames, relative_poses, K2, inv_K2,
            min_depth_bin, max_depth_bin)
        outputs["disp"] = self.depth(features).permute(0, 2, 3, 1)

        H, W = cfg.height, cfg.width
        outputs["lowest_cost"] = resize_nearest(lowest_cost[:, None], H, W)[:, 0]
        outputs["consistency_mask"] = resize_nearest(
            confidence[:, None], H, W)[:, 0]
        return outputs
