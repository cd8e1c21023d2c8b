"""DOMD teacher warp: move the dynamic objects before the photometric and
cost-volume use of the adjacent frames.

Counterpart of `mal_tpu.dynamic.domd`, itself a re-design of the
DynamicDepth trainer's warp block (`dynamicdepth/trainer.py:492-537`):
forward-warp the dynamic-object pixels of frame 0 into frames -1 and +1 with
the teacher's depth and the predicted poses, blank the objects' old
positions by the precomputed `doj_mask-1` / `doj_mask+1`, and overwrite the
adjacent color frames (and the cost-volume lookup frames of the
non-augmented items). The reference runs it under `torch.no_grad()`.
"""

from __future__ import annotations

import torch

from mal_tpu_torch import geometry
from mal_tpu_torch.config import Config
from mal_tpu_torch.dynamic.warp import forward_warp, splat_depth

Tensor = torch.Tensor


@torch.no_grad()
def domd_warp_inputs(cfg: Config, batch: dict, teacher_disp: Tensor,
                     T_0m1: Tensor, T_0p1: Tensor, aug_mask: Tensor,
                     lookup_frames: Tensor, is_train: bool = True):
    """Returns (color_m1, color_p1, lookup_frames) with the DOMD warp
    applied.

    batch: NCHW images, with `doj_mask` (frame 0), `doj_mask-1` and
    `doj_mask+1`, each (B, H, W) in {0, 1}: the dynamic-object masks the
    reference loads from .npy files (`dynamicdepth/datasets/
    mono_dataset.py:105-110`). teacher_disp (B, 1, H, W); T_0m1 / T_0p1
    (B, 4, 4); aug_mask (B,); lookup_frames (B, F, 3, H, W).

    The splat depends on (depth, pose, K) only, so each pose is splatted
    once and shared by its warps (`mal_tpu/dynamic/domd.py:53,71,80`).
    `cfg.domd_splat_dilate=None` is the exact x3 splat: `mal_tpu` turns its
    dilated approximation on only for bf16 on a TPU.
    """
    _, teacher_depth = geometry.disp_to_depth(teacher_disp, cfg.min_depth,
                                              cfg.max_depth)
    teacher_depth = teacher_depth[:, 0]                   # (B, H, W)
    K3 = batch["K"][:, :3, :3]
    dilate = bool(cfg.domd_splat_dilate)

    doj0 = batch["doj_mask"][:, None]                     # (B, 1, H, W)
    tgt = batch["color"]["0"] * doj0                      # blank all but objects
    inv_m1 = splat_depth(teacher_depth, T_0m1, K3, dilate=dilate)

    def warp_into(T, doj_adj, color_adj, inv_map):
        img_w, _, _ = forward_warp(tgt, teacher_depth, T, K3, inv_map=inv_map)
        out = torch.where(doj_adj[:, None] == 1, 0.0, color_adj)
        # --no_reproj_doj (`dynamicdepth/trainer.py:507-511,530-534`) blanks
        # the warped objects' landing zone instead of filling it (the
        # lookup-frame branch below has no such gate in the reference)
        return torch.where(img_w > 0, 0.0 if cfg.no_reproj_doj else img_w,
                           out)

    color_m1 = warp_into(T_0m1, batch["doj_mask-1"], batch["color"]["-1"],
                         inv_m1)
    color_p1 = batch["color"]["1"]
    if is_train:
        inv_p1 = splat_depth(teacher_depth, T_0p1, K3, dilate=dilate)
        color_p1 = warp_into(T_0p1, batch["doj_mask+1"], batch["color"]["1"],
                             inv_p1)

    # the lookup frames of non-augmented items take the *augmented* current
    # frame's objects (`trainer.py:513-521`); the same pose as color_m1, so
    # the same splat
    tgt_aug = batch["color_aug"]["0"] * doj0
    img_w_aug, _, _ = forward_warp(tgt_aug, teacher_depth, T_0m1, K3,
                                   inv_map=inv_m1)
    warp_frame = lookup_frames[:, 0]
    warp_frame = torch.where(batch["doj_mask-1"][:, None] == 1, 0.0,
                             warp_frame)
    warp_frame = torch.where(img_w_aug > 0, img_w_aug, warp_frame)
    non_aug = (aug_mask == 0)[:, None, None, None, None]
    new_lookup = torch.where(non_aug, warp_frame[:, None], lookup_frames)
    return color_m1, color_p1, new_lookup
