"""The DOMD warp, copied from the port's `mal_tpu_torch/dynamic/domd.py`
(`dynamicdepth/trainer.py:492-537`): forward-warp the dynamic-object
pixels of frame 0 into frames -1 and +1 with the teacher's depth and the
predicted poses, blank the objects' old positions by `doj_mask-1` /
`doj_mask+1`, and overwrite the adjacent frames and the cost volume's
lookup frames of the items whose matching was not augmented. Each pose is
splatted once and shared by its warps."""

from __future__ import annotations

import torch

from gpubench.reference import geometry
from gpubench.reference.dynamicdepth.warp import forward_warp, splat_depth

Tensor = torch.Tensor


@torch.no_grad()
def domd_warp_inputs(cfg, batch: dict, teacher_disp: Tensor, T_0m1: Tensor,
                     T_0p1: Tensor, aug_mask: Tensor, lookup_frames: Tensor,
                     is_train: bool = True):
    """(color_m1, color_p1, lookup_frames) with the DOMD warp applied.
    batch: NCHW frames with `doj_mask`, `doj_mask-1`, `doj_mask+1`, each
    (B, H, W) in {0, 1}; teacher_disp (B, 1, H, W); T_0m1 / T_0p1
    (B, 4, 4); aug_mask (B,); lookup_frames (B, F, 3, H, W)."""
    _, teacher_depth = geometry.disp_to_depth(teacher_disp, cfg.min_depth,
                                              cfg.max_depth)
    teacher_depth = teacher_depth[:, 0]                   # (B, H, W)
    K3 = batch["K"][:, :3, :3]

    doj0 = batch["doj_mask"][:, None]                     # (B, 1, H, W)
    tgt = batch["color"]["0"] * doj0                      # all but objects blank
    inv_m1 = splat_depth(teacher_depth, T_0m1, K3)

    def warp_into(T, doj_adj, color_adj, inv_map):
        img_w, _, _ = forward_warp(tgt, T, K3, inv_map)
        out = torch.where(doj_adj[:, None] == 1, 0.0, color_adj)
        # --no_reproj_doj blanks the warped objects' landing zone instead of
        # filling it (`trainer.py:507-511,530-534`)
        return torch.where(img_w > 0, 0.0 if cfg.no_reproj_doj else img_w,
                           out)

    color_m1 = warp_into(T_0m1, batch["doj_mask-1"], batch["color"]["-1"],
                         inv_m1)
    color_p1 = batch["color"]["1"]
    if is_train:
        inv_p1 = splat_depth(teacher_depth, T_0p1, K3)
        color_p1 = warp_into(T_0p1, batch["doj_mask+1"], batch["color"]["1"],
                             inv_p1)

    # the lookup frames of non-augmented items take the augmented current
    # frame's objects (`trainer.py:513-521`), by color_m1's splat
    tgt_aug = batch["color_aug"]["0"] * doj0
    img_w_aug, _, _ = forward_warp(tgt_aug, T_0m1, K3, inv_m1)
    warp_frame = lookup_frames[:, 0]
    warp_frame = torch.where(batch["doj_mask-1"][:, None] == 1, 0.0,
                             warp_frame)
    warp_frame = torch.where(img_w_aug > 0, img_w_aug, warp_frame)
    non_aug = (aug_mask == 0)[:, None, None, None, None]
    new_lookup = torch.where(non_aug, warp_frame[:, None], lookup_frames)
    return color_m1, color_p1, new_lookup
