"""DynamicDepth's losses, copied from the port's `mal_tpu_torch/losses.py`
and `train/step.py:warp_frame`, on the ManyDepth reference's pieces
(`gpubench/reference/losses.py`): the teacher's and the student's losses
with DynamicDepth's `--selec_reproj` and `--zero_img` variants
(`dynamicdepth/trainer.py:955-966,1058-1065`), and the photometric warp.
DynamicDepth's step passes no synthesized frames and takes the minimum
over the sources, so neither is copied; the means are the global batch's."""

from __future__ import annotations

from typing import Sequence

import torch

from gpubench.reference import geometry
from gpubench.reference.losses import (MonoLossOut, MultiLossOut, automask,
                                       masked_mean, normalized_smooth_loss,
                                       reprojection_loss)
from gpubench.reference.ops.interp import grid_sample

Tensor = torch.Tensor


def warp_frame(src: Tensor, depth: Tensor, T: Tensor, K: Tensor,
               inv_K: Tensor) -> Tensor:
    """Inverse-warp `src` (B, 3, H, W) into the current view by depth
    (B, 1, H, W) and pose T, with border padding
    (`manydepth/trainer.py:1111-1125`)."""
    B, _, H, W = src.shape
    points = geometry.backproject(depth, inv_K, H, W)
    grid = geometry.project_3d(points, K, T, H, W)
    return grid_sample(src, grid, padding_mode="border")


def zero_img_reproj_sequence(target: Tensor, preds: Sequence[Tensor]
                             ) -> tuple[list[Tensor], Tensor]:
    """`--zero_img` over a sequence of preds as the reference runs it: each
    call zeroes the shared target in place where its pred is black (channel
    sum < 0.1), so each sees the union of the earlier holes. Returns the
    loss maps in call order and the final target."""
    outs = []
    for pred in preds:
        hole = pred.detach().sum(dim=1, keepdim=True) < 0.1
        target = torch.where(hole, 0.0, target)
        outs.append(reprojection_loss(torch.where(hole, 0.0, pred), target))
    return outs, target


def apply_selec_reproj(reproj_all: Tensor, warped: Sequence[Tensor]) -> Tensor:
    """`--selec_reproj`: the per-pixel minimum of the two frames' losses
    reproj_all (B, 2, H, W), except that where one warped frame is black
    the other's loss is taken, and where both are black 0."""
    m0 = warped[0].detach().sum(dim=1, keepdim=True) < 0.1
    m1 = warped[1].detach().sum(dim=1, keepdim=True) < 0.1
    out = reproj_all.amin(dim=1, keepdim=True)
    out = torch.where(m0, reproj_all[:, 1:2], out)
    out = torch.where(m1, reproj_all[:, 0:1], out)
    return torch.where(m0 & m1, 0.0, out)


def _reduce(maps: Sequence[Tensor], selec_warped) -> Tensor:
    stacked = torch.cat(list(maps), dim=1)
    if selec_warped is not None:
        return apply_selec_reproj(stacked, selec_warped)
    return stacked.amin(dim=1, keepdim=True)


def mono_losses(noise: Tensor | None, disp: Tensor, color: Tensor,
                warped: Sequence[Tensor], identity: Sequence[Tensor],
                smoothness_weight: float, disable_automasking: bool,
                selec_reproj: bool, reproj_maps=None, identity_maps=None,
                smooth_color: Tensor | None = None) -> MonoLossOut:
    """The teacher's losses (`manydepth/loss_utils.py:57-129`); the maps and
    the smoothness image as `--zero_img` makes them, where given."""
    if reproj_maps is None:
        reproj_maps = [reprojection_loss(p, color) for p in warped]
    reproj_min = _reduce(reproj_maps, warped if selec_reproj else None)
    if disable_automasking:
        mask = torch.ones_like(reproj_min)
    else:
        if identity_maps is None:
            identity_maps = [reprojection_loss(p, color) for p in identity]
        ident_min = _reduce(identity_maps, None)
        mask = automask(reproj_min, ident_min + noise * 1e-5)
    reproj = masked_mean(reproj_min, mask)
    sm = normalized_smooth_loss(
        disp, color if smooth_color is None else smooth_color)
    return MonoLossOut(reproj + smoothness_weight * sm, reproj, sm, reproj_min)


def multi_losses(disp: Tensor, color: Tensor, warped: Sequence[Tensor],
                 multi_depth: Tensor, mono_depth: Tensor,
                 consistency_mask_in: Tensor, augmentation_mask: Tensor,
                 mono_min_reproj: Tensor, smoothness_weight: float,
                 selec_reproj: bool, reproj_maps=None,
                 smooth_color: Tensor | None = None) -> MultiLossOut:
    """The student's losses and the two-way distillation hint, mono or
    multi by the per-pixel smaller reprojection
    (`manydepth/loss_utils.py:131-281`)."""
    if reproj_maps is None:
        reproj_maps = [reprojection_loss(p, color) for p in warped]
    multi_min_reproj = _reduce(reproj_maps, warped if selec_reproj else None)
    mask = consistency_mask_in[:, None] * (1.0 - augmentation_mask)
    consistency_mask = 1.0 - mask
    reproj = masked_mean(multi_min_reproj, mask)
    consistency = ((multi_depth - mono_depth).abs() * consistency_mask).mean()
    sm = normalized_smooth_loss(
        disp, color if smooth_color is None else smooth_color)
    loss = reproj + consistency + smoothness_weight * sm
    idx = torch.cat([mono_min_reproj, multi_min_reproj], dim=1).argmin(
        dim=1, keepdim=True)
    distil_depth = torch.where(idx == 0, mono_depth, multi_depth)
    distil = ((distil_depth - multi_depth).abs()
              * (1.0 - consistency_mask)).mean()
    return MultiLossOut(loss, distil, reproj, consistency, sm, consistency_mask)
