"""The occlusion-aware plane-sweep cost volume, copied from the port's
plain twin (`mal_tpu_torch/dynamic/cost_volume.py:occlusion_aware_cost_volume`),
which stands in for kernel K6: after the DOMD warp blanks the moved
dynamic objects, occluded regions of the lookup frame are black (RGB sum
< 0.15). Their entries are set high (`set_1`: the warped features become
1.0), or infilled from neighbouring costs by a 3-D max-pool (`pool`), and
`cv_min` takes the per-frame minimum in place of the mean
(`dynamicdepth/networks/resnet_encoder.py:148-249`).

Features are channels-last: cur_feats (B, h, w, C), lookup_feats
(B, F, h, w, C); the lookup images are NCHW frames (B, F, 3, H, W). The
volume is a constant with respect to the parameters."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference import geometry
from gpubench.reference.ops.interp import grid_sample, resize_nearest

Tensor = torch.Tensor


def occlusion_mask(lookup_images: Tensor, h: int, w: int) -> Tensor:
    """(B, F, 3, H, W) -> (B, F, h, w) occluded-black mask at matching
    resolution: RGB sum < 0.15, nearest resize (`resnet_encoder.py:160`)."""
    B, nF = lookup_images.shape[:2]
    occ = (lookup_images.sum(dim=2, keepdim=True) < 0.15).to(torch.float32)
    occ = resize_nearest(occ.flatten(0, 1), h, w)
    return occ.reshape(B, nF, h, w)


def _reduce_frames(diffs: Tensor, valid_frame: Tensor, cv_min: bool):
    """Per-frame differences (B, F, D', h, w), zeroed for missing frames,
    -> (cost, counts) over the frames. `cv_min` keeps the reference's
    ones-initialised running minimum (`resnet_encoder.py:165-166,228`): a
    difference >= 1.0 saturates at 1.0, which `_finish` zeroes as missing."""
    if cv_min:
        d2 = torch.where(diffs == 0, 1.0, diffs)
        d2 = torch.where(valid_frame > 0, d2, 1.0)
        cost = d2.amin(dim=1).clamp(max=1.0)
        return cost, torch.zeros_like(cost)
    counts = (diffs > 0).to(diffs.dtype).sum(dim=1)
    return diffs.sum(dim=1), counts


def _finish(cost: Tensor, counts: Tensor, cv_min: bool):
    """(cost_volume, missing_mask): a missing entry takes its pixel's
    largest cost."""
    if cv_min:
        cost = torch.where(cost == 1.0, 0.0, cost)
    else:
        cost = cost / (counts + 1e-7)
    missing = (cost == 0).to(cost.dtype)
    cost = cost * (1.0 - missing) + cost.amax(dim=1, keepdim=True) * missing
    return cost, missing


def occlusion_aware_cost_volume(
        cur_feats: Tensor, lookup_feats: Tensor, rel_poses: Tensor,
        K: Tensor, inv_K: Tensor, depth_bins: Tensor, lookup_images: Tensor,
        aug_mask: Tensor, cv_min: bool = False, set_1: bool = False,
        pool: bool = False, pool_r: int = 1, pool_th: float = 0.7):
    """(cost_volume, missing_mask), each (B, D, h, w). rel_poses
    (B, F, 4, 4), an all-zero pose marking a missing frame; K / inv_K
    (B, 4, 4) at the feature scale; depth_bins (D,); aug_mask (B,) 1 where
    the matching was augmented (no occlusion handling there). Without
    `pool` the planes go 16 at a time (all at once where 16 does not divide
    D); `pool` needs the whole depth axis for its 3-D max-pool."""
    B, h, w, C = cur_feats.shape
    nF = lookup_feats.shape[1]
    D = depth_bins.shape[0]
    dev = cur_feats.device
    cur_feats, lookup_feats = cur_feats.float(), lookup_feats.float()

    pix = geometry.pixel_grid(h, w, torch.float32, dev)
    P = (K[:, None] @ rel_poses)[:, :, :3, :]
    rays = inv_K[:, :3, :3] @ pix                                  # (B, 3, hw)
    A = P[:, :, :, :3] @ rays[:, None]                             # (B, F, 3, hw)
    t = P[:, :, :, 3]
    valid_frame = (rel_poses.abs().sum(dim=(-1, -2)) != 0).to(
        torch.float32)[:, :, None, None, None]
    border = torch.zeros((h, w), device=dev)
    border[2:-2, 2:-2] = 1.0
    scale = torch.tensor([w - 1, h - 1], dtype=torch.float32, device=dev)

    if set_1 or pool:
        occ = occlusion_mask(lookup_images, h, w).reshape(B * nF, 1, h, w)
        apply_occ = (aug_mask == 0)[:, None, None, None, None]
    lookup_nchw = lookup_feats.reshape(B * nF, h, w, C).permute(0, 3, 1, 2)

    def warp_plane_block(d_block: Tensor) -> Tensor:
        """(Dc,) planes -> per-frame differences (B, F, Dc, h, w)."""
        Dc = d_block.shape[0]
        d = d_block[None, None, :, None, None]
        cam = d * A[:, :, None] + t[:, :, None, :, None]           # (B, F, Dc, 3, hw)
        xy = cam[:, :, :, :2] / (cam[:, :, :, 2:3] + 1e-7)
        xy = xy.reshape(B, nF, Dc, 2, h, w).movedim(3, -1)
        grid = (xy / scale - 0.5) * 2.0                            # (B, F, Dc, h, w, 2)
        grid_bf = grid.reshape(B * nF, Dc * h, w, 2)
        warped = grid_sample(lookup_nchw, grid_bf, "zeros", True)
        warped = warped.permute(0, 2, 3, 1).reshape(B, nF, Dc, h, w, C)

        if set_1 or pool:
            occ_w = grid_sample(occ, grid_bf, "zeros", True)
            occ_w = occ_w.reshape(B, nF, Dc, h, w)
            omask = ((occ_w > pool_th)[..., None] & apply_occ[..., None])
            warped = torch.where(omask, 1.0 if set_1 else 0.0, warped)
            if pool:
                k = 2 * pool_r + 1
                xw = torch.where(omask, 0.0, warped)
                xw = xw.permute(0, 1, 5, 2, 3, 4).reshape(B * nF, C, Dc, h, w)
                pooled = F.max_pool3d(xw, k, stride=1, padding=pool_r)
                pooled = pooled.reshape(B, nF, C, Dc, h, w).permute(0, 1, 3, 4, 5, 2)
                warped = torch.where(omask, pooled, warped)

        x_v = (grid[..., 0] / 2.0 + 0.5) * (w - 1)
        y_v = (grid[..., 1] / 2.0 + 0.5) * (h - 1)
        edge = (x_v >= 2.0) & (x_v <= w - 2) & (y_v >= 2.0) & (y_v <= h - 2)
        edge = edge.float() * border
        diffs = (warped - cur_feats[:, None, None]).abs().mean(dim=-1)
        return diffs * edge * valid_frame

    bins = depth_bins.to(torch.float32)
    chunk = 16 if D % 16 == 0 and not pool else D
    parts = [_reduce_frames(warp_plane_block(d), valid_frame, cv_min)
             for d in bins.split(chunk)]
    cost = torch.cat([c for c, _ in parts], dim=1)
    counts = torch.cat([n for _, n in parts], dim=1)
    return _finish(cost, counts, cv_min)
