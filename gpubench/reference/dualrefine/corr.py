"""Epipolar cost sampler (PyTorch, NCHW).

Counterpart of `mal_tpu.dualref.corr`; reference `CoordSampler`,
`dualrefine/networks/corr.py`. A pyramid of 2x average-pooled target
features is sampled at hypothesis pixel coordinates given in level-0
units; the cost is the L1 difference to the source features, averaged over
each head's channels.

The coordinates are normalised with the level-0 size at every level,
2 (x + 0.5) / w1 - 1 with `align_corners=False` (`corr.py:34-40`), which
lands on the right sub-pixel position of each coarser level. The output
channels run level, then head, then sample.

`mal_tpu` cuts the sample axis into chunks to bound its transients on a
16 GB chip; here each level is one `grid_sample` over all samples (an
80 GB card holds the (B, C, h w, D) sample at DualRefine's shapes: 0.5 GB
in fp32 at batch 12, 192x640). The numbers are the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference.ops.interp import grid_sample

Tensor = torch.Tensor


def build_pyramid(fmap2: Tensor, num_levels: int) -> list[Tensor]:
    pyr = [fmap2]
    for _ in range(num_levels - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2, 2))
    return pyr


def epipolar_cost(fmap1: Tensor, f2_pyramid: list[Tensor], coords: Tensor,
                  num_levels: int, num_head: int = 1) -> Tensor:
    """fmap1 (B, C, h, w); coords (B, 2, L, D, h, w) pixel coordinates.
    Returns (B, L * num_head * D, h, w)."""
    B, _, _, D, h, w = coords.shape
    C = fmap1.shape[1]
    f1 = fmap1.reshape(B, num_head, C // num_head, 1, h, w)
    out = []
    for lv in range(num_levels):
        c = coords[:, :, lv]                                   # (B, 2, D, h, w)
        gx = 2.0 * (c[:, 0] + 0.5) / w - 1.0
        gy = 2.0 * (c[:, 1] + 0.5) / h - 1.0
        grid = torch.stack([gx, gy], dim=-1).reshape(B, D, h * w, 2)
        sampled = grid_sample(f2_pyramid[lv], grid, "zeros",
                              align_corners=False)             # (B, C, D, hw)
        sampled = sampled.reshape(B, num_head, C // num_head, D, h, w)
        out.append((f1 - sampled).abs().mean(dim=2).reshape(
            B, num_head * D, h, w))
    return torch.cat(out, dim=1)


def epipolar_cost_simple(fmap1: Tensor, f2_pyramid: list[Tensor],
                         coords: Tensor, num_levels: int = 1) -> Tensor:
    """`CoordSampler.__corr__`: the plain channel-mean cost (B, L D, h, w)."""
    return epipolar_cost(fmap1, f2_pyramid, coords, num_levels, num_head=1)
