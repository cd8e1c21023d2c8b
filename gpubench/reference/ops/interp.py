"""Bilinear grid sampling and resizing (PyTorch, NCHW).

Counterpart of `mal_tpu.ops.interp`. Inside the port, images and feature
maps are channels-first. `grid_sample` is `torch.nn.functional.grid_sample`
with the semantics `mal_tpu` reproduces (photometric warp: border padding,
align_corners=True; cost-volume warp: zeros padding, align_corners=True;
deformable-attention sampling: zeros padding, align_corners=False).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def grid_sample(img: Tensor, grid: Tensor, padding_mode: str = "zeros",
                align_corners: bool = True) -> Tensor:
    """img (B, C, H, W), grid (B, Ho, Wo, 2) of (x, y) in [-1, 1] -> (B, C, Ho, Wo)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    return F.grid_sample(img, grid, mode="bilinear", padding_mode=padding_mode,
                         align_corners=align_corners)


def resize_nearest(img: Tensor, height: int, width: int) -> Tensor:
    """Nearest resize: destination index i reads source floor(i * in/out),
    as `F.interpolate(mode='nearest')` and `mal_tpu` do. img (B, C, H, W)."""
    H, W = img.shape[-2:]
    ys = torch.floor(torch.arange(height, dtype=torch.float32,
                                  device=img.device) * (H / height)).long()
    xs = torch.floor(torch.arange(width, dtype=torch.float32,
                                  device=img.device) * (W / width)).long()
    return img.index_select(-2, ys).index_select(-1, xs)


def upsample2x_nearest(img: Tensor) -> Tensor:
    """x2 nearest upsample of (B, C, H, W) (`manydepth/layers.py:204-207`)."""
    return F.interpolate(img, scale_factor=2, mode="nearest")


def _axis_coords(out_size: int, in_size: int, device):
    """Half-pixel-centre source coordinates, clamped at the edges:
    (lo, hi, w_hi), as `mal_tpu.ops.interp.resize_bilinear` takes them."""
    src = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
           * (in_size / out_size) - 0.5)
    src = src.clamp(0.0, in_size - 1)
    lo = torch.floor(src).long()
    hi = (lo + 1).clamp(max=in_size - 1)
    return lo, hi, src - lo.to(torch.float32)


def resize_bilinear(img: Tensor, height: int, width: int) -> Tensor:
    """Bilinear resize of (B, C, H, W), `F.interpolate(mode='bilinear',
    align_corners=False)` semantics in `mal_tpu`'s order of operations:
    rows first, then columns."""
    H, W = img.shape[-2:]
    if (H, W) == (height, width):
        return img
    y0, y1, wy = _axis_coords(height, H, img.device)
    x0, x1, wx = _axis_coords(width, W, img.device)
    wy = wy[:, None]
    rows = (img.index_select(-2, y0) * (1.0 - wy)
            + img.index_select(-2, y1) * wy)
    return (rows.index_select(-1, x0) * (1.0 - wx)
            + rows.index_select(-1, x1) * wx)
