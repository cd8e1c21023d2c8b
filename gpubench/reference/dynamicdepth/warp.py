"""The forward (splatting) warp, copied from the port's
`mal_tpu_torch/dynamic/warp.py` (`dynamicdepth/rigid_warp.py:337-373,
534-597`): forward-project the source pixels with the depth upsampled x3,
z-buffer them into the target grid by a scatter-max over inverse depth,
then inverse-warp the image with the inverted pose and the splatted depth.
Only the exact x3 splat is copied (the port's `dilate` approximation is
off unless `domd_splat_dilate` asks for it).

Images are NCHW, (B, C, H, W); depths and masks (B, H, W)."""

from __future__ import annotations

import torch

from gpubench.reference import geometry
from gpubench.reference.ops.interp import grid_sample

Tensor = torch.Tensor

UPSCALE = 3   # the reference's sub-pixel upsampling of the splatted depth


def inverse_warp(img: Tensor, depth: Tensor, T: Tensor, K3: Tensor):
    """Sample `img` at the target pixels projected by (depth, T): img
    (B, C, H, W), depth (B, H, W) target depth, T (B, 4, 4) target ->
    source, K3 (B, 3, 3). Returns (warped, valid (B, H, W) bool), with the
    z-clamp at 1e-3 and zeros-padded, align_corners=True sampling."""
    B, _, H, W = img.shape
    pix = geometry.pixel_grid(H, W, depth.dtype, depth.device)
    rays = torch.linalg.inv(K3) @ pix
    cam = rays * depth.reshape(B, 1, -1)
    P = K3 @ T[:, :3, :3]
    t = (K3 @ T[:, :3, 3:])[:, :, 0]
    pc = P @ cam + t[:, :, None]
    z = pc[:, 2].clamp(min=1e-3)
    gx = 2.0 * (pc[:, 0] / z) / (W - 1) - 1.0
    gy = 2.0 * (pc[:, 1] / z) / (H - 1) - 1.0
    grid = torch.stack([gx, gy], -1).reshape(B, H, W, 2)
    warped = grid_sample(img, grid, padding_mode="zeros", align_corners=True)
    valid = grid.abs().amax(dim=-1) <= 1.0
    return warped, valid


def splat_depth(depth: Tensor, T: Tensor, K3: Tensor) -> Tensor:
    """z-buffered forward splat of a depth map -> inverse depth (B, H, W),
    0 where nothing landed. Every pixel is upsampled x3 (nearest), each
    sub-point projected, and the pixel it lands in is the truncation of its
    projected (x, y), as the reference's `.long()` takes it."""
    B, H, W = depth.shape
    u = UPSCALE
    depth_u = depth[:, :, None, :, None].expand(B, H, u, W, u).reshape(
        B, H * u, W * u)
    Ku = K3 * torch.tensor([[u], [u], [1.0]], dtype=K3.dtype, device=K3.device)
    pix = geometry.pixel_grid(H * u, W * u, depth.dtype, depth.device)
    rays = torch.linalg.inv(Ku) @ pix
    cam = rays * depth_u.reshape(B, 1, -1)                     # (B, 3, uH uW)

    cam_t = T[:, :3, :3] @ cam + T[:, :3, 3:]
    Z = cam_t[:, 2].clamp(min=1e-3)
    P = K3 @ (cam_t / Z[:, None])
    x, y = torch.trunc(P[:, 0]), torch.trunc(P[:, 1])
    inb = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (cam_t[:, 2] > 0)
    flat = torch.where(inb, y * W + x, 0.0).long()
    vals = torch.where(inb, 1.0 / Z, -torch.inf)

    buf = torch.full((B, H * W), -torch.inf, dtype=depth.dtype,
                     device=depth.device)
    buf.scatter_reduce_(1, flat, vals, reduce="amax")
    inv_map = torch.where(torch.isfinite(buf) & (buf > 0), buf, 0.0)
    return inv_map.reshape(B, H, W)


def forward_warp(img: Tensor, T: Tensor, K3: Tensor, inv_map: Tensor):
    """Forward-warp `img` (B, C, H, W) from the source view into the view
    at T (B, 4, 4), given the splat `inv_map` of the source depth under T.
    Returns (img_w, depth_w, valid), each zeroed outside validity."""
    B = img.shape[0]
    fw_val = inv_map > 0
    depth_w = torch.where(fw_val, 1.0 / inv_map.clamp(min=1e-12), 0.0)
    T4 = torch.eye(4, dtype=T.dtype, device=T.device).repeat(B, 1, 1)
    T4[:, :3, :] = T[:, :3, :]
    img_w, iw_val = inverse_warp(img, depth_w, torch.linalg.inv(T4), K3)
    valid = (fw_val & iw_val).to(img.dtype)
    return img_w * valid[:, None], depth_w * valid, valid
