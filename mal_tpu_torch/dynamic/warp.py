"""DynamicDepth forward (splatting) warp, PyTorch.

Counterpart of `mal_tpu.dynamic.warp`, itself a re-design of
`dynamicdepth/rigid_warp.py:534-597` (`forward_warp`) and `:337-373`
(`inverse_warp`): forward-project source pixels with x3-upsampled depth,
z-buffer them into the target grid by a scatter-max over inverse depth (in
place of `torch_sparse.coalesce(op='max')`), then inverse-warp the image
with the inverted pose and the splatted depth.

The z-buffer is `scatter_reduce_(..., reduce="amax")` on a -inf buffer: an
out-of-image point goes to index 0 with the value -inf, so it never wins.
A max does not depend on the order of the points, so the result is
deterministic. This is a library scatter, not a TPU kernel's port.

Images are NCHW here, (B, C, H, W); depths and masks (B, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mal_tpu_torch import geometry
from mal_tpu_torch.ops.interp import grid_sample

Tensor = torch.Tensor

# the reference's sub-pixel upsampling of the splatted depth
# (`rigid_warp.py:534-560`)
UPSCALE = 3


def _upsample_nn(x: Tensor, factor: int) -> Tensor:
    """Nearest x-factor upsample of (B, H, W)."""
    B, H, W = x.shape
    x = x[:, :, None, :, None].expand(B, H, factor, W, factor)
    return x.reshape(B, H * factor, W * factor)


def inverse_warp(img: Tensor, depth: Tensor, T: Tensor, K3: Tensor):
    """Sample `img` at the target pixels projected by (depth, T).

    img (B, C, H, W); depth (B, H, W) target depth; T (B, 4, 4) target ->
    source; K3 (B, 3, 3). Returns (warped, valid (B, H, W) bool) with the
    reference's z-clamp (min 1e-3) and zeros-padded, align_corners=True
    sampling (`rigid_warp.py:54-83,337-373`)."""
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


def splat_depth(depth: Tensor, T: Tensor, K3: Tensor,
                dilate: bool = False) -> Tensor:
    """z-buffered forward splat of a depth map -> inverse depth (B, H, W),
    0 where nothing landed.

    It depends on (depth, T, K3) only, not on the image being warped, so the
    DOMD block splats once per pose and shares the result across the warps
    of that pose. The exact splat NN-upsamples the depth x`UPSCALE` and
    projects every sub-point. `dilate=True` is `mal_tpu`'s TPU fast-mode
    approximation: splat at 1x, then max-dilate the map 3x3; it overwrites
    cells the sub-points did not reach, across depth edges too.

    The pixel a point lands in is the truncation of its projected (x, y), as
    the reference's `.long()` takes it: a one-ulp change of x near an
    integer moves the point to the next pixel.
    """
    B, H, W = depth.shape
    u = 1 if dilate else UPSCALE
    depth_u = _upsample_nn(depth, u) if u > 1 else depth
    Ku = K3 * torch.tensor([[u], [u], [1.0]], dtype=K3.dtype, device=K3.device)
    pix = geometry.pixel_grid(H * u, W * u, depth.dtype, depth.device)
    rays = torch.linalg.inv(Ku) @ pix
    cam = rays * depth_u.reshape(B, 1, -1)                     # (B, 3, uH uW)

    cam_t = T[:, :3, :3] @ cam + T[:, :3, 3:]
    Z = cam_t[:, 2].clamp(min=1e-3)
    # project with the original intrinsics -> original-resolution pixels
    P = K3 @ (cam_t / Z[:, None])
    # truncate, and drop what falls outside; compared as floats, so that a
    # far-away point never meets an integer overflow
    x, y = torch.trunc(P[:, 0]), torch.trunc(P[:, 1])
    inb = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (cam_t[:, 2] > 0)
    flat = torch.where(inb, y * W + x, 0.0).long()
    vals = torch.where(inb, 1.0 / Z, -torch.inf)

    buf = torch.full((B, H * W), -torch.inf, dtype=depth.dtype,
                     device=depth.device)
    buf.scatter_reduce_(1, flat, vals, reduce="amax")
    inv_map = torch.where(torch.isfinite(buf) & (buf > 0), buf, 0.0)
    inv_map = inv_map.reshape(B, H, W)
    if dilate:
        # the map is >= 0, so -inf padding (max_pool2d's) is 0 padding
        inv_map = F.max_pool2d(inv_map[:, None], 3, stride=1, padding=1)[:, 0]
    return inv_map


def forward_warp(img: Tensor, depth: Tensor, T: Tensor, K3: Tensor,
                 inv_map: Tensor | None = None):
    """Forward-warp `img` (and its depth) from the source view into the view
    at T (`rigid_warp.py:534-597`).

    img (B, C, H, W); depth (B, H, W) source depth; T (B, 4, 4) source ->
    target; K3 (B, 3, 3). Returns (img_w, depth_w, valid), each zeroed
    outside validity. A precomputed `inv_map` (`splat_depth`, exact or
    dilated) shares the scatter across warps of the same (depth, T)."""
    B = img.shape[0]
    if inv_map is None:
        inv_map = splat_depth(depth, T, K3)
    fw_val = inv_map > 0
    depth_w = torch.where(fw_val, 1.0 / inv_map.clamp(min=1e-12), 0.0)

    # inverse-warp the image with the inverted pose and the splatted depth
    T4 = torch.eye(4, dtype=T.dtype, device=T.device).repeat(B, 1, 1)
    T4[:, :3, :] = T[:, :3, :]
    img_w, iw_val = inverse_warp(img, depth_w, torch.linalg.inv(T4), K3)

    valid = (fw_val & iw_val).to(img.dtype)
    return img_w * valid[:, None], depth_w * valid, valid
