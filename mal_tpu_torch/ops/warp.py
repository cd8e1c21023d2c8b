"""Forward (splatting) warp of a depth map via a z-buffer scatter-max.

Counterpart of `mal_tpu.ops.warp`: the reference's
`torch_sparse.coalesce(op='max')` z-buffer in `dynamicdepth/rigid_warp.py:
534-599` as one `scatter_reduce_(..., reduce="amax")` per batch. Not on the
DynamicDepth step's path (`dynamic/warp.py` splats there); kept for the
callers of `mal_tpu`'s.
"""

from __future__ import annotations

import torch

from mal_tpu_torch import geometry

Tensor = torch.Tensor


def zbuffer_scatter_max(pix_xy: Tensor, values: Tensor, valid: Tensor,
                        height: int, width: int) -> Tensor:
    """Scatter `values` to the rounded pixel locations, keeping the max.

    pix_xy (B, N, 2) continuous (x, y); values (B, N) (inverse depth for a
    z-buffer); valid (B, N) bool, invalid points dropped. Returns
    (B, height, width), 0 where nothing landed. `torch.round` rounds half
    to even, as `jnp.round` does.
    """
    B = values.shape[0]
    x = torch.round(pix_xy[..., 0])
    y = torch.round(pix_xy[..., 1])
    inb = (x >= 0) & (x < width) & (y >= 0) & (y < height) & valid
    # out of bounds -> index 0 with the value -inf, so it never wins
    flat = torch.where(inb, y * width + x, 0.0).long()
    vals = torch.where(inb, values, -torch.inf)
    buf = torch.full((B, height * width), -torch.inf, dtype=values.dtype,
                     device=values.device)
    buf.scatter_reduce_(1, flat, vals, reduce="amax")
    out = torch.where(torch.isfinite(buf), buf, 0.0)
    return out.reshape(B, height, width)


def forward_splat_depth(depth: Tensor, T: Tensor, K: Tensor, inv_K: Tensor,
                        mask: Tensor, height: int, width: int) -> Tensor:
    """Forward-warp a masked depth map (B, H, W) into the view at T
    (B, 4, 4, source -> target), keeping the nearest surface per target
    pixel; mask (B, H, W) is 1 where a pixel is splatted. Returns the
    target-view depth (B, H, W), 0 where nothing landed."""
    B = depth.shape[0]
    points = geometry.backproject(depth, inv_K, height, width)   # (B, 4, HW)
    cam = (K @ T)[:, :3, :] @ points                               # (B, 3, HW)
    z = cam[:, 2, :]
    pix = (cam[:, :2, :] / (z[:, None] + 1e-7)).transpose(1, 2)    # (B, HW, 2)
    inv_z = 1.0 / z.clamp(min=1e-7)
    valid = (mask.reshape(B, -1) > 0) & (z > 1e-4)
    inv_map = zbuffer_scatter_max(pix, inv_z, valid, height, width)
    return torch.where(inv_map > 0, 1.0 / inv_map.clamp(min=1e-7), 0.0)
