"""Differentiable camera geometry (PyTorch).

Counterpart of `mal_tpu.geometry`. Conventions are the same: pixel
coordinates are (x, y) with x the column index, intrinsics `K` are 4x4 with
the full-resolution pixel scaling applied, and sampling grids are (B, H, W, 2)
normalised to [-1, 1] for `grid_sample(align_corners=True)`.
"""

from __future__ import annotations

import torch

from mal_tpu_torch.utils import profiling

Tensor = torch.Tensor


def disp_to_depth(disp: Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth). Reference: `manydepth/layers.py:14-23`."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def rot_from_axisangle(vec: Tensor) -> Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 4, 4) via Rodrigues,
    with the reference's 1e-7 angle guard (`manydepth/layers.py:61-100`)."""
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)

    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca

    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC

    zeros = torch.zeros_like(ca)
    ones = torch.ones_like(ca)
    rot = torch.stack(
        [
            x * xC + ca, xyC - zs, zxC + ys, zeros,
            xyC + zs, y * yC + ca, yzC - xs, zeros,
            zxC - ys, yzC + xs, z * zC + ca, zeros,
            zeros, zeros, zeros, ones,
        ],
        dim=-1,
    )
    return rot.reshape(vec.shape[:-1] + (4, 4))


def translation_matrix(t: Tensor) -> Tensor:
    """Translation (..., 3) -> (..., 4, 4). Reference: `manydepth/layers.py:45-58`."""
    T = torch.eye(4, dtype=t.dtype, device=t.device).expand(
        t.shape[:-1] + (4, 4)).clone()
    T[..., :3, 3] = t
    return T


def transformation_from_parameters(axisangle: Tensor, translation: Tensor,
                                   invert: bool = False) -> Tensor:
    """(axis-angle, translation) -> SE(3) 4x4; `invert` composes
    R^T @ Trans(-t) as the reference does (`manydepth/layers.py:26-42`)."""
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(-1, -2)
        t = -t
    T = translation_matrix(t)
    if invert:
        return R @ T
    return T @ R


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None) -> Tensor:
    """Homogeneous pixel coordinates (3, H*W): rows are (x, y, 1)."""
    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # each (H, W)
    ones = torch.ones((height, width), dtype=dtype, device=device)
    return torch.stack([gx, gy, ones], dim=0).reshape(3, height * width)


def backproject(depth: Tensor, inv_K: Tensor, height: int, width: int) -> Tensor:
    """Depth (B, H, W) or (B, 1, H, W) -> homogeneous camera points (B, 4, H*W).

    Reference: `manydepth/layers.py:138-168`.
    """
    B = depth.shape[0]
    pix = pixel_grid(height, width, depth.dtype, depth.device)
    cam_rays = inv_K[:, :3, :3] @ pix                      # (B, 3, HW)
    cam_points = depth.reshape(B, 1, height * width) * cam_rays
    ones = torch.ones((B, 1, height * width), dtype=depth.dtype,
                      device=depth.device)
    return torch.cat([cam_points, ones], dim=1)


def _safe_denom(z: Tensor, floor: float = 1e-6) -> Tensor:
    """Sign-preserving clamp of a projective denominator away from zero.

    Points on the camera plane land far outside the image either way, but an
    unguarded divide makes the backward pass compute -xy/z^2 = inf, and
    inf * (masked-zero cotangent) = NaN. Forward values are unchanged for
    any physically meaningful sample (`mal_tpu.geometry._safe_denom`).
    """
    floor_t = torch.where(z < 0, -floor, floor).to(z.dtype)
    return torch.where(z.abs() < floor, floor_t, z)


def project_3d(points: Tensor, K: Tensor, T: Tensor, height: int, width: int,
               eps: float = 1e-7) -> Tensor:
    """Project homogeneous points (B, 4, H*W) into a camera at pose T.

    Returns normalised grid coordinates (B, H, W, 2), clipped to [-10, 10]:
    coordinates that far out sample the same under border or zeros padding,
    and the clip zeroes the backward cotangent before it meets the huge
    projective Jacobian of near-camera-plane points.
    Reference: `manydepth/layers.py:171-199`.
    """
    P = (K @ T)[:, :3, :]
    cam_points = P @ points                                # (B, 3, HW)
    pix = cam_points[:, :2, :] / _safe_denom(cam_points[:, 2:3, :] + eps)
    pix = pix.reshape(-1, 2, height, width).permute(0, 2, 3, 1)
    # a copy from a host list, which synchronises with the device
    scale = torch.tensor([width - 1, height - 1], dtype=pix.dtype,
                         device=pix.device)
    profiling.count("host_syncs")
    grid = (pix / scale - 0.5) * 2.0
    return grid.clamp(-10.0, 10.0)


def scale_intrinsics(K: Tensor, scale: int) -> Tensor:
    """Downscale full-resolution intrinsics by 2**scale (rows 0 and 1)."""
    # a copy from a host list, which synchronises with the device
    factor = torch.tensor([1.0 / (2 ** scale), 1.0 / (2 ** scale), 1.0, 1.0],
                          dtype=K.dtype, device=K.device)
    profiling.count("host_syncs")
    return K * factor[None, :, None]


def depth_to_disp(depth: Tensor, min_depth: float, max_depth: float) -> Tensor:
    """Inverse of `disp_to_depth`: depth -> the sigmoid disparity."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return (1.0 / depth - min_disp) / (max_disp - min_disp)


def project_3d_center(points: Tensor, K: Tensor, T: Tensor, height: int,
                      width: int, eps: float = 1e-7) -> Tensor:
    """`project_3d` with DualRefine's pixel-centre normalisation,
    grid = 2 (pix + 0.5) / W - 1 (`dualrefine/layers.py:216-226`), the
    convention of `grid_sample(align_corners=False)`. Clipped to [-10, 10]
    for the reason `project_3d` gives."""
    P = (K @ T)[:, :3, :]
    cam_points = P @ points
    pix = cam_points[:, :2, :] / _safe_denom(cam_points[:, 2:3, :] + eps)
    pix = pix.reshape(-1, 2, height, width).permute(0, 2, 3, 1)
    # a copy from a host list, which synchronises with the device
    scale = torch.tensor([width, height], dtype=pix.dtype, device=pix.device)
    profiling.count("host_syncs")
    grid = 2.0 * (pix + 0.5) / scale - 1.0
    return grid.clamp(-10.0, 10.0)


def skew(v: Tensor) -> Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    m = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def se3_exp(xi: Tensor) -> Tensor:
    """SE(3) exponential map: twist (..., 6) [v, w] -> (..., 4, 4), with
    R ~ I + skew(w) and V ~ I below an angle of 1e-6
    (`dualrefine/layers.py:29-56`)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp(min=1e-12)
    W = skew(w / theta)
    th = theta[..., None]
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    WW = W @ W
    R = eye + sin_t * W + (1.0 - cos_t) * WW
    V = eye + (1.0 - cos_t) / th * W + (th - sin_t) / th * WW
    small = theta[..., None] < 1e-6
    R = torch.where(small, eye + skew(w), R)
    V = torch.where(small, eye, V)
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    # a copy from a host list, which synchronises with the device
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype,
                          device=xi.device).expand(xi.shape[:-1] + (1, 4))
    profiling.count("host_syncs")
    return torch.cat([top, bottom], dim=-2)
