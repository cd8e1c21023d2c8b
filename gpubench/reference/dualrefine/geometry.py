"""The camera geometry of DualRefine's step: the ManyDepth reference's
(`gpubench/reference/geometry.py`) and, frozen from the port's
`mal_tpu_torch/geometry.py`, the three functions only DualRefine reaches:
the pixel-centre projection, depth to disparity and the SE(3)
exponential."""

from __future__ import annotations

import torch

from gpubench.reference.geometry import (_safe_denom, backproject,
                                         disp_to_depth, scale_intrinsics,
                                         skew,
                                         transformation_from_parameters)

__all__ = ["backproject", "depth_to_disp", "disp_to_depth",
           "project_3d_center", "scale_intrinsics", "se3_exp",
           "transformation_from_parameters"]

Tensor = torch.Tensor


def depth_to_disp(depth: Tensor, min_depth: float, max_depth: float) -> Tensor:
    """Inverse of `disp_to_depth`: depth -> the sigmoid disparity."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return (1.0 / depth - min_disp) / (max_disp - min_disp)


def project_3d_center(points: Tensor, K: Tensor, T: Tensor, height: int,
                      width: int, eps: float = 1e-7) -> Tensor:
    """Project homogeneous points (B, 4, H*W) into a camera at pose T with
    DualRefine's pixel-centre normalisation, grid = 2 (pix + 0.5) / W - 1
    (`dualrefine/layers.py:216-226`), the convention of
    `grid_sample(align_corners=False)`; clipped to [-10, 10]."""
    P = (K @ T)[:, :3, :]
    cam_points = P @ points
    pix = cam_points[:, :2, :] / _safe_denom(cam_points[:, 2:3, :] + eps)
    pix = pix.reshape(-1, 2, height, width).permute(0, 2, 3, 1)
    scale = torch.tensor([width, height], dtype=pix.dtype, device=pix.device)
    grid = 2.0 * (pix + 0.5) / scale - 1.0
    return grid.clamp(-10.0, 10.0)


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
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype,
                          device=xi.device).expand(xi.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
