"""Epipolar coordinate generators (PyTorch).

Counterpart of `mal_tpu.dualref.reprojections`; reference `Reprojections`,
`dualrefine/networks/utils/utils.py:112-255`. Pixel-coordinate hypothesis
sets at the 1/4 feature scale:
- `depth2epipolarcoords`: 2r+1 samples per pyramid level around the
  current depth, spaced by a learnable softplus delta and the gap factor;
- `depth2gradcoords`: the projected point and its +-1 pixel x / y
  neighbours, for the Gauss-Newton pose update;
- `depthbins2coords`: a 96-bin sweep for the consistency mask.

Depth maps are (B, 1, h, w); coordinates come out (B, 2, L, D, h, w) as in
`mal_tpu`. Only what `DEQDepthPose` builds is here: the gap scaled by the
depth, and the sweep relative to the depth (`mal_tpu`'s `gap_factor=
"minmax"` and `use_depth_bins_for_masking` have no caller there either).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


class Intrinsics(NamedTuple):
    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor

    @classmethod
    def from_K(cls, K: Tensor) -> "Intrinsics":
        return cls(K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2])


def _iproj(depths: Tensor, intr: Intrinsics) -> Tensor:
    """depths (B, L, D, h, w) -> homogeneous points (B, 4, L, D, h, w)."""
    h, w = depths.shape[-2:]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=depths.dtype, device=depths.device),
        torch.arange(w, dtype=depths.dtype, device=depths.device),
        indexing="ij")
    X = (xs[None] - intr.cx[:, None, None]) / intr.fx[:, None, None]
    Y = (ys[None] - intr.cy[:, None, None]) / intr.fy[:, None, None]
    X, Y = X[:, None, None], Y[:, None, None]
    return torch.stack([depths * X, depths * Y, depths,
                        torch.ones_like(depths)], dim=1)


def _proj(Xs: Tensor, intr: Intrinsics) -> Tensor:
    """Xs (B, 4, N) -> pixel coordinates (B, 2, N). Z is clamped away from
    zero, sign-preserving, so that the backward never meets inf * 0
    (`geometry._safe_denom`), and 1 / Z at 100 as in the reference."""
    X, Y, Z = Xs[:, 0], Xs[:, 1], Xs[:, 2]
    floor = torch.where(Z < 0, -1e-6, 1e-6).to(Z.dtype)
    Z = torch.where(Z.abs() < 1e-6, floor, Z)
    d = (1.0 / Z).clamp(max=100.0)
    x = intr.fx[:, None] * (X * d) + intr.cx[:, None]
    y = intr.fy[:, None] * (Y * d) + intr.cy[:, None]
    return torch.stack([x, y], dim=1)


def _transform(poses: Tensor, X0: Tensor) -> Tensor:
    """(B, 4, 4) @ points (B, 4, ...) flattened -> (B, 4, N)."""
    B = X0.shape[0]
    return poses @ X0.reshape(B, 4, -1)


class Reprojections(nn.Module):
    """Holds the reference's learnable gap scales `delta` (and `delta_p`,
    which the reference registers for the pose path and never reads)."""

    def __init__(self, corr_radius: int = 8, num_levels: int = 3,
                 gap_factor_depth_ratio: int = 8, num_depth_bins: int = 96,
                 min_depth: float = 0.1, max_depth: float = 100.0):
        super().__init__()
        self.corr_radius = corr_radius
        self.num_levels = num_levels
        self.gap_factor_depth_ratio = gap_factor_depth_ratio
        self.num_depth_bins = num_depth_bins
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.delta = nn.Parameter(torch.ones(1))
        self.delta_p = nn.Parameter(torch.ones(1))

    def depth2epipolarcoords(self, poses: Tensor, depths: Tensor, K: Tensor):
        """depths (B, 1, h, w) -> (coords (B, 2, L, 2r+1, h, w), max_dx
        (B, 1, h, w), the sampled depths (B, 1, L (2r+1), h, w))."""
        intr = Intrinsics.from_K(K)
        B, _, h, w = depths.shape
        r = self.corr_radius
        d0 = depths[:, :, None]                           # (B, 1, 1, h, w)
        dx = torch.linspace(-r, r, 2 * r + 1, dtype=depths.dtype,
                            device=depths.device)[None, None, :, None, None]
        gap = (F.softplus(self.delta) * d0 / self.gap_factor_depth_ratio
               / r)
        deltas = []
        max_dx = None
        for level in range(self.num_levels):
            delta = (2 ** level) * torch.ones_like(d0) * gap
            if level == 0:
                max_dx = (dx * delta).amax(dim=2)               # (B, 1, h, w)
            deltas.append(dx * delta)
        ds = d0 + torch.cat(deltas, dim=2)                      # (B, 1, L D, h, w)
        X1 = _transform(poses, _iproj(ds, intr))
        c1 = _proj(X1, intr).reshape(B, 2, self.num_levels, 2 * r + 1, h, w)
        return c1, max_dx, ds

    def depth2gradcoords(self, poses: Tensor, depths: Tensor, K: Tensor):
        """The projected point and its +-1 pixel shifts (B, 2, 1, 5, h, w),
        and the transformed points P2 (B, 3, h w)."""
        intr = Intrinsics.from_K(K)
        B, _, h, w = depths.shape
        X1 = _transform(poses, _iproj(depths[:, :, None], intr))
        c1 = _proj(X1, intr).reshape(B, 2, 1, 1, h, w)
        p_delta = torch.tensor([[1.0, -1.0, 0.0, 0.0], [0.0, 0.0, 1.0, -1.0]],
                               dtype=c1.dtype, device=c1.device)
        c1 = torch.cat([c1, c1 + p_delta.reshape(1, 2, 1, 4, 1, 1)], dim=3)
        return c1, X1[:, :3]

    def depthbins2coords(self, poses: Tensor, depths: Tensor, K: Tensor):
        """The 96-bin sweep from min_depth to 8x the depth for the
        consistency mask (`utils.py:232-255`): (coords (B, 2, 1, D, h, w),
        depths (B, 1, D, h, w))."""
        intr = Intrinsics.from_K(K)
        B, _, h, w = depths.shape
        D = self.num_depth_bins
        lin = torch.linspace(0.0, 1.0, D, dtype=depths.dtype,
                             device=depths.device)
        depths_ = (8.0 * (depths - self.min_depth)
                   + self.min_depth).clamp(max=self.max_depth)
        lin_ = (depths_ - self.min_depth) / (depths - self.min_depth)
        lin_full = lin[None, None, :, None, None] * lin_[:, None]
        ds = lin_full * (depths[:, None] - self.min_depth) + self.min_depth
        X1 = _transform(poses, _iproj(ds, intr))
        c1 = _proj(X1, intr).reshape(B, 2, 1, D, h, w)
        return c1, ds
