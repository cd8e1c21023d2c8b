"""Feature-metric Gauss-Newton pose update (PyTorch).

Counterpart of `mal_tpu.dualref.pose_update`; reference `PoseUpdate`,
`dualrefine/networks/utils/utils.py:258-413`: learned per-pixel
uncertainty weights 1 / (1 + w), the 6-DoF pixel Jacobian, the image
gradient from +-1 pixel samples, the weighted normal equations H = Jᵀ W J,
a Cholesky solve with a generic-solve fallback, and an SE(3) exponential
composed onto the pose. H and b come from `ops/cuda/gauss_newton.py:
normal_equations`: on a card one CUDA reduction (and its backward) over
the sampled features, which never writes the (B, N, C, 6) Jacobian; on the
CPU its plain version.

The reference catches a failed Cholesky with try / except. Here, as in
`mal_tpu`, the choice is made per sample without raising: a matrix that is
not positive definite (`torch.linalg.cholesky_ex`'s `info`, or a
non-finite factor) takes `solve(H + 1e-6 I, b)`, and a non-finite update
becomes 0. Neither call synchronises with the card.
"""

from __future__ import annotations

import torch

from mal_tpu_torch import geometry
from mal_tpu_torch.ops.cuda.gauss_newton import normal_equations
from mal_tpu_torch.ops.interp import grid_sample

Tensor = torch.Tensor


def sample_tgt(tgt_feat: Tensor, tgt_w: Tensor, p2: Tensor):
    """Target features at the projected coordinates and their +-1 pixel
    neighbours. tgt_feat (B, C, h, w); tgt_w (B, 1, h, w); p2 (B, 2, 1, 5,
    h, w). Returns (samples (B, C, 5, h, w): the warped features, then x + 1,
    x - 1, y + 1, y - 1; warped weights (B, 1, h, w))."""
    B, _, _, D, h, w = p2.shape
    c = p2[:, :, 0]                                         # (B, 2, 5, h, w)
    gx = 2.0 * (c[:, 0] + 0.5) / w - 1.0
    gy = 2.0 * (c[:, 1] + 0.5) / h - 1.0
    grid = torch.stack([gx, gy], dim=-1)                    # (B, 5, h, w, 2)
    f = grid_sample(tgt_feat, grid.reshape(B, D * h, w, 2), "zeros",
                    align_corners=False)
    w_warp = grid_sample(tgt_w, grid[:, 0], "zeros", align_corners=False)
    return f.reshape(B, -1, D, h, w), w_warp


def barron_weight(cost: Tensor, c: float = 0.1) -> Tensor:
    """The IRLS weight of Barron's robust loss at alpha = 0, scale c:
    2 / (x / c^2 + 2) (`dualrefine/networks/utils/losses.py:38-82`,
    `utils/utils.py:344-348`)."""
    return 2.0 / (cost / (c * c) + 2.0)


def _mask_in_image(coords: Tensor, w: int, h: int, pad: int = 2) -> Tensor:
    """1 where a (B, 2, h, w) centre sample lies `pad` inside the image."""
    x, y = coords[:, 0], coords[:, 1]
    return ((x >= pad) & (x <= w - 1 - pad)
            & (y >= pad) & (y <= h - 1 - pad)).to(torch.float32)


def _safe_cholesky(H: Tensor) -> tuple[Tensor, Tensor]:
    """(L, ok): the Cholesky factor of the symmetrised H (as
    `jnp.linalg.cholesky` symmetrises its input), the identity where H is
    not positive definite."""
    L, info = torch.linalg.cholesky_ex(0.5 * (H + H.transpose(-1, -2)))
    ok = (info == 0) & torch.isfinite(L).all(dim=(-1, -2))
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.where(ok[:, None, None], L, eye), ok


def direct_align(poses: Tensor, K: Tensor, p2: Tensor, P2: Tensor,
                 src_feat: Tensor, tgt_feat: Tensor, src_w: Tensor,
                 tgt_w: Tensor, weight: Tensor | None = None,
                 robust_pose_loss: bool = False):
    """One Gauss-Newton step on the feature-metric residual.

    poses (B, 4, 4); K (B, 4, 4) at the feature scale; p2 (B, 2, 1, 5, h, w)
    projected coordinates with the gradient offsets; P2 (B, 3, h w) the
    transformed points; features (B, C, h, w), weights (B, 1, h, w).
    Returns (new poses, update (B, 6))."""
    B, C, h, w = src_feat.shape
    N = h * w
    f, warped_w = sample_tgt(tgt_feat, tgt_w, p2)

    X, Y, Z = P2[:, 0], P2[:, 1], P2[:, 2]                  # (B, N)
    fx = K[:, 0, 0].reshape(-1, 1)
    fy = K[:, 1, 1].reshape(-1, 1)
    fx_Zi = fx / Z
    fy_Zi = fy / Z
    fx_XZ2 = fx_Zi * X / Z
    fy_YZ2 = fy_Zi * Y / Z
    zeros = torch.zeros_like(fx_XZ2)
    J_row_x = torch.stack([fx_Zi, zeros, -fx_XZ2, -fx_XZ2 * Y,
                           fx + fx_XZ2 * X, -fx_Zi * Y], dim=-1)
    J_row_y = torch.stack([zeros, fy_Zi, -fy_YZ2, -fy - fy_YZ2 * Y,
                           fy_YZ2 * X, fy_Zi * X], dim=-1)
    J_pixel_xi = torch.stack([J_row_x, J_row_y], dim=2)     # (B, N, 2, 6)

    wmap = src_w * warped_w
    if weight is not None:
        wmap = wmap * weight
    if robust_pose_loss:
        # `--robust_pose_loss` (`utils/utils.py:344-355`): the Barron IRLS
        # weight of the squared channel-summed residual, on in-image
        # centre samples only
        res = (src_feat - f[:, :, 0]).reshape(B, C, N).transpose(1, 2)
        cost = (res ** 2).sum(dim=-1).reshape(B, 1, h, w)
        valid = _mask_in_image(p2[:, :, 0, 0], w, h)[:, None]
        wmap = wmap * barron_weight(cost) * valid
    H, b = normal_equations(f.reshape(B, C, 5, N), src_feat.reshape(B, C, N),
                            J_pixel_xi, wmap.reshape(B, N))

    L, ok = _safe_cholesky(H)
    upd_chol = torch.cholesky_solve(b[..., None], L)[..., 0]
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    upd_generic = torch.linalg.solve_ex(H + 1e-6 * eye, b[..., None])[0][..., 0]
    update = torch.where(ok[:, None], upd_chol, upd_generic)
    update = torch.where(torch.isfinite(update), update, 0.0)
    return geometry.se3_exp(update) @ poses, update
