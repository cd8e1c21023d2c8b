"""SSIM dissimilarity (PyTorch, NCHW).

Counterpart of `mal_tpu.ops.ssim`, matching the reference
(`manydepth/layers.py:226-257`): reflection pad 1, 3x3 average pooling for
all moments, C1=0.01^2, C2=0.03^2, output (1 - SSIM)/2 clamped to [0, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _avg_pool3(x: Tensor) -> Tensor:
    """3x3 stride-1 average pool, no padding (input already padded)."""
    return F.avg_pool2d(x, 3, 1)


def _reflect_pad1(x: Tensor) -> Tensor:
    return F.pad(x, (1, 1, 1, 1), mode="reflect")


def ssim(x: Tensor, y: Tensor) -> Tensor:
    """SSIM dissimilarity map, same shape as the inputs (B, C, H, W)."""
    x = _reflect_pad1(x)
    y = _reflect_pad1(y)

    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)

    sigma_x = _avg_pool3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y

    ssim_n = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)

    return torch.clamp((1.0 - ssim_n / ssim_d) / 2.0, 0.0, 1.0)
