"""Monodepth2-style U-Net depth decoder (PyTorch, NCHW).

Counterpart of `mal_tpu.models.depth_decoder`; reference
`manydepth/networks/depth_decoder.py:16-68`: five up-conv stages
(reflect-padded 3x3 conv + ELU), nearest x2 upsampling, encoder skips and a
single full-resolution sigmoid disparity head. Modules sit in the
reference's `decoder` list: entries 0-9 are `upconv_{4..0}_{0,1}`, entry 10
is the disparity conv.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.models.resnet import Conv2d
from gpubench.reference.ops.interp import upsample2x_nearest

Tensor = torch.Tensor


class Conv3x3(nn.Module):
    """Reflect-pad 1 + 3x3 conv (`manydepth/layers.py:103-135`)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv3x3(in_ch, out_ch, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    """5-stage decoder over an encoder pyramid; returns disparity (B, 1, H,
    W) in fp32: with `dtype=torch.bfloat16` the convolutions and ELUs run in
    bf16 and the sigmoid, like everything after it, in fp32
    (`mal_tpu/models/depth_decoder.py:66`)."""

    def __init__(self, num_ch_enc: tuple[int, ...],
                 num_ch_dec: tuple[int, ...] = (16, 32, 64, 128, 256),
                 dtype: torch.dtype | None = None):
        super().__init__()
        layers = []
        for i in range(4, -1, -1):
            in_ch = num_ch_enc[-1] if i == 4 else num_ch_dec[i + 1]
            layers.append(ConvBlock(in_ch, num_ch_dec[i], dtype))
            skip = num_ch_enc[i - 1] if i > 0 else 0
            layers.append(ConvBlock(num_ch_dec[i] + skip, num_ch_dec[i], dtype))
        layers.append(Conv3x3(num_ch_dec[0], 1, dtype))
        self.decoder = nn.ModuleList(layers)

    def forward(self, input_features: list[Tensor]) -> Tensor:
        x = input_features[-1]
        for stage, i in enumerate(range(4, -1, -1)):
            x = upsample2x_nearest(self.decoder[2 * stage](x))
            if i > 0:
                x = torch.cat([x, input_features[i - 1].to(x.dtype)], dim=1)
            x = self.decoder[2 * stage + 1](x)
        return torch.sigmoid(self.decoder[10](x).float())
