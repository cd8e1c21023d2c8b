"""HR depth decoder with channel-attention fusion (PyTorch, NCHW).

Counterpart of `mal_tpu.dualref.hr_decoder`; reference
`dualrefine/networks/hr_depth_decoder.py` with the `Attention_Module` /
`ChannelAttention` blocks of `dualrefine/layers.py:305-475`. The DualRefine
trunk taps it mid-way (`depth_pose.py:257-283`), so `forward` also returns
the intermediate maps.

The modules sit in the reference's `convs` ModuleDict (`72`, `36`, `18`,
`9`, `up_x9_0`, `up_x9_1`, `dispConvScale0..3`); `decoder` is the same
modules again as a ModuleList, registered twice as the reference does
(`hr_depth_decoder.py:42`), so the state dict has both key sets.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.models.depth_decoder import Conv3x3, ConvBlock
from gpubench.reference.ops.interp import upsample2x_nearest

Tensor = torch.Tensor

# the `decoder` ModuleList's order (`hr_depth_decoder.py:33-42`)
ALIAS_ORDER = ("up_x9_0", "up_x9_1", "72", "36", "18", "9", "dispConvScale0",
               "dispConvScale1", "dispConvScale2", "dispConvScale3")


class ChannelAttention(nn.Module):
    """SE block: global average pool, two bias-free Linears (reduction 16)
    with a ReLU between, sigmoid scale."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = max(channels // ratio, 1)
        self.fc = nn.Sequential(nn.Linear(channels, hidden, bias=False),
                                nn.ReLU(),
                                nn.Linear(hidden, channels, bias=False))

    def forward(self, x: Tensor) -> Tensor:
        s = torch.sigmoid(self.fc(x.mean(dim=(2, 3))))
        return s[:, :, None, None] * x


class AttentionModule(nn.Module):
    """x2-upsampled high-level input, concatenated low-level skips, SE, 3x3
    conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.ca = ChannelAttention(in_channels)
        self.conv_se = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, high: Tensor, lows: list[Tensor],
                relu: bool = True) -> Tensor:
        feats = torch.cat([upsample2x_nearest(high)] + list(lows), dim=1)
        out = self.conv_se(self.ca(feats))
        return F.relu(out) if relu else out


class HRDepthDecoder(nn.Module):
    """Four sigmoid disparities over the HRNet taps (`num_ch_enc` is the
    trunk's (64, w, 2w, 4w, 8w))."""

    def __init__(self, num_ch_enc: tuple[int, ...] = (64, 18, 36, 72, 144),
                 num_ch_dec: tuple[int, ...] = (16, 32, 64, 128, 256)):
        super().__init__()
        c64, c18, c36, c72, c144 = num_ch_enc
        convs = {
            "72": AttentionModule(c144 + 2 * c72, 256),
            "36": AttentionModule(256 + 3 * c36, 128),
            "18": AttentionModule(128 + c64 + 3 * c18, 64),
            "9": AttentionModule(64 + 64, 32),
            "up_x9_0": ConvBlock(32, num_ch_dec[0]),
            "up_x9_1": ConvBlock(num_ch_dec[0], num_ch_dec[0]),
            "dispConvScale0": Conv3x3(num_ch_dec[0], 1),
            "dispConvScale1": Conv3x3(32, 1),
            "dispConvScale2": Conv3x3(64, 1),
            "dispConvScale3": Conv3x3(128, 1),
        }
        self.convs = nn.ModuleDict(convs)
        self.decoder = nn.ModuleList([convs[k] for k in ALIAS_ORDER])

    def forward(self, taps: dict):
        """taps from `HRNet.forward`. Returns ({scale: disp}, intermediates)."""
        c = self.convs
        x72 = c["72"](taps["x144"], taps["list72"])
        x36 = c["36"](x72, taps["list36"])
        x18 = c["18"](x36, taps["list18"], relu=False)
        relu_x18 = F.relu(x18)
        x9 = c["9"](relu_x18, [taps["stem1"]])
        x6 = c["up_x9_1"](upsample2x_nearest(c["up_x9_0"](x9)))
        disps = {0: torch.sigmoid(c["dispConvScale0"](x6)),
                 1: torch.sigmoid(c["dispConvScale1"](x9)),
                 2: torch.sigmoid(c["dispConvScale2"](relu_x18)),
                 3: torch.sigmoid(c["dispConvScale3"](x36))}
        inter = {"x36": x36, "x18": x18, "relu_x18": relu_x18, "x9": x9,
                 "x6": x6}
        return disps, inter
