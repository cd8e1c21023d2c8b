"""Pose heads (PyTorch, NCHW).

Counterpart of `mal_tpu.models.pose_decoder`. `PoseDecoder` mirrors
`manydepth/networks/pose_decoder.py:12-52` (squeeze 1x1 conv + 3 pose convs
+ global mean + 0.01 scale). It keeps the reference's `net` module list, so
its state dict has its key layout.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.models.resnet import Conv2d

Tensor = torch.Tensor


class PoseDecoder(nn.Module):
    """(axisangle, translation), each (B, num_frames, 1, 3) in fp32, from
    the last ResNet feature map (B, 512, H/32, W/32). With
    `dtype=torch.bfloat16` the four convolutions run in bf16; the mean and
    what follows stay fp32 (`mal_tpu/models/pose_decoder.py:35`)."""

    def __init__(self, num_ch_in: int = 512, num_frames_to_predict_for: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        n_out = 6 * num_frames_to_predict_for
        self.net = nn.ModuleList([
            Conv2d(num_ch_in, 256, 1, dtype=dtype),                # squeeze
            Conv2d(256, 256, 3, padding=1, dtype=dtype),           # pose_0
            Conv2d(256, 256, 3, padding=1, dtype=dtype),           # pose_1
            Conv2d(256, n_out, 1, dtype=dtype),                    # pose_2
        ])

    def forward(self, last_feature: Tensor):
        y = last_feature
        for i, layer in enumerate(self.net):
            y = layer(y)
            if i < 3:
                y = F.relu(y)
        y = 0.01 * y.float().mean(dim=(2, 3)).reshape(-1, self.num_frames, 1, 6)
        return y[..., :3], y[..., 3:]

