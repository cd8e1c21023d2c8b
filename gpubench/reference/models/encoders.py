"""Depth encoders (PyTorch, NCHW inside).

Counterpart of `mal_tpu.models.encoders`:

`ResnetEncoder`: the plain 5-scale pyramid encoder (teacher / pose trunk),
`manydepth/networks/resnet_encoder.py:356-398`.

`ResnetEncoderMatching`: the multi-frame cost-volume encoder,
`manydepth/networks/resnet_encoder.py:71-329`, with the reference's module
layout (`layer0 = conv1 + bn1 + relu`, `layer1 = maxpool + layer1`,
`reduce_conv = conv + relu`). The lookup features and the cost volume are
computed without gradient, as the reference's `torch.no_grad()` blocks and
`mal_tpu`'s `stop_gradient` do; the volume comes from K1's plain version
(`ops/kernels.py`), over all the planes in one process.

`dtype` (None or `torch.bfloat16`) is `mal_tpu`'s: the trunks compute in it
(`models/resnet.py`), and the matching features go back to fp32 before the
cost volume (`mal_tpu/models/encoders.py:129, :136`), so K1 is fed fp32 in
either mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gpubench.reference.models.resnet import (Conv2d, ResNetFeatures,
                                              imagenet_normalize, num_ch_enc)
from gpubench.reference.ops.cost_volume import (compute_depth_bins,
                                           confidence_mask_from_cost,
                                           indices_to_disparity)
from gpubench.reference.ops.kernels import plane_sweep_cost_volume_kernel

Tensor = torch.Tensor


class ResnetEncoder(nn.Module):
    """Plain ResNet pyramid encoder with input normalisation."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.encoder = ResNetFeatures(num_layers, num_input_images, dtype)
        self.num_ch_enc = self.encoder.num_ch_enc

    def forward(self, image: Tensor) -> list[Tensor]:
        """image (B, 3 * num_input_images, H, W)."""
        return self.encoder(imagenet_normalize(image))


class ResnetEncoderMatching(nn.Module):
    """ResNet encoder with a plane-sweep cost volume after stage 2.

    forward(current_image (B, 3, H, W), lookup_images (B, F, 3, H, W),
    poses (B, F, 4, 4), K, invK at the 1/4 matching scale, min / max depth
    bin) -> (features list, lowest-cost disparity (B, h, w), confidence
    mask (B, h, w)).
    """

    def __init__(self, num_layers: int = 18, num_depth_bins: int = 96,
                 depth_binning: str = "linear",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_depth_bins = num_depth_bins
        self.depth_binning = depth_binning
        trunk = ResNetFeatures(num_layers, 1, dtype)
        self.layer0 = nn.Sequential(trunk.conv1, trunk.bn1, nn.ReLU(inplace=True))
        self.layer1 = nn.Sequential(nn.MaxPool2d(3, 2, 1), trunk.layer1)
        self.layer2 = trunk.layer2
        self.layer3 = trunk.layer3
        self.layer4 = trunk.layer4
        self.num_ch_enc = num_ch_enc(num_layers)
        width = self.num_ch_enc[1]
        self.reduce_conv = nn.Sequential(
            Conv2d(width + num_depth_bins, width, 3, padding=1, dtype=dtype),
            nn.ReLU(inplace=True))

    def feature_extraction(self, image: Tensor) -> list[Tensor]:
        """First two ResNet stages (`resnet_encoder.py:235-245`)."""
        f0 = self.layer0(imagenet_normalize(image))
        return [f0, self.layer1(f0)]

    def forward(self, current_image: Tensor, lookup_images: Tensor,
                poses: Tensor, K: Tensor, invK: Tensor,
                min_depth_bin: Tensor, max_depth_bin: Tensor):
        B, F = lookup_images.shape[:2]

        feats = self.feature_extraction(current_image)
        cur_feats = feats[-1].float()               # (B, 64, h, w) at 1/4

        # constant w.r.t. the parameters (`resnet_encoder.py:292-305`); in
        # training mode the lookup pass still updates the BN statistics
        with torch.no_grad():
            lookup = self.feature_extraction(lookup_images.flatten(0, 1))[-1]
            lookup = lookup.float().permute(0, 2, 3, 1).unflatten(0, (B, F))
            depth_bins = compute_depth_bins(min_depth_bin, max_depth_bin,
                                            self.num_depth_bins,
                                            self.depth_binning)
            cost_volume, missing_mask = plane_sweep_cost_volume_kernel(
                cur_feats.permute(0, 2, 3, 1), lookup, poses, K, invK,
                depth_bins)
            confidence = confidence_mask_from_cost(cost_volume, missing_mask)
            lowest_cost = indices_to_disparity(cost_volume, depth_bins)
            cost_volume = cost_volume * confidence[:, None]

        deep = self._deep_stages(cur_feats, cost_volume)
        return feats + deep, lowest_cost, confidence

    def _deep_stages(self, cur_feats: Tensor, cost_volume: Tensor
                     ) -> list[Tensor]:
        """[features | cost] fused back to the trunk width, then stages 3-5
        (`resnet_encoder.py:115-119,320-325`)."""
        y = self.reduce_conv(torch.cat([cur_feats, cost_volume], dim=1))
        deep = []
        for layer in (self.layer2, self.layer3, self.layer4):
            y = layer(y)
            deep.append(y)
        return deep
