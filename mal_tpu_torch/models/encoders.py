"""Depth encoders (PyTorch, NCHW inside).

Counterpart of `mal_tpu.models.encoders`:

`ResnetEncoder`: the plain 5-scale pyramid encoder (teacher / pose trunk),
`manydepth/networks/resnet_encoder.py:356-398`.

`ResnetEncoderDYJ`: the multi-frame stacked pose encoder with its conv
pose head, `manydepth/networks/resnet_encoder.py:400-476`.

`ResnetEncoderMatching`: the multi-frame cost-volume encoder,
`manydepth/networks/resnet_encoder.py:71-329`, with the reference's module
layout (`layer0 = conv1 + bn1 + relu`, `layer1 = maxpool + layer1`,
`reduce_conv = conv + relu`). The lookup features and the cost volume are
computed without gradient, as the reference's `torch.no_grad()` blocks and
`mal_tpu`'s `stop_gradient` do; the volume comes from kernel K1
(`ops/cuda/cost_volume_kernel.py`), and inside a depth row
(`parallel/mesh.py:depth_axis`) K1 runs on this rank's share of the
planes and the row gathers the volume (`mal_tpu/models/encoders.py:
140-145`, where GSPMD splits the planes).

`dtype` (None or `torch.bfloat16`) is `mal_tpu`'s: the trunks compute in it
(`models/resnet.py`), and the matching features go back to fp32 before the
cost volume (`mal_tpu/models/encoders.py:129, :136`), so K1 is fed fp32 in
either mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mal_tpu_torch.models.resnet import (Conv2d, ResNetFeatures,
                                         imagenet_normalize, num_ch_enc,
                                         remat)
from mal_tpu_torch.ops.cost_volume import (compute_depth_bins,
                                           confidence_mask_from_cost,
                                           indices_to_disparity)
from mal_tpu_torch.ops.cuda.cost_volume_kernel import (
    plane_sweep_cost_volume_kernel)
from mal_tpu_torch.parallel import mesh

Tensor = torch.Tensor


class ResnetEncoder(nn.Module):
    """Plain ResNet pyramid encoder with input normalisation."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__()
        self.encoder = ResNetFeatures(num_layers, num_input_images, dtype)
        self.num_ch_enc = self.encoder.num_ch_enc
        self.remat = remat

    def forward(self, image: Tensor) -> list[Tensor]:
        """image (B, 3 * num_input_images, H, W)."""
        if self.remat:
            return remat(self._features, image, module=self)
        return self._features(image)

    def _features(self, image: Tensor) -> list[Tensor]:
        return self.encoder(imagenet_normalize(image))


class ResnetEncoderDYJ(nn.Module):
    """Multi-frame stacked pose encoder with a built-in conv pose head
    (`manydepth/networks/resnet_encoder.py:400-476`).

    The modules carry the reference's names: `encoder` (the torchvision
    ResNet of `num_input_images` stacked frames, its unused `fc` included)
    and `net.0`-`net.3` (squeeze 1x1, pose 3x3, pose 3x3, pose 1x1), so a
    reference state dict loads strictly without a converter.

    Frames stack channel-major, (c t) (`mal_tpu/models/encoders.py:76-78`):
    [R_t0..R_tN, G_t0.., B_t0..]. The forward returns `mal_tpu`'s
    (axisangle, translation), each (B, T - 1, 3), the k-th 6-DoF output of
    the head for each k, and not the reference's inconsistently sliced
    4-tuple (`mal_tpu/models/encoders.py:56-62`).
    """

    def __init__(self, num_layers: int = 18, num_input_images: int = 3,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_input_images = num_input_images
        self.encoder = ResNetFeatures(num_layers, num_input_images, dtype)
        last = self.encoder.num_ch_enc[-1]
        # torchvision's classifier, in the reference's state dict; never run
        self.encoder.fc = nn.Linear(last, 1000)
        self.net = nn.ModuleList([
            nn.Conv2d(last, 256, 1), nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 6 * (num_input_images - 1), 1)])

    def forward(self, frames: Tensor) -> tuple[Tensor, Tensor]:
        """frames (B, T, 3, H, W), temporally ordered."""
        B, T, C, H, W = frames.shape
        if T != self.num_input_images:
            raise ValueError(f"{T} frames, the encoder takes "
                             f"{self.num_input_images}")
        x = frames.transpose(1, 2).reshape(B, C * T, H, W)   # (c t)
        out = self.encoder(imagenet_normalize(x))[-1]
        for conv in self.net[:-1]:
            out = torch.relu(conv(out))
        out = self.net[-1](out)
        out = 0.01 * out.mean(dim=(2, 3)).reshape(B, T - 1, 6)
        return out[..., :3], out[..., 3:]


class ResnetEncoderMatching(nn.Module):
    """ResNet encoder with a plane-sweep cost volume after stage 2.

    forward(current_image (B, 3, H, W), lookup_images (B, F, 3, H, W),
    poses (B, F, 4, 4), K, invK at the 1/4 matching scale, min / max depth
    bin) -> (features list, lowest-cost disparity (B, h, w), confidence
    mask (B, h, w)).
    """

    def __init__(self, num_layers: int = 18, num_depth_bins: int = 96,
                 depth_binning: str = "linear",
                 dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__()
        self.num_depth_bins = num_depth_bins
        self.depth_binning = depth_binning
        self.remat = remat
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

        # `remat` recomputes the two trunk halves in the backward, never the
        # gradient-free lookup pass and cost volume between them: K1
        # launches once a step with or without it
        feats = (remat(self.feature_extraction, current_image, module=self)
                 if self.remat else self.feature_extraction(current_image))
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
                depth_bins, mesh.depth_share())
            confidence = confidence_mask_from_cost(cost_volume, missing_mask)
            lowest_cost = indices_to_disparity(cost_volume, depth_bins)
            cost_volume = cost_volume * confidence[:, None]

        deep = (remat(self._deep_stages, cur_feats, cost_volume, module=self)
                if self.remat else self._deep_stages(cur_feats, cost_volume))
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
