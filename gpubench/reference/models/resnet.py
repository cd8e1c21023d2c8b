"""ResNet feature pyramid (PyTorch, NCHW).

Counterpart of `mal_tpu.models.resnet`: the torchvision-style ResNet that
every encoder of the reference uses (`manydepth/networks/resnet_encoder.py:
25-68,356-398`), returning the 5-scale pyramid [1/2, 1/4, 1/8, 1/16, 1/32].
Submodules carry torchvision's names (`conv1`, `bn1`, `layerN.M.*`), so the
state dict has the reference's key layout.

`dtype` (None or `torch.bfloat16`) is `mal_tpu`'s `dtype` argument: the
parameters and the BN running statistics stay fp32; every convolution runs
in `dtype`, and every BatchNorm normalises in fp32 and returns `dtype`, as
flax's `nn.Conv(dtype=...)` and `nn.BatchNorm(dtype=...)` do.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.ops import precision

Tensor = torch.Tensor

BN_MOMENTUM = 0.1   # torch convention; flax's momentum 0.9 is the same EMA
BN_EPS = 1e-5

_LAYOUTS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
            101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
_BOTTLENECK = {50, 101, 152}


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose running variance follows flax: the EMA takes the
    *biased* batch variance, where `torch.nn.BatchNorm2d` takes the unbiased
    one. Forward outputs are the same either way; the running statistics
    after a training forward are what differ, strongly at small maps.

    A bf16 input is normalised in fp32 (statistics, scale and shift) and the
    result rounded to bf16, by torch's own mixed-type batch norm.

    The reference steps on the global batch in one process, so its training
    moments are the global batch's, as the port's data-parallel step
    all-reduces them."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: Tensor) -> Tensor:
        if not self.training:
            return super().forward(x)
        # torch updates `var` to (1 - m) old + m * v * n / (n - 1), with v
        # the biased batch variance; subtracting (var - (1 - m) old) / n
        # takes back the n / (n - 1). The op gets a copy, which autograd may
        # save, so the buffer itself can be rewritten afterwards.
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(
                var - (var - (1.0 - self.momentum) * self.running_var) / n)
            self.num_batches_tracked.add_(1)
        return y


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` with fp32 parameters, computed in `dtype` (None: in the
    input's type) as `ops/precision.py:conv2d` says."""

    def __init__(self, *args, dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return precision.conv2d(self, x, self.compute_dtype)


def conv(in_ch: int, out_ch: int, k: int, stride: int = 1, padding: int = 0,
         bias: bool = False, dtype: torch.dtype | None = None) -> Conv2d:
    return Conv2d(in_ch, out_ch, k, stride=stride, padding=padding, bias=bias,
                  dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = conv(in_ch, filters, 3, stride, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = conv(filters, filters, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm2d(filters)
        self.downsample = (nn.Sequential(
            conv(in_ch, filters, 1, stride, dtype=dtype), BatchNorm2d(filters))
            if downsample else None)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        out_ch = filters * 4
        self.conv1 = conv(in_ch, filters, 1, dtype=dtype)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = conv(filters, filters, 3, stride, 1, dtype=dtype)
        self.bn2 = BatchNorm2d(filters)
        self.conv3 = conv(filters, out_ch, 1, dtype=dtype)
        self.bn3 = BatchNorm2d(out_ch)
        self.downsample = (nn.Sequential(
            conv(in_ch, out_ch, 1, stride, dtype=dtype), BatchNorm2d(out_ch))
            if downsample else None)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


def num_ch_enc(num_layers: int) -> tuple[int, ...]:
    if num_layers in _BOTTLENECK:
        return (64, 256, 512, 1024, 2048)
    return (64, 64, 128, 256, 512)


class ResNetFeatures(nn.Module):
    """ResNet trunk returning the 5-scale feature pyramid.

    `num_input_images > 1` stacks frames along channels for the pose
    encoder. The matching encoder regroups these modules into the
    reference's `layer0..layer4` and runs its two halves itself
    (`encoders.py`), which is what `mal_tpu`'s `stages` / `start_stage`
    arguments do.
    """

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        layout = _LAYOUTS[num_layers]
        block = Bottleneck if num_layers in _BOTTLENECK else BasicBlock
        # the first convolution casts the (normalised, fp32) image to `dtype`
        self.conv1 = conv(3 * num_input_images, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for i, (width, n) in enumerate(zip((64, 128, 256, 512), layout)):
            stride = 1 if i == 0 else 2
            out_ch = width * block.expansion
            blocks = [block(in_ch, width, stride,
                            downsample=stride != 1 or in_ch != out_ch,
                            dtype=dtype)]
            blocks += [block(out_ch, width, dtype=dtype) for _ in range(n - 1)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            in_ch = out_ch
        self.num_ch_enc = num_ch_enc(num_layers)

    def forward(self, x: Tensor) -> list[Tensor]:
        feats = [F.relu(self.bn1(self.conv1(x)))]                  # 1/2
        y = F.max_pool2d(feats[0], 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            y = layer(y)
            feats.append(y)                                        # 1/4 .. 1/32
        return feats


def imagenet_normalize(img: Tensor) -> Tensor:
    """The reference's input normalisation (`resnet_encoder.py:238`)."""
    return (img - 0.45) / 0.225
