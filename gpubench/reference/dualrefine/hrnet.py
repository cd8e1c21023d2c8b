"""HRNet encoder (PyTorch, NCHW): DualRefine's trunk.

Counterpart of `mal_tpu.dualref.hrnet`: the HRNet-W18/32/48/64 trunk of
`dualrefine/networks/hr_encoder.py` (config `hrnet_config.py`): two
stride-2 stem convolutions, a Bottleneck stage, then multi-resolution
stages whose exchange units sum every branch into every resolution (1x1
conv + BN + bilinear upsampling upwards, chains of 3x3 stride-2 convs
downwards).

Children carry the reference's names without its `cnet_` prefix
(`layer0a`, `layer0b`, `layer1`, `transition{1,2,3}`, `stage{2,3,4}`, each
`HighResolutionModule` with `branches` and `fuse_layers`;
`dualrefine/networks/depth_pose.py:117-130`); `DEQDepthPose` registers
them with the prefix, so its state dict has the layout of `depth_pose.pth`.

`forward` returns the tap set of `depth_pose.py:193-283`:
  stem1   (B, 64, H/2, W/2)
  stem2   (B, 64, H/4, W/4)
  list18  4 maps at 1/4 (stem2, stage 2..4 branch 0)
  list36  3 maps at 1/8
  list72  2 maps at 1/16
  x144    1 map at 1/32
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.models.resnet import (BasicBlock, BatchNorm2d,
                                               Bottleneck, conv)
from gpubench.reference.ops.interp import resize_bilinear

Tensor = torch.Tensor

# (num_modules, num_blocks) of stages 2-4, shared by every width
_STAGES = {2: (1, 4), 3: (4, 4), 4: (3, 4)}


def _conv_bn(in_ch: int, out_ch: int, k: int, stride: int, relu: bool,
             dtype: torch.dtype | None) -> nn.Sequential:
    """Sequential(conv, BN[, ReLU]) — indices 0 and 1 as the reference."""
    mods = [conv(in_ch, out_ch, k, stride, k // 2, dtype=dtype),
            BatchNorm2d(out_ch)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class HighResolutionModule(nn.Module):
    """One exchange unit: per-branch BasicBlocks, then out[i] =
    relu(sum_j path_j->i(branch j))."""

    def __init__(self, channels: tuple[int, ...], num_blocks: int = 4,
                 dtype: torch.dtype | None = None):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(c, c, dtype=dtype)
                            for _ in range(num_blocks)]) for c in channels])
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:      # upsample path: 1x1 conv + BN, then resize
                    row.append(_conv_bn(channels[j], channels[i], 1, 1,
                                        False, dtype))
                elif j == i:
                    row.append(None)
                else:          # downsample path: chain of 3x3 stride 2
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        out = channels[i] if last else channels[j]
                        chain.append(_conv_bn(channels[j], out, 3, 2,
                                              not last, dtype))
                    row.append(nn.Sequential(*chain))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows) if n > 1 else None

    def forward(self, xs: list[Tensor]) -> list[Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, path in enumerate(row):
                if j == i:
                    v = ys[j]
                elif j > i:
                    # mal_tpu's resize returns its input's type
                    v = path(ys[j])
                    v = resize_bilinear(v, *ys[i].shape[-2:]).to(v.dtype)
                else:
                    v = path(ys[j])
                acc = v if acc is None else acc + v
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    """`dtype` (None or bf16) is the convolutions' compute type, as in
    `mal_tpu` (parameters and BN statistics stay fp32; the caller casts the
    taps back to fp32)."""

    def __init__(self, base_width: int = 18, dtype: torch.dtype | None = None):
        super().__init__()
        w = base_width
        ch2, ch3, ch4 = (w, 2 * w), (w, 2 * w, 4 * w), (w, 2 * w, 4 * w, 8 * w)
        if w == 64:   # HRNet-64 uses its own stage widths
            ch2, ch3, ch4 = (64, 128), (64, 128, 256), (64, 128, 256, 512)
        self.layer0a = _conv_bn(3, 64, 3, 2, True, dtype)
        self.layer0b = _conv_bn(64, 64, 3, 2, True, dtype)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0,
                       dtype=dtype) for b in range(4)])
        # transitions: the reference nests the new lowest branch one
        # Sequential deeper (`hr_encoder.py:359-392`)
        self.transition1 = nn.ModuleList([
            _conv_bn(256, ch2[0], 3, 1, True, dtype),
            nn.Sequential(_conv_bn(256, ch2[1], 3, 2, True, dtype))])
        self.transition2 = nn.ModuleList(
            [None, None, nn.Sequential(_conv_bn(ch2[1], ch3[2], 3, 2, True,
                                                dtype))])
        self.transition3 = nn.ModuleList(
            [None, None, None, nn.Sequential(_conv_bn(ch3[2], ch4[3], 3, 2,
                                                      True, dtype))])
        for stage, chans in ((2, ch2), (3, ch3), (4, ch4)):
            n_mod, n_blocks = _STAGES[stage]
            self.add_module(f"stage{stage}", nn.Sequential(*[
                HighResolutionModule(chans, n_blocks, dtype)
                for _ in range(n_mod)]))
        self.num_ch_enc = (64, *ch4)

    def forward(self, x: Tensor, stages_count: int | None = None) -> dict:
        """`stages_count=B` runs the stem on the whole (e.g. concatenated
        2B) batch, so that train-mode BatchNorm statistics pool both images,
        and the stages on its first B items (`depth_pose.py:203-213`)."""
        stem1 = self.layer0a(x)
        stem2 = self.layer0b(stem1)
        y = stem2 if stages_count is None else stem2[:stages_count]
        z = self.layer1(y)
        xs = [self.transition1[0](z), self.transition1[1](z)]
        xs = s2 = self._stage(self.stage2, xs)
        xs = s3 = self._stage(self.stage3, xs + [self.transition2[2](xs[-1])])
        s4 = self._stage(self.stage4, xs + [self.transition3[3](xs[-1])])
        return {"stem1": stem1, "stem2": stem2,
                "list18": [y, s2[0], s3[0], s4[0]],
                "list36": [s2[1], s3[1], s4[1]],
                "list72": [s3[2], s4[2]],
                "x144": s4[3]}

    @staticmethod
    def _stage(stage: nn.Sequential, xs: list[Tensor]) -> list[Tensor]:
        for module in stage:
            xs = module(xs)
        return xs
