"""DEQ update block (PyTorch, NCHW).

Counterpart of `mal_tpu.dualref.update`; reference `SmallUpdateBlock`,
`dualrefine/networks/update.py`: a motion encoder over (cost, depth), a
ConvGRU with global-context gating, the depth-delta head, the convex
upsampling mask head and the evolving pose-weight head.

Weight normalisation is written out: w = g v / ||v||, the norm per output
channel over (input, kh, kw) with `mal_tpu`'s 1e-12 inside the root, on
parameters named as torch's `weight_norm(dim=0)` stores them
(`weight_v` (O, I, kh, kw), `weight_g` (O, 1, 1, 1)), so that a reference
`depth_pose.pth` loads directly. Without weight norm a conv holds a plain
`weight`, as the reference's does under `--disable_wnorm`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


class WNConv2d(nn.Module):
    """Stride-1 conv with zeros padding `padding`, weight-normalised when
    `use_wnorm`."""

    def __init__(self, in_ch: int, out_ch: int, k: int, padding: int,
                 use_wnorm: bool = True):
        super().__init__()
        shape = (out_ch, in_ch, k, k)
        self.padding = padding
        self.use_wnorm = use_wnorm
        if use_wnorm:
            self.weight_g = nn.Parameter(torch.ones(out_ch, 1, 1, 1))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: Tensor) -> Tensor:
        if self.use_wnorm:
            v = self.weight_v
            w = self.weight_g * v / torch.sqrt(
                (v * v).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
        else:
            w = self.weight
        return F.conv2d(x, w, self.bias, padding=self.padding)


class ConvGRU(nn.Module):
    """GRU with global-context gating (`update.py:37-83`)."""

    def __init__(self, hidden_dim: int, input_dim: int,
                 use_wnorm: bool = True):
        super().__init__()
        hd, wn = hidden_dim, use_wnorm
        self.w = WNConv2d(hd, hd, 1, 0, wn)
        self.conv_net = WNConv2d(hd, 2 * hd, 3, 1, wn)
        self.conv_inp = WNConv2d(input_dim, 2 * hd, 3, 1, wn)
        self.convz_glo = WNConv2d(hd, hd, 1, 0, wn)
        self.convr_glo = WNConv2d(hd, hd, 1, 0, wn)
        self.convq_glo = WNConv2d(hd, hd, 1, 0, wn)
        self.convq = WNConv2d(hd + input_dim, hd, 3, 1, wn)

    def forward(self, h: Tensor, x: Tensor) -> Tensor:
        glo = (torch.sigmoid(self.w(h)) * h).mean(dim=(2, 3), keepdim=True)
        z_net, r_net = self.conv_net(h).chunk(2, dim=1)
        z_inp, r_inp = self.conv_inp(x).chunk(2, dim=1)
        z = torch.sigmoid(z_net + z_inp + self.convz_glo(glo))
        r = torch.sigmoid(r_net + r_inp + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1))
                       + self.convq_glo(glo))
        return (1.0 - z) * h + z * q


class SmallMotionEncoder(nn.Module):
    """(depth, cost) -> 64-channel motion features (`update.py:86-122`)."""

    def __init__(self, cor_planes: int, use_wnorm: bool = True):
        super().__init__()
        wn = use_wnorm
        self.convc1 = WNConv2d(cor_planes, 96, 1, 0, wn)
        self.convc2 = WNConv2d(96, 64, 3, 1, wn)
        self.convf1 = WNConv2d(1, 64, 7, 3, wn)
        self.convf2 = WNConv2d(64, 32, 3, 1, wn)
        self.conv = WNConv2d(96, 63, 3, 1, wn)

    def forward(self, depths: Tensor, corr: Tensor) -> Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        dep = F.relu(self.convf2(F.relu(self.convf1(depths))))
        out = F.relu(self.conv(torch.cat([cor, dep], dim=1)))
        return torch.cat([out, depths], dim=1)


class ConvHead(nn.Module):
    """The depth-delta head (weight-normalised, as in the reference)."""

    def __init__(self, hidden_dim: int, use_wnorm: bool = True):
        super().__init__()
        self.conv1 = WNConv2d(hidden_dim, 64, 3, 1, use_wnorm)
        self.conv2 = WNConv2d(64, 1, 3, 1, use_wnorm)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class SmallUpdateBlock(nn.Module):
    """GRU step (net, inp, corr, depth) -> (net', delta), with the mask and
    pose-weight heads (`update.py:125-162`), which are not
    weight-normalised."""

    def __init__(self, cor_planes: int, input_dim: int = 64,
                 hidden_dim: int = 64, use_wnorm: bool = True,
                 evolving_pose_weight: bool = True):
        super().__init__()
        self.encoder = SmallMotionEncoder(cor_planes, use_wnorm)
        self.gru = ConvGRU(hidden_dim, input_dim + 64, use_wnorm)
        self.conv_head = ConvHead(hidden_dim, use_wnorm)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 64, 3, padding=1),
                                  nn.ReLU(), nn.Conv2d(64, 16 * 9, 1))
        self.weight = (nn.Sequential(nn.Conv2d(hidden_dim, 32, 3, padding=1),
                                     nn.ReLU(), nn.Conv2d(32, 1, 1))
                       if evolving_pose_weight else None)

    def forward(self, net: Tensor, inp: Tensor, corr: Tensor,
                depths: Tensor) -> tuple[Tensor, Tensor]:
        motion = self.encoder(depths, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.conv_head(net)

    def upsample_mask(self, net: Tensor) -> Tensor:
        return self.mask(net)

    def pose_weight(self, net: Tensor) -> Tensor:
        return torch.sigmoid(self.weight(net))


def convex_upsample_disp(disp: Tensor, mask: Tensor, factor: int = 4) -> Tensor:
    """RAFT convex x4 upsampling (`depth_pose.py:345-360`).

    disp (B, 1, h, w); mask (B, 144, h, w) from `upsample_mask`, its
    channels (neighbour k, sub-pixel f) in `mal_tpu`'s order k * 16 + f."""
    B, _, h, w = disp.shape
    mask = torch.softmax((0.25 * mask).reshape(B, 9, factor * factor, h, w),
                         dim=1)
    pad = F.pad(disp[:, 0], (1, 1, 1, 1))
    patches = torch.stack([pad[:, dy:dy + h, dx:dx + w]
                           for dy in range(3) for dx in range(3)], dim=1)
    up = (patches[:, :, None] * mask).sum(dim=1)          # (B, 16, h, w)
    up = up.reshape(B, factor, factor, h, w).permute(0, 3, 1, 4, 2)
    return up.reshape(B, 1, h * factor, w * factor)
