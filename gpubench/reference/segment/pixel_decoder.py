"""MSDeformAttn pixel decoder (PyTorch).

Counterpart of `mal_tpu.segment.pixel_decoder` (reference
`mask2former/modeling/pixel_decoder/msdeformattn.py:23-358`): 1x1 input
projections with GroupNorm(32) on res5 / res4 / res3, deformable-attention
encoder layers with level embeddings, then an FPN step with res2 down to
the 1/4-resolution mask features. Names are detectron2's
(`input_proj.{i}.{0,1}`, `transformer.encoder.layers.{l}`, `adapter_1`,
`layer_1`, `mask_features`); every norm uses flax's eps of 1e-6. Feature
maps in and out are (B, h, w, C), as in `mal_tpu`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.ops import precision
from gpubench.reference.ops.interp import resize_bilinear
from gpubench.reference.segment.msdeform import D_MODEL, LEVELS, MSDeformAttn

Tensor = torch.Tensor

NORM_EPS = 1e-6
ENCODER_LAYERS, FFN_DIM = 6, 1024   # the reference's pixel decoder
POS_TEMPERATURE = 10000


def _gn(channels: int, eps: float = NORM_EPS) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=eps)


class Conv2dNorm(nn.Conv2d):
    """detectron2's `Conv2d` with its GroupNorm(32) inside (keys `.weight`,
    `.norm.*`), of epsilon `eps`."""

    def __init__(self, *args, eps: float = NORM_EPS, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = _gn(self.out_channels, eps)

    def forward(self, x: Tensor) -> Tensor:
        return self.norm(super().forward(x))


def position_embedding_sine(h: int, w: int, device=None,
                            dim: int = D_MODEL) -> Tensor:
    """Sine position encoding (h * w, dim), normalised by (h + eps) as
    `mal_tpu/segment/pixel_decoder.py:51-70` does."""
    ys = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :]
    eps = 1e-6
    y_embed = ys / (h + eps) * (2 * math.pi)
    x_embed = xs / (w + eps) * (2 * math.pi)
    half = dim // 2
    dim_t = POS_TEMPERATURE ** (2 * (torch.arange(half, device=device) // 2)
                                / half)
    pos_x = x_embed[..., None] / dim_t                   # (1, w, half)
    pos_y = y_embed[..., None] / dim_t                   # (h, 1, half)
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).reshape(1, w, half)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).reshape(h, 1, half)
    pos = torch.cat([pos_y.expand(h, w, half), pos_x.expand(h, w, half)],
                    dim=-1)
    return pos.reshape(h * w, dim)


class DeformableEncoderLayer(nn.Module):
    """`bf16_compute` (fast mode, `mal_tpu/segment/pixel_decoder.py:31-48`):
    the two FFN Linears in bf16, the norms and the residual in fp32."""

    def __init__(self, bf16_compute: bool = False):
        super().__init__()
        self.compute_dtype = torch.bfloat16 if bf16_compute else None
        self.self_attn = MSDeformAttn(
            mxu_precision="bf16" if bf16_compute else "high")
        self.norm1 = nn.LayerNorm(D_MODEL, eps=NORM_EPS)
        self.linear1 = nn.Linear(D_MODEL, FFN_DIM)
        self.linear2 = nn.Linear(FFN_DIM, D_MODEL)
        self.norm2 = nn.LayerNorm(D_MODEL, eps=NORM_EPS)

    def forward(self, src: Tensor, pos: Tensor, reference_points: Tensor,
                spatial_shapes) -> Tensor:
        attn = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + attn)
        dt = self.compute_dtype
        y = F.relu(precision.linear(self.linear1, src, dt))
        y = precision.linear(self.linear2, y, dt)
        return self.norm2(src + y.float())


class _Transformer(nn.Module):
    def __init__(self, bf16_compute: bool = False):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(LEVELS, D_MODEL))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [DeformableEncoderLayer(bf16_compute)
             for _ in range(ENCODER_LAYERS)])


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, in_channels: dict[str, int],
                 bf16_compute: bool = False):
        super().__init__()
        d = D_MODEL
        self.input_proj = nn.ModuleList([
            nn.Sequential(nn.Conv2d(in_channels[k], d, 1), _gn(d))
            for k in ("res5", "res4", "res3")])
        self.transformer = _Transformer(bf16_compute)
        self.adapter_1 = Conv2dNorm(in_channels["res2"], d, 1, bias=False)
        self.layer_1 = Conv2dNorm(d, d, 3, padding=1, bias=False)
        self.mask_features = nn.Conv2d(d, d, 1)

    def forward(self, features: dict[str, Tensor]):
        """features {"res2".."res5"} (B, h, w, C). Returns (mask_features
        (B, H/4, W/4, 256), [res5', res4', res3'] each (B, h, w, 256))."""
        srcs, shapes = [], []
        for proj, key in zip(self.input_proj, ("res5", "res4", "res3")):
            x = proj(features[key].permute(0, 3, 1, 2))
            B, _, h, w = x.shape
            srcs.append(x.flatten(2).transpose(1, 2))    # (B, h*w, C)
            shapes.append((h, w))
        dev = srcs[0].device
        level_embed = self.transformer.level_embed
        pos_flat = torch.cat(
            [position_embedding_sine(h, w, device=dev)
             + level_embed[i] for i, (h, w) in enumerate(shapes)])[None]
        y = torch.cat(srcs, dim=1)

        # reference points: each level's normalised pixel centres, the same
        # for every level (deformable DETR convention)
        refs = []
        for h, w in shapes:
            ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            refs.append(torch.stack([gx, gy], -1).reshape(h * w, 2))
        refs = torch.cat(refs)[None, :, None, :].expand(B, -1, LEVELS, 2)

        for layer in self.transformer.encoder.layers:
            y = layer(y, pos_flat, refs, shapes)

        parts = y.split([h * w for h, w in shapes], dim=1)
        outs = [p.reshape(B, h, w, D_MODEL)
                for p, (h, w) in zip(parts, shapes)]     # [res5', res4', res3']

        r2 = features["res2"]
        lat = self.adapter_1(r2.permute(0, 3, 1, 2))
        top = resize_bilinear(outs[-1].permute(0, 3, 1, 2), r2.shape[1],
                              r2.shape[2])
        fused = F.relu(self.layer_1(lat + top))
        mask_features = self.mask_features(fused)
        return mask_features.permute(0, 2, 3, 1), outs
