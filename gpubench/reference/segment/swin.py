"""Swin Transformer backbone of the frozen Mask2Former (PyTorch, NHWC).

Counterpart of `mal_tpu.segment.swin`: patch embedding, windowed and
shifted-window attention with relative-position bias, patch merging and the
per-stage LayerNorm outputs. Each stage is a plain loop over its blocks. A
block has three forms, all on the same parameters:

- exact fp32 (`swin.py:250-271`), the default: the attention core is kernel
  K4 (`ops/cuda/window_attention.py`);
- unfused bf16 (`bf16_compute=True`): every Linear (qkv, proj, fc1, fc2) in
  bf16 as flax's `nn.Dense(dtype=bfloat16)` computes it, norms and the
  residual stream in fp32, K4 fed the fp32 cast of the bf16 qkv as the TPU's
  attention kernel upcasts it;
- fused (`fused_block=True`, `swin.py:206-248`): the block is kernels K2 and
  K3 (`ops/cuda/swin_block.py`); with `bf16_compute` the residual stream of
  the stage is bf16 too (`swin.py:394-396`).
In this copy every kernel is its plain version (`ops/kernels.py`). The
segmenter is frozen: only the inference forward is kept (the port's train
mode, for fine-tuning, is not copied).

Module and parameter names are detectron2's `D2SwinTransformer`
(`mask2former/modeling/backbone/swin.py`), so the state dict has the keys of
the published checkpoints; every LayerNorm uses flax's eps of 1e-6, as
`mal_tpu` does. Feature maps are (B, H, W, C) throughout, as in `mal_tpu`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.ops import precision
from gpubench.reference.ops.kernels import swin_attn_fused, swin_mlp_fused
from gpubench.reference.ops.kernels import (relative_position_index,
                                            window_attention)

Tensor = torch.Tensor

LN_EPS = 1e-6   # flax's default, which mal_tpu's segmenter keeps everywhere
MLP_RATIO = 4

CONFIGS = {
    # embed_dim, depths, num_heads, window; "large" is the temporal hint's
    # segmenter, "tiny" the small one the tests and references build
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32), 12),
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12),
}


def window_partition(x: Tensor, ws: int) -> Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws * ws, C); H, W divisible by ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(wins: Tensor, ws: int, H: int, W: int) -> Tensor:
    """Inverse of `window_partition` -> (B, H, W, C)."""
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def shift_mask(H: int, W: int, ws: int, shift: int, device=None) -> Tensor:
    """(nm, N, N) additive mask of the shifted windows: -100 between tokens
    of different regions (`mal_tpu/segment/swin.py:312-321`). Symmetric, as
    K4 requires."""
    img = torch.zeros((1, H, W, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    wins = window_partition(img, ws)[..., 0]            # (nm, N)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    """Windowed multi-head self-attention with relative-position bias."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size)))

    def forward(self, x: Tensor, mask: Tensor | None = None) -> Tensor:
        """x (nW, N, C) windows; mask (nm, N, N) or None."""
        dt = self.compute_dtype
        qkv = precision.linear(self.qkv, x, dt)
        out = window_attention(qkv.float(), self.relative_position_bias_table,
                               mask, self.num_heads)
        return precision.linear(self.proj, out, dt).to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: Tensor) -> Tensor:
        # exact erf GELU, as torch's nn.GELU and mal_tpu (`swin.py:269`)
        dt = self.compute_dtype
        y = F.gelu(precision.linear(self.fc1, x, dt))
        return precision.linear(self.fc2, y, dt).to(x.dtype)


class SwinBlock(nn.Module):
    """One Swin block; `shifted` selects the SW-MSA form, `compute_dtype`
    (None or bfloat16) the type of its Linears, `fused` the K2 + K3 form."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shifted: bool, compute_dtype: torch.dtype | None = None,
                 fused: bool = False):
        super().__init__()
        self.window_size = window_size
        self.shifted = shifted
        self.compute_dtype = compute_dtype
        self.fused = fused
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size, compute_dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim, compute_dtype)

    def forward(self, x: Tensor, mask: Tensor | None, shift: int,
                valid: Tensor | None = None) -> Tensor:
        """x (B, H, W, C). Pads to window multiples *after* norm1, as the
        reference does: the pad tokens are zero vectors that still act as
        keys. `mask`, `shift` and `valid` come from the stage: the roll
        applies only when the padded map is larger than one window, and
        `valid` (Hp, Wp), 1 on real tokens, is what the fused form zeroes
        the pad tokens by."""
        B, H, W, C = x.shape
        ws = self.window_size
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        roll = shift if self.shifted else 0
        if self.fused:
            return self._forward_fused(x, mask if roll else None, roll, valid)
        y = self.norm1(x)
        if (Hp, Wp) != (H, W):
            y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
        if roll:
            y = torch.roll(y, (-roll, -roll), dims=(1, 2))
        wins = self.attn(window_partition(y, ws), mask if roll else None)
        y = window_reverse(wins, ws, Hp, Wp)
        if roll:
            y = torch.roll(y, (roll, roll), dims=(1, 2))
        x = x + y[:, :H, :W]
        return x + self.mlp(self.norm2(x))

    def _forward_fused(self, x: Tensor, mask: Tensor | None, roll: int,
                       valid: Tensor) -> Tensor:
        """The block as K2 and K3 (`mal_tpu/segment/swin.py:206-248`): pad
        and roll the *stream* and `valid`, K2 (which normalises inside and
        zeroes the pad tokens), un-roll, crop, add the residual in the
        stream's type, K3."""
        B, H, W, C = x.shape
        Hp, Wp = valid.shape
        xr = x
        if (Hp, Wp) != (H, W):
            xr = F.pad(xr, (0, 0, 0, Wp - W, 0, Hp - H))
        if roll:
            xr = torch.roll(xr, (-roll, -roll), dims=(1, 2))
            valid = torch.roll(valid, (-roll, -roll), dims=(0, 1))
        dt = self.compute_dtype or torch.float32
        a = self.attn
        y = swin_attn_fused(
            xr, valid, self.norm1.weight, self.norm1.bias, a.qkv.weight,
            a.qkv.bias, a.relative_position_bias_table, mask, a.proj.weight,
            a.proj.bias, window_size=self.window_size, num_heads=a.num_heads,
            compute_dtype=dt)
        if roll:
            y = torch.roll(y, (roll, roll), dims=(1, 2))
        x = x + y[:, :H, :W]
        out = swin_mlp_fused(
            x.reshape(-1, C), self.norm2.weight, self.norm2.bias,
            self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight,
            self.mlp.fc2.bias, compute_dtype=dt)
        return out.reshape(B, H, W, C)


class BasicLayer(nn.Module):
    """One resolution stage: blocks alternating W-MSA / SW-MSA, then the
    patch merging (absent after the last stage)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 downsample: bool, compute_dtype: torch.dtype | None = None,
                 fused: bool = False):
        super().__init__()
        self.window_size = window_size
        self.fused = fused
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size, shifted=b % 2 == 1,
                      compute_dtype=compute_dtype, fused=fused)
            for b in range(depth)])
        # the merging reduces in bf16 only on a bf16 stream (`swin.py:407-408`)
        self.downsample = (PatchMerging(dim, compute_dtype if fused else None)
                           if downsample else None)

    def forward(self, x: Tensor) -> Tensor:
        ws = self.window_size
        H, W = x.shape[1:3]
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        shift = ws // 2 if min(Hp, Wp) > ws else 0     # `swin.py:203`
        mask = shift_mask(Hp, Wp, ws, shift, x.device) if shift else None
        valid = None
        if self.fused:
            valid = F.pad(torch.ones((H, W), device=x.device),
                          (0, Wp - W, 0, Hp - H))
        for block in self.blocks:
            x = block(x, mask, shift, valid)
        return x


class PatchMerging(nn.Module):
    def __init__(self, dim: int, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        # the official channel order [(0,0), (1,0), (0,1), (1,1)]
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        # the norm is fp32 whatever the stream's type, as flax's LayerNorm
        # with fp32 parameters returns it
        return precision.linear(self.reduction, self.norm(x.float()),
                                self.compute_dtype)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: Tensor) -> Tensor:
        """(B, H, W, 3) -> (B, H/4, W/4, embed_dim)."""
        return self.norm(self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    """Returns {"res2", "res3", "res4", "res5"}, each (B, h, w, C) fp32.

    `bf16_compute` runs every Linear of the blocks in bf16 (parameters stay
    fp32); `fused_block` runs each block as kernels K2 and K3, and with both
    on the residual stream between the kernels is bf16 as well. The
    per-stage output norms are fp32 in every mode (`swin.py:404-405`).
    """

    def __init__(self, size: str = "large", bf16_compute: bool = False,
                 fused_block: bool = False):
        super().__init__()
        embed_dim, depths, heads, ws = CONFIGS[size]
        cdt = torch.bfloat16 if bf16_compute else None
        self.bf16_stream = bf16_compute and fused_block
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList([
            BasicLayer(embed_dim * 2 ** s, depths[s], heads[s], ws,
                       downsample=s < 3, compute_dtype=cdt, fused=fused_block)
            for s in range(4)])
        for s in range(4):
            self.add_module(f"norm{s}", nn.LayerNorm(embed_dim * 2 ** s,
                                                     eps=LN_EPS))

    def forward(self, x: Tensor) -> dict[str, Tensor]:
        """x (B, H, W, 3), H and W multiples of 32."""
        if x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(f"image {tuple(x.shape[1:3])} is not a multiple "
                             f"of 32")
        y = self.patch_embed(x)
        outs = {}
        for s, layer in enumerate(self.layers):
            if self.bf16_stream:
                y = y.to(torch.bfloat16)
            y = layer(y)
            outs[f"res{s + 2}"] = getattr(self, f"norm{s}")(y.float())
            if layer.downsample is not None:
                y = layer.downsample(y)
        return outs
