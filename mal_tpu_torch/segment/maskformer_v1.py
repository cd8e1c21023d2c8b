"""MaskFormer-v1 family (PyTorch): the FPN pixel decoders, the DETR-style
standard transformer decoder, `MaskFormerV1` and the per-pixel baseline
head.

Counterpart of `mal_tpu.segment.maskformer_v1`, the reference's
config-selectable alternatives to the Mask2Former stack:
- `mask2former/modeling/pixel_decoder/fpn.py:37-157` (BasePixelDecoder)
  and `:204-312` (TransformerEncoderPixelDecoder);
- `mask2former/modeling/transformer_decoder/
  maskformer_transformer_decoder.py:30-170` (StandardTransformerDecoder)
  over the DETR transformer (`transformer_decoder/transformer.py`);
- `mask2former/modeling/meta_arch/per_pixel_baseline.py:17-125`.

`mal_tpu`'s choices hold: GroupNorm(32) with epsilon 1e-5, nearest
top-down upsampling, post-norm DETR blocks on the `MultiheadAttention` and
`MLP` of `segment/transformer_decoder.py` (LayerNorm epsilon 1e-6, flax's),
no attention dropout (the frozen / eval regime), and the sine position
encoding of `segment/pixel_decoder.py`. Module names are detectron2's
(`adapter_{i}`, `layer_{i}`, `mask_features`, `input_proj`,
`transformer.encoder.layers.{l}`, `transformer.decoder.layers.{l}`,
`transformer.decoder.norm`, `query_embed`, `class_embed`, `mask_embed`).
Feature maps in and out are (B, h, w, C), as in `mal_tpu`.

`MaskFormerV1` runs the port's `SwinTransformer` in its frozen route, so on
CUDA tensors the window attention is kernel K4 (`ops/cuda/
window_attention.py`); nothing else on its path is a kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mal_tpu_torch.device import resolve_device
from mal_tpu_torch.ops.interp import resize_bilinear
from mal_tpu_torch.segment.pixel_decoder import (Conv2dNorm,
                                                 position_embedding_sine)
from mal_tpu_torch.segment.transformer_decoder import MLP, MultiheadAttention

Tensor = torch.Tensor

FEATURES = ("res2", "res3", "res4", "res5")   # strides 4, 8, 16, 32
GN_EPS = 1e-5      # `mal_tpu/segment/maskformer_v1.py:38`
LN_EPS = 1e-6      # flax's LayerNorm
NUM_FEATURE_LEVELS = 3   # maskformer_num_feature_levels


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


class FPNPixelDecoder(nn.Module):
    """BasePixelDecoder (`fpn.py:37-157`): 1x1 lateral and 3x3 output convs
    (GN, ReLU after the output conv), nearest top-down, a 3x3 mask-features
    head. `in_channels` {"res2".. "res5"}: each feature's channels.
    forward(features) -> (mask_features (B, H/4, W/4, mask_dim),
    transformer_features or None, the first three levels coarse to fine)."""

    def __init__(self, in_channels: dict[str, int], conv_dim: int = 256,
                 mask_dim: int = 256):
        super().__init__()
        self.names = [f for f in FEATURES if f in in_channels]
        self.conv_dim = conv_dim
        for i, f in enumerate(self.names[:-1]):
            self.add_module(f"adapter_{i + 1}", Conv2dNorm(
                in_channels[f], conv_dim, 1, bias=False, eps=GN_EPS))
            self.add_module(f"layer_{i + 1}", Conv2dNorm(
                conv_dim, conv_dim, 3, padding=1, bias=False, eps=GN_EPS))
        top = len(self.names)
        self.add_module(f"layer_{top}", Conv2dNorm(
            self._top_channels(in_channels[self.names[-1]]), conv_dim, 3,
            padding=1, bias=False, eps=GN_EPS))
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 3, padding=1)

    def _top_channels(self, channels: int) -> int:
        return channels

    def _coarsest(self, x: Tensor) -> tuple[Tensor, Tensor | None]:
        """The top of the pyramid, NCHW in and out, and the transformer
        features (none here)."""
        return F.relu(getattr(self, f"layer_{len(self.names)}")(x)), None

    def forward(self, features: dict[str, Tensor]):
        multi_scale = []
        y, transformer_features = self._coarsest(
            _nchw(features[self.names[-1]]))
        multi_scale.append(_nhwc(y))
        for i in range(len(self.names) - 2, -1, -1):      # coarse -> fine
            x = _nchw(features[self.names[i]])
            lat = getattr(self, f"adapter_{i + 1}")(x)
            y = lat + F.interpolate(y, size=lat.shape[-2:], mode="nearest")
            y = F.relu(getattr(self, f"layer_{i + 1}")(y))
            if len(multi_scale) < NUM_FEATURE_LEVELS:
                multi_scale.append(_nhwc(y))
        return (_nhwc(self.mask_features(y)), transformer_features,
                multi_scale)


class EncoderLayer(nn.Module):
    """DETR post-norm encoder layer (`transformer.py:
    TransformerEncoderLayer`, normalize_before=False), without dropout."""

    def __init__(self, dim: int, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, src: Tensor, pos: Tensor) -> Tensor:
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + y)


class DecoderLayer(nn.Module):
    """DETR post-norm decoder layer (`transformer.py:
    TransformerDecoderLayer`): query self-attention, cross-attention into
    the memory, FFN."""

    def __init__(self, dim: int, heads: int = 8, ffn_dim: int = 2048):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, heads)
        self.multihead_attn = MultiheadAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, tgt: Tensor, memory: Tensor, qpos: Tensor,
                pos: Tensor) -> Tensor:
        q = tgt + qpos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        y = self.multihead_attn(tgt + qpos, memory + pos, memory)
        tgt = self.norm2(tgt + y)
        y = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + y)


class TransformerEncoderPixelDecoder(FPNPixelDecoder):
    """FPN with a transformer encoder on the coarsest level (`fpn.py:
    204-312`): the encoded map is both the FPN's top and the
    `transformer_features` the standard decoder reads."""

    def __init__(self, in_channels: dict[str, int], conv_dim: int = 256,
                 mask_dim: int = 256, enc_layers: int = 6, heads: int = 8,
                 ffn_dim: int = 2048):
        super().__init__(in_channels, conv_dim, mask_dim)
        self.input_proj = nn.Conv2d(in_channels[self.names[-1]], conv_dim, 1)
        self.transformer = nn.Module()
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layers = nn.ModuleList(
            [EncoderLayer(conv_dim, heads, ffn_dim)
             for _ in range(enc_layers)])

    def _top_channels(self, channels: int) -> int:
        return self.conv_dim

    def _coarsest(self, x: Tensor) -> tuple[Tensor, Tensor]:
        t = self.input_proj(x)
        B, C, h, w = t.shape
        pos = position_embedding_sine(h, w, t.device, C)[None]
        t = t.flatten(2).transpose(1, 2)                  # (B, h*w, C)
        for layer in self.transformer.encoder.layers:
            t = layer(t, pos)
        t = t.transpose(1, 2).reshape(B, C, h, w)
        y = F.relu(getattr(self, f"layer_{len(self.names)}")(t))
        return y, _nhwc(t)


class StandardTransformerDecoder(nn.Module):
    """`maskformer_transformer_decoder.py:30-170`: learned query embeddings
    through a DETR decoder over the transformer features, with the class
    and mask-embed heads after every layer (the reference's
    return_intermediate_dec, for deep supervision)."""

    def __init__(self, in_channels: int, num_classes: int = 80,
                 hidden_dim: int = 256, num_queries: int = 100,
                 dec_layers: int = 6, heads: int = 8, mask_dim: int = 256):
        super().__init__()
        self.input_proj = (nn.Conv2d(in_channels, hidden_dim, 1)
                           if in_channels != hidden_dim else None)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer = nn.Module()
        self.transformer.decoder = nn.Module()
        self.transformer.decoder.layers = nn.ModuleList(
            [DecoderLayer(hidden_dim, heads) for _ in range(dec_layers)])
        self.transformer.decoder.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, mask_dim, 3)

    def forward(self, x: Tensor, mask_features: Tensor,
                return_aux: bool = False):
        """x (B, h, w, C) transformer features; mask_features (B, H/4, W/4,
        mask_dim). Returns (logits (B, Q, K+1), masks (B, Q, H/4, W/4)),
        `Mask2Former`'s contract; with `return_aux` every layer's, stacked
        ((L, B, Q, K+1), (L, B, Q, H/4, W/4)), the last the final one."""
        if self.input_proj is not None:
            x = _nhwc(self.input_proj(_nchw(x)))
        B, h, w, C = x.shape
        pos = position_embedding_sine(h, w, x.device, C)[None]
        memory = x.reshape(B, h * w, C)
        qpos = self.query_embed.weight[None].expand(B, -1, -1)
        tgt = torch.zeros_like(qpos)      # the DETR decoder starts from 0
        dec = self.transformer.decoder

        def predict(state):
            out = dec.norm(state)
            masks = torch.einsum("bqc,bhwc->bqhw", self.mask_embed(out),
                                 mask_features)
            return self.class_embed(out), masks

        aux = []
        for i, layer in enumerate(dec.layers):
            tgt = layer(tgt, memory, qpos, pos)
            if return_aux or i == len(dec.layers) - 1:
                aux.append(predict(tgt))
        if return_aux:
            return (torch.stack([a[0] for a in aux]),
                    torch.stack([a[1] for a in aux]))
        return aux[-1]


class MaskFormerV1(nn.Module):
    """The original MaskFormer (v1): Swin backbone ->
    TransformerEncoderPixelDecoder -> StandardTransformerDecoder, frozen
    and on `device` (default: the GPU, raising if there is none), with
    flax-style random weights from `generator` (`init_weights=False` skips
    the draw for a model loaded next, `convert/jax_params.py:
    load_jax_maskformer_v1`). It shares `Mask2Former`'s preprocessing and
    its (logits, masks) contract, so `semantic_inference`,
    `panoptic_inference`, `semantic_tta` and `instance_inference` apply
    unchanged (`mal_tpu/segment/maskformer_v1.py:213-236`)."""

    def __init__(self, num_classes: int = 80, swin_size: str = "tiny",
                 num_queries: int = 100, bgr_input: bool = True,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 init_weights: bool = True):
        from mal_tpu_torch.segment.mask2former import (init_like_flax,
                                                       register_pixel_stats)
        from mal_tpu_torch.segment.swin import CONFIGS, SwinTransformer

        super().__init__()
        device = resolve_device(device)
        self.swin_size = swin_size
        self.num_classes = num_classes
        self.bgr_input = bgr_input
        embed = CONFIGS[swin_size][0]
        self.backbone = SwinTransformer(swin_size)
        self.sem_seg_head = nn.Module()
        self.sem_seg_head.pixel_decoder = TransformerEncoderPixelDecoder(
            {f"res{s + 2}": embed * 2 ** s for s in range(4)})
        self.sem_seg_head.predictor = StandardTransformerDecoder(
            256, num_classes=num_classes, num_queries=num_queries)
        if init_weights:
            with torch.no_grad():
                init_like_flax(self, generator
                               or torch.Generator().manual_seed(0))
        register_pixel_stats(self)
        self.eval()
        self.requires_grad_(False)   # frozen
        self.to(device)

    def forward(self, images: Tensor, return_aux: bool = False):
        """images (B, H, W, 3) in [0, 1] RGB, H and W multiples of 32.
        Returns (pred_logits (B, Q, K+1), pred_masks (B, Q, H/4, W/4)), or
        with `return_aux` every decoder layer's, stacked."""
        from mal_tpu_torch.segment.mask2former import preprocess_images

        feats = self.backbone(preprocess_images(
            images, self.bgr_input, mean=self.pixel_mean, std=self.pixel_std))
        mask_features, t_feats, _ = self.sem_seg_head.pixel_decoder(feats)
        return self.sem_seg_head.predictor(t_feats, mask_features,
                                           return_aux)


class PerPixelBaselineHead(nn.Module):
    """`per_pixel_baseline.py:17-125`: a pixel decoder (FPN, or with
    `transformer_enc` the "Plus" variant's transformer-encoder one) and a
    1x1 class predictor, bilinearly upsampled x4; `loss` is the training
    cross-entropy with an ignore label."""

    def __init__(self, in_channels: dict[str, int], num_classes: int = 80,
                 transformer_enc: bool = False, conv_dim: int = 256,
                 mask_dim: int = 256):
        super().__init__()
        cls = (TransformerEncoderPixelDecoder if transformer_enc
               else FPNPixelDecoder)
        self.pixel_decoder = cls(in_channels, conv_dim, mask_dim)
        self.predictor = nn.Conv2d(mask_dim, num_classes, 1)

    def forward(self, features: dict[str, Tensor]) -> Tensor:
        """features {"res2".. "res5"} (B, h, w, C) -> logits (B, H, W, K)
        at 4x the res2 map (common_stride 4)."""
        mask_features, _, _ = self.pixel_decoder(features)
        logits = self.predictor(_nchw(mask_features))     # (B, K, h, w)
        h, w = logits.shape[-2:]
        return _nhwc(resize_bilinear(logits, h * 4, w * 4))

    @staticmethod
    def loss(logits: Tensor, targets: Tensor, ignore_value: int = -1,
             loss_weight: float = 1.0) -> Tensor:
        """Mean cross-entropy over the pixels not `ignore_value`
        (`per_pixel_baseline.py:117-124`). logits (B, H, W, K) from the
        forward; targets (B, H, W) integer."""
        valid = targets != ignore_value
        tgt = targets.clamp(0, logits.shape[-1] - 1).long()
        logp = logits.log_softmax(dim=-1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        return loss_weight * (torch.where(valid, nll, 0.0).sum()
                              / valid.sum().clamp(min=1))
