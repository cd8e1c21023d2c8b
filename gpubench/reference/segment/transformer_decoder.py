"""Masked transformer decoder of Mask2Former, eval mode (PyTorch).

Counterpart of `mal_tpu.segment.transformer_decoder` (reference
`mask2former/modeling/transformer_decoder/
mask2former_transformer_decoder.py:363-447`): learned queries, layers
cycling over the three pixel-decoder scales with *masked* cross-attention
(the attention mask comes from the previous prediction: sigmoid < 0.5
masked, additive -1e4, a query that masks everything unmasked),
self-attention, FFN, and the shared class and mask-embed heads. Names are
detectron2's; LayerNorms use flax's eps of 1e-6.

Each layer's attention mask comes from the mask features resized to its
level, as in `mal_tpu` (`:103-135`). The eval forward computes only the
last prediction's full-resolution masks (the port's deep supervision,
for fine-tuning, is not copied).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench.reference.ops.interp import resize_bilinear
from gpubench.reference.segment.msdeform import D_MODEL
from gpubench.reference.segment.pixel_decoder import position_embedding_sine

Tensor = torch.Tensor

LN_EPS = 1e-6
# the reference's decoder; its width is the pixel decoder's
HIDDEN, LAYERS, HEADS, FFN, MLP_LAYERS = D_MODEL, 9, 8, 2048, 3


class MultiheadAttention(nn.Module):
    """torch's packed projections (`in_proj_weight`, `out_proj`), computed
    as `mal_tpu` does: scores q k^T / sqrt(d), plus an additive mask."""

    def __init__(self, dim: int = HIDDEN, heads: int = HEADS):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q: Tensor, k: Tensor, v: Tensor,
                mask: Tensor | None = None) -> Tensor:
        """q (B, Nq, C); k, v (B, Nk, C); mask (B, Nq, Nk) additive or None."""
        B, Nq, C = q.shape
        h, d = self.heads, C // self.heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qh = F.linear(q, wq, bq).reshape(B, Nq, h, d)
        kh = F.linear(k, wk, bk).reshape(B, -1, h, d)
        vh = F.linear(v, wv, bv).reshape(B, -1, h, d)
        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / d ** 0.5
        if mask is not None:
            attn = attn + mask[:, None]
        attn = attn.softmax(dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(B, Nq, C)
        return self.out_proj(out)


class MLP(nn.Module):
    """The mask-embed head: `layers` Linear layers (`hidden` wide, the
    last `out`), ReLU between them."""

    def __init__(self, hidden: int = HIDDEN, out: int = HIDDEN,
                 layers: int = MLP_LAYERS):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Linear(hidden, hidden) for _ in range(layers - 1)]
            + [nn.Linear(hidden, out)])

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class _AttnLayer(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.add_module(name, MultiheadAttention())
        self.norm = nn.LayerNorm(HIDDEN, eps=LN_EPS)


class _FFNLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear1 = nn.Linear(HIDDEN, FFN)
        self.linear2 = nn.Linear(FFN, HIDDEN)
        self.norm = nn.LayerNorm(HIDDEN, eps=LN_EPS)


class MaskedTransformerDecoder(nn.Module):
    def __init__(self, num_classes: int = 80, num_queries: int = 100):
        super().__init__()
        self.query_feat = nn.Embedding(num_queries, HIDDEN)
        self.query_embed = nn.Embedding(num_queries, HIDDEN)
        self.level_embed = nn.Embedding(3, HIDDEN)
        self.transformer_cross_attention_layers = nn.ModuleList(
            [_AttnLayer("multihead_attn") for _ in range(LAYERS)])
        self.transformer_self_attention_layers = nn.ModuleList(
            [_AttnLayer("self_attn") for _ in range(LAYERS)])
        self.transformer_ffn_layers = nn.ModuleList(
            [_FFNLayer() for _ in range(LAYERS)])
        self.decoder_norm = nn.LayerNorm(HIDDEN, eps=LN_EPS)
        self.class_embed = nn.Linear(HIDDEN, num_classes + 1)
        self.mask_embed = MLP()

    def forward(self, multi_scale: list[Tensor], mask_features: Tensor):
        """multi_scale [res5', res4', res3'], each (B, h, w, C);
        mask_features (B, H/4, W/4, 256). Returns (pred_logits
        (B, Q, K+1), pred_masks (B, Q, H/4, W/4))."""
        B, C = mask_features.shape[0], HIDDEN
        dev = mask_features.device
        srcs, poss, shapes = [], [], []
        for i, f in enumerate(multi_scale):
            _, h, w, _ = f.shape
            srcs.append(f.reshape(B, h * w, C) + self.level_embed.weight[i])
            poss.append(position_embedding_sine(h, w, device=dev))
            shapes.append((h, w))

        output = self.query_feat.weight[None].expand(B, -1, -1)
        qpos = self.query_embed.weight[None].expand(B, -1, -1)

        # bilinear resizing is linear in the pixels, so the attention-mask
        # logits come from the mask features resized to each level
        mf = mask_features.permute(0, 3, 1, 2)
        feats_at = {(h, w): resize_bilinear(mf, h, w)
                    for (h, w) in dict.fromkeys(shapes)}

        def predict(output, h, w):
            dec_out = self.decoder_norm(output)
            mask_embed = self.mask_embed(dec_out)
            m = torch.einsum("bqc,bchw->bqhw", mask_embed, feats_at[(h, w)])
            masked = m.flatten(2).sigmoid() < 0.5
            masked = masked & ~masked.all(dim=-1, keepdim=True)
            attn_mask = torch.where(masked, -1e4, 0.0)
            return self.class_embed(dec_out), mask_embed, attn_mask

        logits, mask_embed, attn_mask = predict(output, *shapes[0])
        layers = zip(self.transformer_cross_attention_layers,
                     self.transformer_self_attention_layers,
                     self.transformer_ffn_layers)
        for l, (xl, sl, fl) in enumerate(layers):
            src, pos = srcs[l % 3], poss[l % 3]
            y = xl.multihead_attn(output + qpos, src + pos, src, attn_mask)
            output = xl.norm(output + y)
            y = sl.self_attn(output + qpos, output + qpos, output)
            output = sl.norm(output + y)
            y = fl.linear2(F.relu(fl.linear1(output)))
            output = fl.norm(output + y)
            logits, mask_embed, attn_mask = predict(output,
                                                    *shapes[(l + 1) % 3])
        masks = torch.einsum("bqc,bhwc->bqhw", mask_embed, mask_features)
        return logits, masks
