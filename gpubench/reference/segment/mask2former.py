"""Mask2Former and its instance inference (PyTorch).

Counterpart of `mal_tpu.segment.mask2former` (reference
`mask2former/maskformer_model.py:21-380`): the frozen instance segmenter of
the MAL temporal hint (`manydepth/trainer.py:350-357`); the port's train
mode, for fine-tuning, is not copied. The module tree
has detectron2's names (`backbone`, `sem_seg_head.pixel_decoder`,
`sem_seg_head.predictor`), so its state dict has the keys of the published
checkpoints.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gpubench.reference.device import resolve_device
from gpubench.reference.ops.interp import resize_bilinear
from gpubench.reference.segment.instances import Instances
from gpubench.reference.segment.pixel_decoder import MSDeformAttnPixelDecoder
from gpubench.reference.segment.swin import CONFIGS, SwinTransformer
from gpubench.reference.segment.transformer_decoder import \
    MaskedTransformerDecoder

Tensor = torch.Tensor

# detectron2 COCO normalisation (cfg MODEL.PIXEL_MEAN / PIXEL_STD), applied
# to [0, 255] inputs
_PIXEL_MEAN = (123.675, 116.28, 103.53)
_PIXEL_STD = (58.395, 57.12, 57.375)


def preprocess_images(images: Tensor, bgr_input: bool = True) -> Tensor:
    """The reference's segmenter preprocessing of (B, H, W, 3) RGB frames in
    [0, 1]: it feeds Mask2Former **BGR** frames (`manydepth/dyn_utils.py:
    176-178`) that detectron2 then normalises with RGB-ordered means
    (`maskformer_model.py:193-195`). The mismatch is the released models'
    behaviour and is kept by default; `bgr_input=False` is the
    colour-correct form fine-tuning uses (`mal_tpu/cli.py:436-437`)."""
    if bgr_input:
        images = images.flip(-1)
    mean = torch.tensor(_PIXEL_MEAN, device=images.device)
    std = torch.tensor(_PIXEL_STD, device=images.device)
    return (images * 255.0 - mean) / std


class Mask2Former(nn.Module):
    """The segmenter on `device` (default: the GPU, raising if there is
    none), with torch's default initialisation: the benchmark sets every
    weight from the seed next (`traffic.fill_weights`).

    `bf16_backbone` (fast mode) runs the Swin blocks' and the pixel
    decoder's FFN Linears in bf16; `fused_swin` runs every Swin block as
    K2 and K3's plain versions. Neither changes the parameters or the
    state-dict keys.
    `bgr_input` as `preprocess_images`.

    The model is built frozen (no parameter requires a gradient), as the
    temporal hint uses it."""

    def __init__(self, num_classes: int = 80, swin_size: str = "large",
                 num_queries: int = 100,
                 device: str | torch.device | None = None,
                 bf16_backbone: bool = False, fused_swin: bool = False,
                 bgr_input: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.swin_size = swin_size
        self.num_classes = num_classes
        self.bgr_input = bgr_input
        embed = CONFIGS[swin_size][0]
        self.backbone = SwinTransformer(swin_size, bf16_compute=bf16_backbone,
                                        fused_block=fused_swin)
        self.sem_seg_head = nn.Module()
        self.sem_seg_head.pixel_decoder = MSDeformAttnPixelDecoder(
            {f"res{s + 2}": embed * 2 ** s for s in range(4)},
            bf16_compute=bf16_backbone)
        self.sem_seg_head.predictor = MaskedTransformerDecoder(
            num_classes=num_classes, num_queries=num_queries)
        self.eval()
        self.requires_grad_(False)   # frozen
        self.to(device)

    def forward(self, images: Tensor) -> tuple[Tensor, Tensor]:
        """images (B, H, W, 3) in [0, 1] RGB. Returns (pred_logits (B, Q,
        K+1), pred_masks (B, Q, H/4, W/4))."""
        feats = self.backbone(preprocess_images(images, self.bgr_input))
        mask_features, multi_scale = self.sem_seg_head.pixel_decoder(feats)
        return self.sem_seg_head.predictor(multi_scale, mask_features)


def instance_inference(pred_logits: Tensor, pred_masks: Tensor, out_h: int,
                       out_w: int, max_instances: int) -> Instances:
    """Top-k padded instances (`maskformer_model.py:344-380`): class-softmax
    scores without the background, a fixed top-`max_instances` over
    (queries x classes), mask logits upsampled and thresholded at 0, and
    the score times the mean in-mask probability."""
    B, Q, K1 = pred_logits.shape
    K = K1 - 1
    scores = pred_logits.softmax(dim=-1)[..., :K].reshape(B, Q * K)
    top_scores, top_idx = scores.topk(max_instances, dim=1)
    top_q = top_idx // K
    top_class = top_idx % K
    h, w = pred_masks.shape[-2:]
    masks = pred_masks.gather(1, top_q[:, :, None, None].expand(-1, -1, h, w))
    masks_up = resize_bilinear(masks, out_h, out_w)
    binary = (masks_up > 0.0).to(torch.float32)
    prob = masks_up.sigmoid()
    mask_score = ((prob * binary).sum(dim=(2, 3))
                  / (binary.sum(dim=(2, 3)) + 1e-6))
    final = top_scores * mask_score
    return Instances(masks=binary, classes=top_class.to(torch.int32),
                     scores=final, valid=torch.ones_like(final, dtype=torch.bool))


def make_seg_fn(model: Mask2Former, max_instances: int):
    """`seg_fn(images (B, H, W, 3)) -> Instances`, the temporal hint's
    segmenter: the frozen model under `torch.no_grad()` on detached frames
    (the reference runs Mask2Former under no_grad, `dyn_utils.py:185-186`)."""

    def seg_fn(images: Tensor) -> Instances:
        H, W = images.shape[1:3]
        with torch.no_grad():
            logits, masks = model(images.detach())
            return instance_inference(logits, masks, H, W, max_instances)

    return seg_fn
