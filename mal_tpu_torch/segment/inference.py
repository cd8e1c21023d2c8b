"""Semantic and panoptic inference and test-time augmentation for
Mask2Former (PyTorch).

Counterpart of `mal_tpu.segment.inference` (reference `mask2former/
maskformer_model.py:280-342`, semantic_inference and panoptic_inference,
and `mask2former/test_time_augmentation.py:49-105`,
SemanticSegmentorWithTTA). The temporal hint uses only the instance mode
(`segment/mask2former.py:instance_inference`); these complete the
meta-architecture's inference surface.

- `semantic_inference` is one einsum over the batch.
- `panoptic_inference` keeps `mal_tpu`'s fixed shapes (one slot a query
  with a validity bit); its sequential segment-id assignment, a `lax.scan`
  over the queries there, is a loop over the queries here.
- `semantic_tta` runs the model once per (scale, flip), each scale snapped
  to a multiple of 32, and averages the class probabilities at the input's
  size.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from mal_tpu_torch.ops.interp import resize_bilinear

Tensor = torch.Tensor


def semantic_inference(pred_logits: Tensor, pred_masks: Tensor) -> Tensor:
    """Class-probability semantic map (`maskformer_model.py:280-284`).

    pred_logits: (B, Q, K+1); pred_masks: (B, Q, h, w) mask logits.
    Returns (B, K, h, w): softmax class scores (background dropped) times
    mask sigmoids, summed over queries.
    """
    probs = pred_logits.softmax(dim=-1)[..., :-1]
    return torch.einsum("bqk,bqhw->bkhw", probs, pred_masks.sigmoid())


class PanopticSeg(NamedTuple):
    """Fixed-shape panoptic output: the reference's (panoptic_seg,
    segments_info) with one slot per query and a validity bit."""

    seg: Tensor       # (B, h, w) int32, 0 = void, else segment id
    ids: Tensor       # (B, Q) int32 segment id per query (0 = no segment)
    classes: Tensor   # (B, Q) int32 category per query
    isthing: Tensor   # (B, Q) bool
    valid: Tensor     # (B, Q) bool, True where a NEW segment was emitted
                      # (one segments_info entry; a stuff query merged into
                      # an earlier segment paints pixels but stays False,
                      # as the reference's `continue`, maskformer_model.py:327)


def panoptic_inference(pred_logits: Tensor, pred_masks: Tensor,
                       thing_mask: Tensor,
                       object_mask_threshold: float = 0.8,
                       overlap_threshold: float = 0.8) -> PanopticSeg:
    """Fixed-shape panoptic inference (`maskformer_model.py:286-342`).

    pred_logits: (B, Q, K+1); pred_masks: (B, Q, h, w) mask logits;
    thing_mask: (K,) bool, True for "thing" classes.

    - keep = argmax class != background and score > object_mask_threshold;
    - each pixel goes to the kept query maximising score * sigmoid(mask);
    - a query emits a segment iff its assigned-and->=0.5 mask is non-empty
      and covers >= overlap_threshold of its full >=0.5 mask;
    - segment ids count up in query order; a "stuff" query of a class
      already emitted merges into that class's first segment id.
    """
    B, Q, K1 = pred_logits.shape
    probs = pred_logits.softmax(dim=-1)
    scores, labels = probs.max(dim=-1)
    keep = (labels != K1 - 1) & (scores > object_mask_threshold)

    sig = pred_masks.sigmoid()
    prob_masks = torch.where(keep[:, :, None, None],
                             scores[:, :, None, None] * sig, -torch.inf)
    mask_ids = prob_masks.argmax(dim=1)                    # (B, h, w)

    half = sig >= 0.5
    q_ids = torch.arange(Q, device=pred_masks.device)
    assigned = mask_ids[:, None] == q_ids[None, :, None, None]
    seg_mask = assigned & half
    mask_area = assigned.sum(dim=(2, 3))
    original_area = half.sum(dim=(2, 3))
    seg_px = seg_mask.sum(dim=(2, 3))
    emit = (keep & (mask_area > 0) & (original_area > 0) & (seg_px > 0)
            & (mask_area >= overlap_threshold * original_area))

    isthing = thing_mask.to(pred_logits.device)[
        labels.clamp(0, thing_mask.shape[0] - 1)]

    # the sequential id assignment, per image, on the host
    emit_h, labels_h, thing_h = emit.cpu(), labels.cpu(), isthing.cpu()
    ids = torch.zeros((B, Q), dtype=torch.int32)
    new = torch.zeros((B, Q), dtype=torch.bool)
    for b in range(B):
        next_id = 1
        first = [0] * K1
        for q in range(Q):
            lab = int(labels_h[b, q])
            prev = first[lab]
            e = bool(emit_h[b, q])
            merge = e and not bool(thing_h[b, q]) and prev > 0
            is_new = e and not merge
            ids[b, q] = prev if merge else (next_id if is_new else 0)
            if is_new and prev == 0:
                first[lab] = next_id
            next_id += int(is_new)
            new[b, q] = is_new
    dev = pred_logits.device
    ids, new = ids.to(dev), new.to(dev)

    seg = torch.where(seg_mask, ids[:, :, None, None], 0).sum(dim=1)
    return PanopticSeg(seg=seg.to(torch.int32), ids=ids,
                       classes=labels.to(torch.int32), isthing=isthing,
                       valid=new)


def snap32(v: float) -> int:
    """A TTA size: the nearest multiple of 32, at least 32 (Python's
    round, as `mal_tpu`)."""
    return max(32, int(round(v / 32.0)) * 32)


def semantic_tta(apply_fn: Callable[[Tensor], tuple[Tensor, Tensor]],
                 images: Tensor,
                 scales: Sequence[float] = (0.75, 1.0, 1.25),
                 flip: bool = True) -> Tensor:
    """Multi-scale and horizontal-flip TTA over the semantic probabilities
    (`test_time_augmentation.py:71-99` and detectron2's DatasetMapperTTA).

    apply_fn: images (B, H', W', 3) -> (pred_logits, pred_masks), e.g. the
    model under `torch.no_grad()`. Returns the averaged (B, K, H, W)
    semantic probabilities at the input's size.
    """
    B, H, W = images.shape[:3]
    total = None
    count = 0
    for s in scales:
        h, w = snap32(H * s), snap32(W * s)
        scaled = resize_bilinear(images.permute(0, 3, 1, 2), h, w).permute(
            0, 2, 3, 1)
        variants = [scaled] + ([scaled.flip(2)] if flip else [])
        for i, img in enumerate(variants):
            logits, masks = apply_fn(img.contiguous())
            sem = resize_bilinear(semantic_inference(logits, masks), H, W)
            if i == 1:  # un-flip
                sem = sem.flip(-1)
            total = sem if total is None else total + sem
            count += 1
    return total / count
