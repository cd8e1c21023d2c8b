"""Segmenter fine-tuning: COCO-style targets to padded tensors, and the
training step (PyTorch).

Counterpart of `mal_tpu.segment.finetune`. The reference trains Mask2Former
through detectron2's dataset registry and `MaskFormerInstanceDatasetMapper`
(annotation dicts with RLE or binary-mask segmentations, ragged per image);
here a host-side mapper decodes COCO segmentations into the static
(labels, masks, valid) layout of `segment/criterion.py`.

- `rle_decode`, `category_index`, `coco_to_targets`: numpy, copied from
  `mal_tpu` (uncompressed COCO RLE, column-major runs; sparse COCO ids to
  contiguous indices; padding or truncation to `max_instances`).
- `collate_targets`: per-image targets stacked into tensors on a device.
- `make_seg_finetune_step`: `mask2former_train_loss`, its backward and one
  optimizer update; `make_optimizer` is `optax.adamw(lr, weight_decay=wd)`
  as `torch.optim.AdamW` computes it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from mal_tpu_torch.segment.criterion import CriterionConfig
from mal_tpu_torch.segment.mask2former import (Mask2Former,
                                               mask2former_train_loss)

Tensor = torch.Tensor


def rle_decode(counts: Sequence[int], size: Sequence[int]) -> np.ndarray:
    """Uncompressed COCO RLE -> (H, W) uint8 mask.

    COCO runs are COLUMN-major (Fortran order) and start with a
    background run (possibly 0)."""
    h, w = int(size[0]), int(size[1])
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in counts:
        run = int(run)
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    assert pos == h * w, f"RLE covers {pos} px, expected {h * w}"
    return flat.reshape((w, h)).T  # column-major


def category_index(category_ids: Sequence[int]) -> dict[int, int]:
    """Sparse COCO category ids -> contiguous [0, K) indices (the
    detectron2 `thing_dataset_id_to_contiguous_id` mapping)."""
    return {int(c): i for i, c in enumerate(sorted(set(map(int,
                                                           category_ids))))}


def coco_to_targets(annotations: Sequence[dict], height: int, width: int,
                    max_instances: int,
                    cat_index: dict[int, int] | None = None):
    """One image's COCO-style annotation list -> padded static targets.

    Each annotation: {"category_id": int, "segmentation": (H, W) binary
    array OR uncompressed-RLE dict}. Returns (labels (T,) int32,
    masks (T, H, W) float32, valid (T,) bool), truncated to
    `max_instances` in list order like detectron2's sampling cap.
    """
    T = max_instances
    labels = np.zeros((T,), np.int32)
    masks = np.zeros((T, height, width), np.float32)
    valid = np.zeros((T,), bool)
    for i, ann in enumerate(annotations[:T]):
        seg = ann["segmentation"]
        if isinstance(seg, dict):
            m = rle_decode(seg["counts"], seg["size"])
        else:
            m = np.asarray(seg)
        assert m.shape == (height, width), (m.shape, (height, width))
        cid = int(ann["category_id"])
        labels[i] = cat_index[cid] if cat_index is not None else cid
        masks[i] = m.astype(np.float32)
        valid[i] = True
    return labels, masks, valid


def collate_targets(per_image: Sequence[tuple],
                    device: str | torch.device = "cpu"):
    """Per-image (labels, masks, valid) triples stacked into (B, T),
    (B, T, H, W) and (B, T) tensors on `device`."""
    return tuple(torch.from_numpy(np.stack([t[i] for t in per_image])).to(
        device) for i in range(3))


def make_optimizer(model: torch.nn.Module, lr: float,
                   weight_decay: float) -> torch.optim.AdamW:
    """`optax.adamw(lr, weight_decay=wd)` (`mal_tpu/cli.py:446`): b1 0.9,
    b2 0.999, eps 1e-8, the decay on every parameter, decoupled from the
    moments and scaled by the learning rate."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def make_seg_finetune_step(model: Mask2Former,
                           optimizer: torch.optim.Optimizer,
                           criterion_cfg: CriterionConfig | None = None
                           ) -> Callable:
    """`step(images, labels, masks, valid, generator=None, draws=None) ->
    metrics`: one fine-tuning update of `model` (trainable) in place, the
    training path of `maskformer_model.py:198-216` with the optimizer.
    Returns {"loss", "loss_ce", "loss_mask", "loss_dice"} as detached
    tensors, and the matching's host ms as floats ("match_copy_ms",
    "match_solve_ms", `criterion.match_predictions`)."""

    def step(images: Tensor, labels: Tensor, masks: Tensor, valid: Tensor,
             generator: torch.Generator | None = None,
             draws: list[dict] | None = None) -> dict[str, Tensor]:
        optimizer.zero_grad(set_to_none=True)
        timings = {}
        loss, losses = mask2former_train_loss(
            model, images, labels, masks, valid, criterion_cfg=criterion_cfg,
            generator=generator, draws=draws, timings=timings)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "loss_ce": losses["loss_ce"].detach(),
                "loss_mask": losses["loss_mask"].detach(),
                "loss_dice": losses["loss_dice"].detach(), **timings}

    return step
