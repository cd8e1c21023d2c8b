"""Online dynamic-object (doj) masks from the frozen Mask2Former.

Counterpart of `mal_tpu.segment.doj`. The reference reads precomputed
per-frame dynamic-object masks from `.npy` files
(`dynamicdepth/datasets/kitti_dataset.py:96-117`); with `Config.online_doj`
(DynamicDepth) the frozen segmenter of the temporal hint makes them inside
the training step instead: the union of the instance masks whose class is
a movable street-object category and whose score clears the threshold, one
segmenter forward per frame.
"""

from __future__ import annotations

from typing import Callable

import torch

from mal_tpu_torch.segment.instances import Instances
from mal_tpu_torch.segment.mask2former import Mask2Former, make_seg_fn

Tensor = torch.Tensor

# COCO "thing" categories that move in street scenes: person, bicycle, car,
# motorcycle, bus, train, truck (indices in the 80-class contiguous order)
DYNAMIC_COCO_CLASSES = (0, 1, 2, 3, 5, 6, 7)


def doj_from_instances(inst: Instances,
                       dynamic_classes=DYNAMIC_COCO_CLASSES,
                       score_threshold: float = 0.5) -> Tensor:
    """The union of the valid dynamic-class instance masks scoring above
    `score_threshold` -> (B, H, W) float in {0, 1}."""
    dyn = torch.tensor(dynamic_classes, dtype=torch.int32,
                       device=inst.classes.device)
    is_dyn = (inst.classes[..., None] == dyn).any(-1)              # (B, N)
    keep = is_dyn & (inst.scores > score_threshold) & inst.valid
    union = (inst.masks * keep[..., None, None].to(inst.masks.dtype)).sum(1)
    return union.clamp(0.0, 1.0)


def make_doj_fn(model: Mask2Former, max_instances: int,
                score_threshold: float = 0.5,
                dynamic_classes=DYNAMIC_COCO_CLASSES
                ) -> Callable[[Tensor], Tensor]:
    """`doj_fn(images (B, H, W, 3) in [0, 1]) -> (B, H, W)` masks, without
    gradient, from the frozen segmenter (`make_seg_fn`: mask logits
    thresholded at 0, as `mal_tpu` builds it)."""
    seg_fn = make_seg_fn(model, max_instances)

    def doj_fn(images: Tensor) -> Tensor:
        with torch.no_grad():
            return doj_from_instances(seg_fn(images), dynamic_classes,
                                      score_threshold)

    return doj_fn
