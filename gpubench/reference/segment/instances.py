"""Static-shape instance segmentation results.

Counterpart of `mal_tpu.segment.instances`: a fixed `max_instances` slot
layout with validity flags in place of detectron2's variable-length
`Instances` (`manydepth/dyn_utils.py:121-170`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Instances(NamedTuple):
    """Padded per-image instances.

    masks:   (B, N, H, W) float binary masks
    classes: (B, N) int32 class ids (-1 for empty slots)
    scores:  (B, N) float confidence
    valid:   (B, N) bool slot validity
    """
    masks: Tensor
    classes: Tensor
    scores: Tensor
    valid: Tensor

    @classmethod
    def empty(cls, batch: int, n: int, height: int, width: int,
              device=None) -> "Instances":
        return cls(
            masks=torch.zeros((batch, n, height, width), device=device),
            classes=torch.full((batch, n), -1, dtype=torch.int32,
                               device=device),
            scores=torch.zeros((batch, n), device=device),
            valid=torch.zeros((batch, n), dtype=torch.bool, device=device),
        )

    def threshold(self, score_thresh: float) -> "Instances":
        """Drop low-confidence instances (`dyn_utils.py:140`)."""
        keep = self.valid & (self.scores > score_thresh)
        return self._replace(valid=keep,
                             masks=self.masks * keep[..., None, None])
