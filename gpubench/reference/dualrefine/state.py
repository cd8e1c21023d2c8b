"""DualRefine's depth-bin tracker, frozen from the port's
`mal_tpu_torch/train/state.py`: the ManyDepth reference's EMA over the
batch's min / max depth with DualRefine's mean and median EMAs
(`dualrefine/trainer.py:82-83,357-372`), which its step tracks. One
process on the global batch: the batch means are plain means."""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class DepthBinTracker:
    min_depth: Tensor     # ()
    max_depth: Tensor     # ()
    updated: Tensor       # () bool
    mean_depth: Tensor    # (), starts at 1
    median_depth: Tensor  # (), starts at 1

    @classmethod
    def create(cls, min_depth: float = 0.1, max_depth: float = 10.0,
               device=None) -> "DepthBinTracker":
        def scalar(v: float) -> Tensor:
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(scalar(min_depth), scalar(max_depth),
                   torch.zeros((), dtype=torch.bool, device=device),
                   scalar(1.0), scalar(1.0))

    def update(self, mono_depth: Tensor, opt_min_depth: float,
               ema: float = 0.99) -> "DepthBinTracker":
        """mono_depth: (B, 1, H, W) depth of the global batch. The mean
        and median EMAs with the reference's quirks
        (`dualrefine/trainer.py:357-363`): the mean reduces batch element 0
        only, the median is the batch mean of each image's median of its
        row medians, torch's lower median for even lengths."""
        per_img_min = mono_depth.amin(dim=(1, 2, 3))
        per_img_max = mono_depth.amax(dim=(1, 2, 3))
        mn = (per_img_min.mean() * 0.9).clamp(min=opt_min_depth)
        mx = per_img_max.mean() * 1.1
        d = mono_depth[:, 0]                                      # (B, H, W)
        row_med = d.median(dim=-1).values                         # (B, H)
        new_median = row_med.median(dim=-1).values.mean()
        mean_d = self.mean_depth * ema + d[0].mean() * (1.0 - ema)
        median_d = self.median_depth * ema + new_median * (1.0 - ema)
        return DepthBinTracker(self.min_depth * ema + mn * (1.0 - ema),
                               self.max_depth * ema + mx * (1.0 - ema),
                               torch.ones_like(self.updated), mean_d, median_d)
