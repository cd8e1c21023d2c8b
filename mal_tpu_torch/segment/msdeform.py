"""Multi-scale deformable attention (PyTorch).

Counterpart of `mal_tpu.segment.msdeform.MSDeformAttn`
(`ops/modules/ms_deform_attn.py` in the reference): sampling locations are
normalised to [0, 1] per level, sampled with zeros padding and
align_corners=False, and weighted by softmax attention weights over
(levels x points). The sampling core is kernel K5
(`ops/cuda/deform_sample.py:ms_deform_attn_core`) on CUDA tensors and its
plain per-level version on CPU tensors. In train mode (`train=True`,
fine-tuning) the core is that plain version on every device, `mal_tpu`'s
`ms_deform_attn_core_per_level` (`mal_tpu/segment/msdeform.py:27`), through
which autograd runs: the kernel has no backward.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mal_tpu_torch.ops.cuda.deform_sample import (
    ms_deform_attn_core, ms_deform_attn_core_per_level)
from mal_tpu_torch.utils import profiling

Tensor = torch.Tensor

# the reference pixel decoder's: width, levels, heads, points per level
D_MODEL, LEVELS, HEADS, POINTS = 256, 3, 8, 4


class MSDeformAttn(nn.Module):
    """`mxu_precision` ("high" or "bf16") is `mal_tpu`'s choice of how many
    bf16 passes the TPU kernel's one-hot interpolation products take
    (`mal_tpu/segment/msdeform.py:143`). K5 gathers in fp32 and has no such
    product, so the option is accepted and changes nothing here: exact in
    both modes."""

    def __init__(self, mxu_precision: str = "high"):
        super().__init__()
        if mxu_precision not in ("high", "bf16"):
            raise ValueError(f"mxu_precision must be 'high' or 'bf16', got "
                             f"{mxu_precision!r}")
        self.mxu_precision = mxu_precision
        samples = HEADS * LEVELS * POINTS
        self.sampling_offsets = nn.Linear(D_MODEL, samples * 2)
        self.attention_weights = nn.Linear(D_MODEL, samples)
        self.value_proj = nn.Linear(D_MODEL, D_MODEL)
        self.output_proj = nn.Linear(D_MODEL, D_MODEL)
        self._sizes: dict = {}   # (spatial shapes, device) -> level sizes

    def level_sizes(self, spatial_shapes: list[tuple[int, int]],
                    device: torch.device) -> Tensor:
        """(L, 2) fp32: each level's (w, h) on `device`, made at the first
        call for these shapes and this device (a copy from a host list,
        which synchronises with the device) and kept for the later ones."""
        key = (tuple(spatial_shapes), device)
        sizes = self._sizes.get(key)
        if sizes is None:
            sizes = torch.tensor([[w, h] for h, w in spatial_shapes],
                                 dtype=torch.float32, device=device)
            profiling.count("host_syncs")
            self._sizes[key] = sizes
        return sizes

    def forward(self, query: Tensor, reference_points: Tensor,
                value_flat: Tensor, spatial_shapes: list[tuple[int, int]],
                train: bool = False) -> Tensor:
        """query (B, Lq, C); reference_points (B, Lq, L, 2) as (x, y) in
        [0, 1]; value_flat (B, sum(HW), C). `train` takes the plain core in
        place of kernel K5."""
        B, Lq, C = query.shape
        H_, L, P = HEADS, LEVELS, POINTS
        value = self.value_proj(value_flat).reshape(B, -1, H_, C // H_)
        offsets = self.sampling_offsets(query).reshape(B, Lq, H_, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Lq, H_, L * P)
        attn = attn.softmax(dim=-1).reshape(B, Lq, H_, L, P)
        # offsets are in pixels of each level: normalise by its (w, h)
        sizes = self.level_sizes(spatial_shapes, query.device)
        locs = (reference_points[:, :, None, :, None, :]
                + offsets / sizes[None, None, None, :, None, :])
        core = ms_deform_attn_core_per_level if train else ms_deform_attn_core
        out = core(value, spatial_shapes, locs.contiguous(), attn.contiguous())
        return self.output_proj(out)
