"""Multi-scale deformable attention (PyTorch).

Counterpart of `mal_tpu.segment.msdeform.MSDeformAttn`
(`ops/modules/ms_deform_attn.py` in the reference): sampling locations are
normalised to [0, 1] per level, sampled with zeros padding and
align_corners=False, and weighted by softmax attention weights over
(levels x points). The sampling core is kernel K5
(`ops/cuda/deform_sample.py:ms_deform_attn_core`) in the port, its plain
version here (`ops/kernels.py`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gpubench.reference.ops.kernels import ms_deform_attn_core

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

    def forward(self, query: Tensor, reference_points: Tensor,
                value_flat: Tensor, spatial_shapes: list[tuple[int, int]]
                ) -> Tensor:
        """query (B, Lq, C); reference_points (B, Lq, L, 2) as (x, y) in
        [0, 1]; value_flat (B, sum(HW), C)."""
        B, Lq, C = query.shape
        H_, L, P = HEADS, LEVELS, POINTS
        value = self.value_proj(value_flat).reshape(B, -1, H_, C // H_)
        offsets = self.sampling_offsets(query).reshape(B, Lq, H_, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Lq, H_, L * P)
        attn = attn.softmax(dim=-1).reshape(B, Lq, H_, L, P)
        # offsets are in pixels of each level: normalise by its (w, h)
        sizes = torch.tensor([[w, h] for h, w in spatial_shapes],
                             dtype=torch.float32, device=query.device)
        locs = (reference_points[:, :, None, :, None, :]
                + offsets / sizes[None, None, None, :, None, :])
        out = ms_deform_attn_core(value, spatial_shapes, locs.contiguous(),
                                  attn.contiguous())
        return self.output_proj(out)
