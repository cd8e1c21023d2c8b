"""What the CUDA kernels' wrappers decide from shapes alone, and what the
kernels assume of their inputs, checked on the CPU."""

import pytest
import torch

from mal_tpu_torch.ops.cuda import deform_sample as k5
from mal_tpu_torch.segment.swin import shift_mask


# (tokens, channels, points, channels a staged block takes): the pixel
# decoder at 192x640 (res5 + res4 + res3 = 2520 tokens, 4 points), at
# 320x1024 (6720), the most tokens that fit at 8 channels, one more, a
# larger slice, channels that are no multiple of 8, and more points than
# the staged kernel takes (the last five: the gather kernel)
@pytest.mark.parametrize("tokens,ch,points,plan", [
    (2520, 32, 4, 8), (6720, 32, 4, 8), (7264, 32, 4, 8), (7265, 32, 4, None),
    (16384, 8, 4, None), (2520, 6, 4, None), (2520, 32, 8, None)])
def test_k5_staged_channels(tokens, ch, points, plan):
    assert k5.staged_channels(tokens, ch, points) == plan


# the padded maps of Swin-L's two shifted stages at 192x640 and 320x1024
@pytest.mark.parametrize("Hp,Wp", [(48, 168), (24, 84), (84, 264), (48, 132)])
def test_shift_mask_holds_one_nonzero_value(Hp, Wp):
    """K4's tiled kernel keeps the mask as bits (mask != 0) and the mask's
    non-zero value, which is exact only for a mask of 0 and one value."""
    mask = shift_mask(Hp, Wp, 12, 6)
    assert set(torch.unique(mask).tolist()) == {-100.0, 0.0}
