"""What the CUDA kernels' wrappers decide from shapes alone, and what the
kernels assume of their inputs, checked on the CPU."""

import importlib.util
from pathlib import Path

import pytest
import torch

from mal_tpu_torch.ops.cuda import cost_volume_kernel as k1
from mal_tpu_torch.ops.cuda import deform_sample as k5
from mal_tpu_torch.ops.cuda import window_attention as k4
from mal_tpu_torch.segment.swin import shift_mask


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


# (padded map, window): the maps of Swin-L's two shifted stages at 192x640
# and 320x1024, and of Swin-T's four (every one shifted) at MaskFormer v1's
# 256x448
@pytest.mark.parametrize("Hp,Wp,ws", [
    pytest.param(48, 168, 12, id="48-168"), pytest.param(24, 84, 12, id="24-84"),
    pytest.param(84, 264, 12, id="84-264"),
    pytest.param(48, 132, 12, id="48-132"), (70, 112, 7), (35, 56, 7),
    (21, 28, 7), (14, 14, 7)])
def test_shift_mask_holds_one_nonzero_value(Hp, Wp, ws):
    """K4's tiled and w7 kernels keep the mask as bits (mask != 0) and the
    mask's non-zero value, which is exact only for a mask of 0 and one
    value."""
    mask = shift_mask(Hp, Wp, ws, ws // 2)
    assert set(torch.unique(mask).tolist()) == {-100.0, 0.0}


# the window sizes of Swin-T (7) and Swin-L (12), two the loop kernel takes,
# and one above what any route takes
@pytest.mark.parametrize("ws,route", [(7, "w7"), (12, "tiled"), (8, "loop"),
                                      (16, "loop"), (17, None)])
def test_k4_window_attention_route(ws, route):
    if route is None:
        with pytest.raises(ValueError, match="window 17"):
            k4.window_attention_route(ws)
    else:
        assert k4.window_attention_route(ws) == route


# (tokens, channels, channels a staged block of K5b takes): the pixel
# decoder's three levels at 192x640 (chip_smoke.py's K5b phase), channels
# that are no multiple of 8, the most tokens whose 8-channel slice fits in
# a block's 227 KB, and one more
@pytest.mark.parametrize("tokens,ch,plan", [
    (2520, 32, 8), (2520, 12, None), (7264, 32, 8), (7265, 32, None)])
def test_k5b_major_staged_channels(tokens, ch, plan):
    assert k5.major_staged_channels(tokens, ch) == plan


# chip_smoke.py's K1 phase (BF=12, D=96, 48x160x64) and K6 phase (BF=14,
# 48x128x64): tiles by route (ROUTES: empty, staged, direct). The kernel
# counts its own on the card and chip_smoke.py holds them to this mirror.
@pytest.mark.parametrize("inputs,occ,routes", [
    ({}, False, {"empty": 6040, "staged": 26295, "direct": 2225}),
    ({"BF": 14, "w": 128, "seed": 1}, True,
     {"empty": 5430, "staged": 24817, "direct": 2009})])
def test_k1_k6_routes_at_the_main_path_shapes(inputs, occ, routes):
    cur, _, M, t, bins = _chip_smoke().k1_inputs(device="cpu", **inputs)
    _, h, w, C = cur.shape
    assert k1.plane_sweep_routes(M, t, bins, h, w, C, occ=occ) == routes
