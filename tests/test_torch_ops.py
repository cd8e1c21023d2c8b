"""`mal_tpu_torch.ops.interp` and `ops.ssim` against `mal_tpu`'s, on the CPU.

The port is channels-first, `mal_tpu` channels-last: inputs are made once
from a numpy seed and transposed. Tolerance: 1e-5 absolute on values in
[0, 1] (float32 bilinear weights rounded in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.ops import interp as ji
from mal_tpu.ops.ssim import ssim as jssim
from mal_tpu_torch.ops import interp as ti
from mal_tpu_torch.ops.ssim import ssim as tssim

from test_torch_common import nchw
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)


def _image(B=2, H=12, W=20, C=3, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, (B, H, W, C)).astype(np.float32)


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample(padding_mode):
    img = _image()
    rng = np.random.RandomState(1)
    # mostly inside, some outside [-1, 1], a few exactly on pixel centres
    grid = rng.uniform(-1.3, 1.3, (2, 7, 9, 2)).astype(np.float32)
    grid[0, 0, :3] = [[-1.0, -1.0], [1.0, 1.0], [0.0, 0.0]]
    got = ti.grid_sample(torch.from_numpy(nchw(img)), torch.from_numpy(grid),
                         padding_mode)
    want = ji.grid_sample(jnp.asarray(img), jnp.asarray(grid), padding_mode,
                          True)
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), atol=1e-5)


def test_grid_sample_without_align_corners():
    """Zeros padding with align_corners=False, as deformable attention
    samples its levels."""
    img = _image(seed=2)
    grid = np.random.RandomState(3).uniform(
        -1.3, 1.3, (2, 7, 9, 2)).astype(np.float32)
    got = ti.grid_sample(torch.from_numpy(nchw(img)), torch.from_numpy(grid),
                         "zeros", align_corners=False)
    want = ji.grid_sample(jnp.asarray(img), jnp.asarray(grid), "zeros", False)
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("size", [(12, 20), (5, 7), (30, 44), (6, 41)])
def test_resize_bilinear(size):
    img = _image(seed=4)
    got = ti.resize_bilinear(torch.from_numpy(nchw(img)), *size)
    want = ji.resize_bilinear(jnp.asarray(img), *size)
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), atol=1e-6)


def test_grid_sample_rejects_unknown_padding():
    with pytest.raises(ValueError):
        ti.grid_sample(torch.zeros(1, 1, 2, 2), torch.zeros(1, 1, 1, 2),
                       "reflection")


@pytest.mark.parametrize("size", [(3, 5), (48, 80), (12, 20)])
def test_resize_nearest(size):
    img = _image()
    got = ti.resize_nearest(torch.from_numpy(nchw(img)), *size)
    want = ji.resize_nearest(jnp.asarray(img), *size)
    np.testing.assert_array_equal(_to_nhwc(got), np.asarray(want))


def test_upsample2x_nearest():
    img = _image()
    got = ti.upsample2x_nearest(torch.from_numpy(nchw(img)))
    np.testing.assert_array_equal(_to_nhwc(got),
                                  np.asarray(ji.upsample2x_nearest(jnp.asarray(img))))


@pytest.mark.parametrize("same", [False, True])
def test_ssim(same):
    x = _image(seed=2)
    y = x if same else _image(seed=3)
    got = tssim(torch.from_numpy(nchw(x)), torch.from_numpy(nchw(y)))
    want = jssim(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), atol=1e-5)
