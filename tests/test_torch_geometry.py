"""`mal_tpu_torch.geometry` against `mal_tpu.geometry`, on the CPU.

Inputs come from a numpy seed. Tolerance: 1e-5 relative / 1e-5 absolute in
float32 (matrix products and divisions rounded in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu import geometry as jg
from mal_tpu_torch import geometry as tg

from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

RTOL = ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol)


def _pose_inputs(seed=0, B=3):
    rng = np.random.RandomState(seed)
    aa = rng.uniform(-0.2, 0.2, (B, 3)).astype(np.float32)
    aa[0] = 0.0  # the 1e-7 angle guard
    t = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    return aa, t


def test_disp_to_depth():
    disp = np.random.RandomState(1).uniform(0, 1, (2, 1, 8, 8)).astype(np.float32)
    for got, want in zip(tg.disp_to_depth(torch.from_numpy(disp), 0.1, 100.0),
                         jg.disp_to_depth(jnp.asarray(disp), 0.1, 100.0)):
        _close(got, want)


def test_rot_from_axisangle():
    aa, _ = _pose_inputs()
    _close(tg.rot_from_axisangle(torch.from_numpy(aa)),
           jg.rot_from_axisangle(jnp.asarray(aa)))


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(invert):
    aa, t = _pose_inputs()
    _close(tg.transformation_from_parameters(torch.from_numpy(aa),
                                             torch.from_numpy(t), invert),
           jg.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t),
                                             invert))


def test_pixel_grid_and_scale_intrinsics():
    _close(tg.pixel_grid(5, 7), jg.pixel_grid(5, 7))
    K = np.random.RandomState(2).uniform(1, 100, (2, 4, 4)).astype(np.float32)
    _close(tg.scale_intrinsics(torch.from_numpy(K), 2),
           jg.scale_intrinsics(jnp.asarray(K), 2))


def _camera(B=2, H=12, W=20, seed=3):
    rng = np.random.RandomState(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    K = np.broadcast_to(K, (B, 4, 4)).copy()
    depth = rng.uniform(0.5, 20.0, (B, H, W)).astype(np.float32)
    aa, t = _pose_inputs(seed, B)
    T = np.array(jg.transformation_from_parameters(jnp.asarray(aa),
                                                   jnp.asarray(t)))
    return K, np.linalg.inv(K).astype(np.float32), depth, T


def test_backproject():
    K, inv_K, depth, _ = _camera()
    B, H, W = depth.shape
    _close(tg.backproject(torch.from_numpy(depth), torch.from_numpy(inv_K), H, W),
           jg.backproject(jnp.asarray(depth), jnp.asarray(inv_K), H, W))


@pytest.mark.parametrize("near_plane", [False, True])
def test_project_3d(near_plane):
    """Including points on the camera plane (the `_safe_denom` guard) and
    far outside the image (the +-10 grid clip)."""
    K, inv_K, depth, T = _camera()
    B, H, W = depth.shape
    points = np.array(jg.backproject(jnp.asarray(depth), jnp.asarray(inv_K),
                                     H, W))
    if near_plane:
        points[:, 2, :7] = 0.0
        points[:, 2, 7:14] = -3e-7
        T = np.broadcast_to(np.eye(4, dtype=np.float32), T.shape).copy()
    got = tg.project_3d(torch.from_numpy(points), torch.from_numpy(K),
                        torch.from_numpy(T), H, W)
    want = jg.project_3d(jnp.asarray(points), jnp.asarray(K), jnp.asarray(T),
                         H, W)
    assert got.shape == (B, H, W, 2)
    _close(got, want, atol=1e-4)  # coordinates up to 10 in grid units
    if near_plane:
        assert float(got.abs().max()) == 10.0
