"""DynamicDepth's occlusion-aware cost volume in the port against `mal_tpu`'s,
on the CPU: the plain version of kernel K6 against the Pallas kernel
`plane_sweep_diffs_occ_pallas` in interpret mode, the whole kernel volume
(`occlusion_aware_cost_volume_kernel`, K6's or K1's plain version on CPU
tensors) against both of `mal_tpu`'s formulations, and the plain twin, with
the `pool` infill, against `mal_tpu`'s twin.

The volume's inputs are those of `tests/test_dynamic_model.py:170-215`: a
small rotation and translation, the second frame of item 1 missing (an
all-zero pose), black patches in the lookup images so that the occlusion
substitution fires, and item 1 augmented (no substitution there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.dynamic.cost_volume import (occlusion_aware_cost_volume as
                                         jax_twin,
                                         occlusion_aware_cost_volume_pallas)
from mal_tpu.ops.pallas.cost_volume_kernel import plane_sweep_diffs_occ_pallas
from mal_tpu_torch.dynamic.cost_volume import (
    occlusion_aware_cost_volume, occlusion_aware_cost_volume_kernel)
from mal_tpu_torch.ops.cost_volume import plane_sweep_terms
from mal_tpu_torch.ops.cuda.cost_volume_kernel import (
    plane_sweep_diffs_occ, plane_sweep_diffs_occ_reference)

from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

B, NF, h, w, C, D = 2, 2, 16, 32, 8, 8
H, W = 4 * h, 4 * w
RTOL = ATOL = 2e-5   # as tests/test_dynamic_model.py holds mal_tpu's twins


@pytest.fixture(scope="module")
def volume_inputs():
    """numpy inputs of both packages' volumes; images NHWC as mal_tpu takes
    them."""
    rng = np.random.RandomState(0)
    cur = rng.uniform(0, 1, (B, h, w, C)).astype(np.float32)
    look = rng.uniform(0, 1, (B, NF, h, w, C)).astype(np.float32)
    pose = np.broadcast_to(np.eye(4, dtype=np.float32), (B, NF, 4, 4)).copy()
    th = 0.02
    pose[:, :, 0, 0] = np.cos(th); pose[:, :, 0, 2] = np.sin(th)
    pose[:, :, 2, 0] = -np.sin(th); pose[:, :, 2, 2] = np.cos(th)
    pose[:, :, 0, 3] = 0.1; pose[:, :, 1, 3] = 0.02
    pose[1, 1] = 0.0
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
    K = np.broadcast_to(K, (B, 4, 4)).copy()
    inv_K = np.asarray(jnp.linalg.inv(jnp.asarray(K)))
    bins = np.asarray(jnp.linspace(0.8, 6.0, D))
    imgs = rng.uniform(0.2, 1.0, (B, NF, H, W, 3)).astype(np.float32)
    imgs[:, :, 20:40, 40:90] = 0.0
    aug = np.asarray([0.0, 1.0], np.float32)
    return cur, look, pose, K, inv_K, bins, imgs, aug


def _both(inputs):
    """(mal_tpu's arguments, the port's): the port takes the images NCHW."""
    jx = [jnp.asarray(a) for a in inputs]
    tc = [torch.from_numpy(np.array(a)) for a in inputs]
    tc[6] = tc[6].permute(0, 1, 4, 2, 3).contiguous()
    return jx, tc


def _assert_volume(got, want, what):
    cost, missing = got
    np.testing.assert_allclose(cost.numpy(), np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL, err_msg=what)
    np.testing.assert_array_equal(missing.numpy() > 0.5,
                                  np.asarray(want[1]) > 0.5, err_msg=what)


@pytest.mark.parametrize("pool_th", [0.15, 0.7])
def test_plain_k6_matches_pallas_kernel(pool_th):
    """K6's plain version against the Pallas kernel in interpret mode, per
    frame, with a black patch in each occlusion mask and the substitution
    on for three of four frames: atol 3e-5 (the kernel's matmul sums the
    corners in another order; as tests/test_pallas_cv.py holds K1). Both
    warped-mask thresholds the repo uses."""
    BF = 4
    rng = np.random.RandomState(1)
    cur = rng.uniform(0, 1, (BF, h, w, C)).astype(np.float32)
    look = rng.uniform(0, 1, (BF, h, w, C)).astype(np.float32)
    occ = np.zeros((BF, h, w), np.float32)
    occ[:, 4:10, 6:20] = 1.0
    occ[1, 10:14, 20:28] = 1.0
    apply_occ = np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (BF, 1, 4, 4)).copy()
    poses[:, 0, :3, 3] = rng.uniform(-0.3, 0.3, (BF, 3))
    M, t = plane_sweep_terms(
        torch.from_numpy(poses), torch.from_numpy(np.broadcast_to(K, (BF, 4, 4)).copy()),
        torch.from_numpy(np.broadcast_to(np.linalg.inv(K), (BF, 4, 4)).copy()))
    M, t = M.reshape(BF, 3, 3).contiguous(), t.reshape(BF, 3).contiguous()
    bins = np.linspace(0.5, 6.0, D).astype(np.float32)

    want = np.asarray(plane_sweep_diffs_occ_pallas(
        jnp.asarray(cur), jnp.asarray(look), jnp.asarray(occ),
        jnp.asarray(apply_occ), jnp.asarray(M.numpy()), jnp.asarray(t.numpy()),
        jnp.asarray(bins), pool_th=pool_th, interpret=True))
    args = [torch.from_numpy(a) for a in (cur, look, occ, apply_occ)]
    got = plane_sweep_diffs_occ_reference(*args, M, t, torch.from_numpy(bins),
                                          pool_th, chunk=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)
    # the substitution did fire, on the applied frames only
    plain = plane_sweep_diffs_occ_reference(
        *args[:3], torch.zeros(BF), M, t, torch.from_numpy(bins), pool_th,
        chunk=4)
    changed = (got != plain).flatten(1).any(1).tolist()
    assert changed == [True, True, False, True]
    # the wrapper takes the plain version for CPU tensors
    before = plane_sweep_diffs_occ.launches
    torch.testing.assert_close(
        plane_sweep_diffs_occ(*args, M, t, torch.from_numpy(bins), pool_th),
        plane_sweep_diffs_occ_reference(*args, M, t, torch.from_numpy(bins),
                                        pool_th, chunk=8), rtol=0, atol=0)
    assert plane_sweep_diffs_occ.launches == before


@pytest.mark.parametrize("cv_min,set_1", [(True, True), (False, False),
                                          (True, False), (False, True)])
def test_kernel_volume_matches_both_mal_tpu_formulations(volume_inputs,
                                                         cv_min, set_1):
    """The port's kernel volume against `mal_tpu`'s XLA twin and its Pallas
    formulation (interpret mode), rtol / atol 2e-5, the missing mask
    exactly; with the ones-init saturation of `cv_min` and the missing ->
    max fill."""
    jx, tc = _both(volume_inputs)
    kw = dict(cv_min=cv_min, set_1=set_1, pool_th=0.7)
    got = occlusion_aware_cost_volume_kernel(*tc, **kw)
    _assert_volume(got, jax_twin(*jx, pool=False, chunk=D, **kw),
                   "against the XLA twin")
    _assert_volume(got, occlusion_aware_cost_volume_pallas(
        *jx, interpret=True, **kw), "against the Pallas formulation")
    if set_1:   # the substitution fired
        plain = occlusion_aware_cost_volume_kernel(*tc, cv_min=cv_min,
                                                   set_1=False)
        assert not torch.equal(got[0], plain[0])


@pytest.mark.parametrize("cv_min,set_1,pool", [
    (True, True, False), (False, False, False), (True, False, True),
    (False, False, True), (True, True, True)])
def test_plain_twin_matches_mal_tpu_twin(volume_inputs, cv_min, set_1, pool):
    """The port's plain twin against `mal_tpu`'s, rtol / atol 2e-5: the
    planes, and the `pool` infill (3-D max-pool with -inf padding
    over (D, h, w) per channel, `F.max_pool3d`) over the whole depth axis,
    also where `set_1` is on too (the pool replaces the substitution)."""
    jx, tc = _both(volume_inputs)
    kw = dict(cv_min=cv_min, set_1=set_1, pool=pool, pool_th=0.7)
    _assert_volume(occlusion_aware_cost_volume(*tc, **kw),
                   jax_twin(*jx, chunk=D, **kw), str(kw))
    if pool:   # the infill changed the volume
        no_pool = occlusion_aware_cost_volume(*tc, **dict(kw, pool=False))
        assert not torch.equal(occlusion_aware_cost_volume(*tc, **kw)[0],
                               no_pool[0])
