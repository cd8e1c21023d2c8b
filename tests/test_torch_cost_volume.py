"""The port's cost volume and the plain version of kernel K1 against
`mal_tpu`, on the CPU.

On the CPU the kernel's wrapper `plane_sweep_diffs` returns its plain
PyTorch version, so `plane_sweep_cost_volume_kernel` here is the plain K1
path. It is held against both of `mal_tpu`'s formulations: the XLA
`plane_sweep_cost_volume` and the Pallas `plane_sweep_cost_volume_pallas`
run in interpret mode, as tests/test_pallas_cv.py runs it, at that test's
atol 3e-5, with rotations 0 and 0.05 and a missing frame. The CUDA kernel
itself is held against the plain version on the card (chip_smoke.py and
tests/test_torch_kernels_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.ops import cost_volume as jcv
from mal_tpu.ops.pallas.cost_volume_kernel import (plane_sweep_cost_volume_pallas,
                                                   plane_sweep_diffs_pallas)
from mal_tpu_torch.ops import cost_volume as tcv
from mal_tpu_torch.ops.cuda import cost_volume_kernel as tk

from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

ATOL = 3e-5


def _inputs(B=2, F=2, h=12, w=20, C=8, seed=0, rot=0.0):
    """tests/test_pallas_cv.py's inputs, with frame (1, 1) missing."""
    rng = np.random.RandomState(seed)
    cur = rng.uniform(0, 1, (B, h, w, C)).astype(np.float32)
    lookup = rng.uniform(0, 1, (B, F, h, w, C)).astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.58 * w, 1.92 * h
    K[0, 2], K[1, 2] = 0.5 * w, 0.5 * h
    K = np.broadcast_to(K, (B, 4, 4)).copy()
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (B, F, 4, 4)).copy()
    poses[:, :, 0, 3] = rng.uniform(-0.3, 0.3, (B, F))
    poses[:, :, 1, 3] = rng.uniform(-0.05, 0.05, (B, F))
    poses[:, :, 2, 3] = rng.uniform(-0.2, 0.2, (B, F))
    if rot:
        c, s = np.cos(rot), np.sin(rot)
        poses[:, :, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                       np.float32)
    poses[1, 1] = 0.0
    return cur, lookup, poses, K, np.linalg.inv(K).astype(np.float32)


@pytest.mark.parametrize("binning", ["linear", "inverse", "log"])
def test_compute_depth_bins(binning):
    got = tcv.compute_depth_bins(torch.tensor(0.37), torch.tensor(9.25), 16,
                                 binning)
    want = jcv.compute_depth_bins(0.37, 9.25, 16, binning)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("rot", [0.0, 0.05])
def test_plain_k1_cost_volume(reference, rot):
    cur, lookup, poses, K, invK = _inputs(rot=rot)
    D = 8
    jbins = jcv.compute_depth_bins(0.5, 10.0, D)
    args = [jnp.asarray(a) for a in (cur, lookup, poses, K, invK)] + [jbins]
    if reference == "xla":
        want_cost, want_missing = jcv.plane_sweep_cost_volume(*args, chunk=4)
    else:
        want_cost, want_missing = plane_sweep_cost_volume_pallas(
            *args, interpret=True)
    before = tk.plane_sweep_diffs.launches
    cost, missing = tk.plane_sweep_cost_volume_kernel(
        *[torch.from_numpy(a) for a in (cur, lookup, poses, K, invK)],
        torch.from_numpy(np.asarray(jbins)))
    assert tk.plane_sweep_diffs.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(cost.numpy(), np.asarray(want_cost), atol=ATOL)
    np.testing.assert_array_equal(missing.numpy(), np.asarray(want_missing))


def test_plain_k1_diffs_match_pallas_interpret():
    """The per-frame differences themselves, in `plane_sweep_diffs_pallas`'s
    (BF, h, w, C) signature."""
    cur, lookup, poses, K, invK = _inputs(rot=0.05)
    B, F, h, w, C = lookup.shape
    M, t = tcv.plane_sweep_terms(*[torch.from_numpy(a)
                                   for a in (poses, K, invK)])
    M, t = M.reshape(B * F, 3, 3), t.reshape(B * F, 3)
    cur_bf = np.repeat(cur, F, axis=0)
    lookup_bf = lookup.reshape(B * F, h, w, C)
    bins = np.asarray(jcv.compute_depth_bins(0.5, 10.0, 16))
    want = plane_sweep_diffs_pallas(jnp.asarray(cur_bf), jnp.asarray(lookup_bf),
                                    jnp.asarray(M.numpy()),
                                    jnp.asarray(t.numpy()), jnp.asarray(bins),
                                    interpret=True)
    got = tk.plane_sweep_diffs(torch.from_numpy(cur_bf),
                               torch.from_numpy(lookup_bf), M, t,
                               torch.from_numpy(bins))
    assert got.shape == (B * F, 16, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_chunk_contract():
    """The plain version sweeps `chunk` planes at a time; D % chunk == 0."""
    cur = torch.zeros(1, 6, 8, 4)
    bins = torch.linspace(1.0, 5.0, 24)
    M, t = torch.eye(3)[None], torch.zeros(1, 3)
    with pytest.raises(ValueError, match="divisible"):
        tk.plane_sweep_diffs_reference(cur, cur, M, t, bins, chunk=16)
    whole = tk.plane_sweep_diffs_reference(cur, cur, M, t, bins, chunk=24)
    assert whole.shape == (1, 24, 6, 8)


def test_kernel_wrapper_rejects_other_devices():
    x = torch.zeros(1, 6, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.plane_sweep_diffs(x, x, torch.zeros(1, 3, 3, device="meta"),
                             torch.zeros(1, 3, device="meta"),
                             torch.zeros(4, device="meta"))


def test_confidence_and_lowest_cost():
    rng = np.random.RandomState(4)
    cost = rng.uniform(0, 1, (2, 8, 5, 6)).astype(np.float32)
    cost[0, 3, 1, 1] = 0.0          # an unobserved bin
    cost[1, :, 2, 2] = 0.0          # a pixel that saw nothing
    missing = (cost == 0).astype(np.float32)
    bins = rng.uniform(0.5, 10, 8).astype(np.float32)
    np.testing.assert_array_equal(
        tcv.confidence_mask_from_cost(torch.from_numpy(cost),
                                      torch.from_numpy(missing)).numpy(),
        np.asarray(jcv.confidence_mask_from_cost(jnp.asarray(cost),
                                                 jnp.asarray(missing))))
    np.testing.assert_allclose(
        tcv.indices_to_disparity(torch.from_numpy(cost),
                                 torch.from_numpy(bins)).numpy(),
        np.asarray(jcv.indices_to_disparity(jnp.asarray(cost),
                                            jnp.asarray(bins))), rtol=1e-7)


@pytest.fixture(scope="module")
def sharded_reference():
    """`mal_tpu`'s volume at `Config()`'s 96 planes on the path it takes
    when the planes are sharded, `chunk=D` (`mal_tpu/models/encoders.py:
    140-145`), with its confidence and lowest-cost disparity."""
    from mal_tpu.config import Config

    D = Config().num_depth_bins
    cur, lookup, poses, K, invK = _inputs(rot=0.05)
    bins = jcv.compute_depth_bins(0.5, 10.0, D)
    cost, missing = jcv.plane_sweep_cost_volume(
        *[jnp.asarray(a) for a in (cur, lookup, poses, K, invK)], bins,
        chunk=D)
    conf = jcv.confidence_mask_from_cost(cost, missing)
    disp = jcv.indices_to_disparity(cost, bins)
    return ((cur, lookup, poses, K, invK, np.asarray(bins)),
            [np.asarray(a) for a in (cost, missing, conf, disp)])


@pytest.mark.parametrize("n", [2, 3, 5])
def test_split_volume_equals_the_sharded_path(sharded_reference, n):
    """The depth axis in one process: each of n shares runs the plain K1
    on its planes alone (96 over 5 is uneven: 20 + 4 x 19), the shares are
    summed as the row's all-reduce sums them, and the missing -> max fill,
    the confidence and the lowest-cost disparity then span all 96 planes.
    The cost at the file's atol 3e-5; the missing mask, confidence and
    disparity exactly."""
    inputs, (w_cost, w_missing, w_conf, w_disp) = sharded_reference
    args = [torch.from_numpy(a) for a in inputs]
    D = args[-1].shape[0]
    sizes = [tcv.plane_share(D, i, n) for i in range(n)]
    assert [s.start for s in sizes] == [0] + [s.stop for s in sizes[:-1]]
    assert sizes[-1].stop == D
    before = tk.plane_sweep_diffs.launches
    shares = [tk.plane_sweep_cost_share(*args, index=i, n=n)
              for i in range(n)]
    for s, share in zip(sizes, shares):   # each share writes its planes only
        outside = torch.ones(D, dtype=torch.bool)
        outside[s] = False
        assert share[:, outside].abs().max() == 0
    cost, missing = tcv.fill_missing(sum(shares))
    assert tk.plane_sweep_diffs.launches == before
    np.testing.assert_allclose(cost.numpy(), w_cost, atol=ATOL)
    np.testing.assert_array_equal(missing.numpy(), w_missing)
    conf = tcv.confidence_mask_from_cost(cost, missing)
    np.testing.assert_array_equal(conf.numpy(), w_conf)
    disp = tcv.indices_to_disparity(cost, args[-1])
    np.testing.assert_array_equal(disp.numpy(), w_disp)
