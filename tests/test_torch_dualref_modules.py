"""DualRefine's modules in the port against `mal_tpu`'s, on the CPU at tiny
sizes: the geometry additions, the HRNet trunk with `stages_count`, the
attention decoder, the update block with and without weight norm and the
convex upsampling, the epipolar cost with 1 and 2 heads over 2 levels, the
coordinate generators, the Gauss-Newton step (with the Cholesky fallback
and the robust weights), the solvers (Picard, Anderson with and without the
auxiliary state, Broyden, the phantom and IFT backwards) on a cheap
contractive map, the depth-bin tracker's mean / median EMAs, and the
port's copy of the RAFT utilities.

Weights are random draws on the flax trees' shapes (`random_tree`), carried
into the port by `mal_tpu_torch/convert/dualref.py`'s exporters. The
trunks run under a small `jax.jit`, the rest eagerly.

Tolerances: fp32 results at 1e-5 of their largest value (HRNet and the
decoder, whose BN-normalised maps pass ~60 convolutions, at 1e-4); the
solvers at 1e-5, their gradients at 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu import geometry as jgeo
from mal_tpu.dualref import raft_utils as jraft
from mal_tpu.dualref import solvers as jsol
from mal_tpu.dualref.corr import build_pyramid as jbuild_pyramid
from mal_tpu.dualref.corr import epipolar_cost as jepipolar_cost
from mal_tpu.dualref.hr_decoder import HRDepthDecoder as JDecoder
from mal_tpu.dualref.hrnet import HRNet as JHRNet
from mal_tpu.dualref.pose_update import _safe_cholesky as j_safe_cholesky
from mal_tpu.dualref.pose_update import direct_align as jdirect_align
from mal_tpu.dualref.reprojections import Reprojections as JReproj
from mal_tpu.dualref.update import SmallUpdateBlock as JUpdate
from mal_tpu.dualref.update import convex_upsample_disp as jconvex
from mal_tpu.train.state import DepthBinTracker as JBins
from mal_tpu_torch import geometry
from mal_tpu_torch.convert.dualref import (assign_strict, export_hr_decoder,
                                           export_hrnet_trunk,
                                           export_update_block)
from mal_tpu_torch.dualref import raft_utils, solvers
from mal_tpu_torch.dualref.corr import build_pyramid, epipolar_cost
from mal_tpu_torch.dualref.hr_decoder import HRDepthDecoder
from mal_tpu_torch.dualref.hrnet import HRNet
from mal_tpu_torch.dualref.pose_update import _safe_cholesky, direct_align
from mal_tpu_torch.dualref.reprojections import Reprojections
from mal_tpu_torch.dualref.update import SmallUpdateBlock, convex_upsample_disp
from mal_tpu_torch.train.state import DepthBinTracker

from test_torch_common import nchw, random_tree, to_numpy

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_data.py says why."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jit(fn, *args):
    """`jax.jit(fn)(*args)` compiled without LLVM's expensive passes (the
    same numbers, less compile time)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_llvm_disable_expensive_passes": True})(*args)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rel=1e-5, what=""):
    """Within `rel` of `want`'s largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _K(B, h, w):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    return np.broadcast_to(K, (B, 4, 4)).copy()


def _poses(B, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    xi = (scale * rng.randn(B, 6)).astype(np.float32)
    return np.asarray(jgeo.se3_exp(jnp.asarray(xi)))


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def test_geometry_additions():
    """depth_to_disp (and its round trip), the pixel-centre projection,
    se3_exp (with the small-angle branch) and skew."""
    rng = np.random.RandomState(0)
    depth = rng.uniform(0.5, 50, (2, 1, 5, 7)).astype(np.float32)
    _close(geometry.depth_to_disp(_t(depth), 0.1, 100.0),
           jgeo.depth_to_disp(jnp.asarray(depth), 0.1, 100.0), what="disp")
    disp = geometry.depth_to_disp(_t(depth), 0.1, 100.0)
    _close(geometry.disp_to_depth(disp, 0.1, 100.0)[1], depth, 1e-5)

    B, H, W = 2, 6, 8
    K = _K(B, H, W)
    pts = rng.uniform(-1, 1, (B, 4, H * W)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.5, 5, (B, H * W))
    pts[:, 3] = 1.0
    pts[0, 2, 0] = 0.0              # on the camera plane: the clip
    T = _poses(B, 1)
    _close(geometry.project_3d_center(_t(pts), _t(K), _t(T), H, W),
           jgeo.project_3d_center(jnp.asarray(pts), jnp.asarray(K),
                                  jnp.asarray(T), H, W), what="project")

    xi = (0.3 * rng.randn(4, 6)).astype(np.float32)
    xi[1, 3:] = 1e-8                # below the small-angle threshold
    _close(geometry.se3_exp(_t(xi)), jgeo.se3_exp(jnp.asarray(xi)),
           what="se3_exp")
    _close(geometry.skew(_t(xi[:, :3])), jgeo.skew(jnp.asarray(xi[:, :3])),
           what="skew")


# --------------------------------------------------------------------------
# trunk, decoder, update block
# --------------------------------------------------------------------------

def test_hrnet_stem_pools_both_images():
    """A train-mode forward with `stages_count=B` on a 2B batch: every tap,
    and every BN statistic after it. The stem's pool the 2B images, the
    stages' image 1's half (`mal_tpu/dualref/hrnet.py:114-141`); the stem
    taps keep all 2B images."""
    rng = np.random.RandomState(1)
    x = rng.uniform(-2, 2, (4, 64, 96, 3)).astype(np.float32)
    jm = JHRNet(base_width=18)
    v = random_tree(jax.eval_shape(
        lambda: jm.init(KEY, x, train=True, stages_count=2)), 1)
    taps, mut = to_numpy(_jit(lambda v, x: jm.apply(
        v, x, train=True, stages_count=2, mutable=["batch_stats"]), v, x))

    port = HRNet(18)
    assign_strict(port, export_hrnet_trunk(v["params"], v["batch_stats"],
                                           prefix=""), "hrnet")
    port.train()
    got = port(torch.from_numpy(nchw(x)), stages_count=2)
    assert got["stem1"].shape[0] == 4 and got["list18"][1].shape[0] == 2
    for key, want in taps.items():
        for i, (g, w) in enumerate(zip(got[key] if isinstance(got[key], list)
                                       else [got[key]],
                                       want if isinstance(want, list)
                                       else [want])):
            _close(g, nchw(w), 1e-4, f"{key}[{i}]")
    stats = export_hrnet_trunk(v["params"], mut["batch_stats"], prefix="")
    sd = port.state_dict()
    for k, w in stats.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k], w, 1e-4, k)


def test_hr_decoder():
    """The four disparities and the intermediate maps, on random taps of a
    32x64 input."""
    rng = np.random.RandomState(2)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    B = 2
    taps = {"stem1": r(B, 16, 32, 64), "stem2": r(B, 8, 16, 64),
            "list18": [r(B, 8, 16, 64)] + [r(B, 8, 16, 18) for _ in range(3)],
            "list36": [r(B, 4, 8, 36) for _ in range(3)],
            "list72": [r(B, 2, 4, 72) for _ in range(2)],
            "x144": r(B, 1, 2, 144)}
    jm = JDecoder()
    v = random_tree(jax.eval_shape(lambda: jm.init(KEY, taps)), 2)
    disps, inter = to_numpy(_jit(lambda v, t: jm.apply(v, t), v, taps))

    port = HRDepthDecoder()
    assign_strict(port, export_hr_decoder(v["params"], prefix=""), "decoder")
    # the ModuleList aliases are the same modules
    assert port.decoder[2] is port.convs["72"]
    tt = jax.tree.map(lambda a: torch.from_numpy(nchw(a)), taps)
    gd, gi = port(tt)
    for s in range(4):
        _close(gd[s], nchw(disps[s]), 1e-4, f"disp{s}")
    for k in inter:
        _close(gi[k], nchw(inter[k]), 1e-4, k)


@pytest.mark.parametrize("use_wnorm", [True, False])
def test_update_block(use_wnorm):
    """The GRU step (new state, depth delta), the mask and pose-weight
    heads, and the convex upsampling of a disparity through the mask."""
    rng = np.random.RandomState(3)
    B, h, w, L = 2, 6, 8, 2 * 5
    net = np.tanh(rng.randn(B, h, w, 64)).astype(np.float32)
    inp = np.maximum(rng.randn(B, h, w, 64), 0).astype(np.float32)
    corr = rng.uniform(0, 1, (B, h, w, L)).astype(np.float32)
    depth = rng.uniform(1, 20, (B, h, w, 1)).astype(np.float32)
    jm = JUpdate(input_dim=64, hidden_dim=64, use_wnorm=use_wnorm)

    def every_head(m, net, inp, corr, depth):
        new_net, delta = m(net, inp, corr, depth)
        mask = m.upsample_mask(new_net)
        disp = jax.nn.sigmoid(delta)
        return (new_net, delta, mask, m.pose_weight(new_net),
                jconvex(disp, mask))

    v = random_tree(jax.eval_shape(lambda: jm.init(
        KEY, net, inp, corr, depth, method=every_head)), 3)
    want = to_numpy(_jit(lambda v, *a: jm.apply(v, *a, method=every_head),
                         v, net, inp, corr, depth))
    assert ("g" in v["params"]["gru"]["convq"]) is use_wnorm

    port = SmallUpdateBlock(L, 64, 64, use_wnorm=use_wnorm)
    assign_strict(port, export_update_block(v["params"], prefix=""),
                  "update block")
    t = [torch.from_numpy(nchw(a)) for a in (net, inp, corr, depth)]
    new_net, delta = port(*t)
    mask = port.upsample_mask(new_net)
    got = (new_net, delta, mask, port.pose_weight(new_net),
           convex_upsample_disp(torch.sigmoid(delta), mask))
    for name, g, w_ in zip(("net", "delta", "mask", "weight", "upsampled"),
                           got, want):
        _close(g, nchw(w_), 1e-5, name)


# --------------------------------------------------------------------------
# epipolar sampling and the Gauss-Newton step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_head", [1, 2])
def test_epipolar_cost(num_head):
    """Two pyramid levels, coordinates partly outside the image (zero
    padding), the channel order level, head, sample."""
    rng = np.random.RandomState(4 + num_head)
    B, h, w, C, D, L = 2, 6, 8, 8, 5, 2
    f1 = rng.randn(B, h, w, C).astype(np.float32)
    f2 = rng.randn(B, h, w, C).astype(np.float32)
    coords = np.stack([rng.uniform(-2, w + 1, (B, L, D, h, w)),
                       rng.uniform(-2, h + 1, (B, L, D, h, w))],
                      axis=1).astype(np.float32)
    jpyr = jbuild_pyramid(jnp.asarray(f2), L)
    want = jepipolar_cost(jnp.asarray(f1), jpyr, jnp.asarray(coords), L,
                          num_head=num_head)
    pyr = build_pyramid(torch.from_numpy(nchw(f2)), L)
    for lv in range(L):
        _close(pyr[lv], nchw(jpyr[lv]), 1e-6, f"pyramid {lv}")
    got = epipolar_cost(torch.from_numpy(nchw(f1)), pyr, _t(coords), L,
                        num_head=num_head)
    assert got.shape == (B, L * num_head * D, h, w)
    _close(got, nchw(want), 1e-5, "cost")


def test_reprojections():
    """The epipolar sample coordinates (with max_dx and the sampled
    depths), the gradient coordinates with the transformed points, and
    the 96-bin sweep, at a learnt gap of softplus(0.3)."""
    rng = np.random.RandomState(6)
    B, h, w = 2, 6, 8
    depth = rng.uniform(1, 20, (B, h, w, 1)).astype(np.float32)
    K, T = _K(B, h, w), _poses(B, 6)
    jm = JReproj(corr_radius=2, num_levels=2, min_depth=0.1, max_depth=100.0)
    variables = {"params": {"delta": jnp.asarray([0.3]),
                            "delta_p": jnp.asarray([1.0])}}
    port = Reprojections(corr_radius=2, num_levels=2, min_depth=0.1,
                         max_depth=100.0)
    with torch.no_grad():
        port.delta.fill_(0.3)
    args_j = (jnp.asarray(T), jnp.asarray(depth), jnp.asarray(K))
    args_t = (_t(T), torch.from_numpy(nchw(depth)), _t(K))

    c, max_dx, ds = jm.apply(variables, *args_j,
                             method=JReproj.depth2epipolarcoords)
    gc, gmax, gds = port.depth2epipolarcoords(*args_t)
    _close(gc, c, 1e-5, "coords")
    _close(gmax, nchw(max_dx), 1e-6, "max_dx")
    _close(gds, ds, 1e-6, "depths")
    c, P2 = jm.apply(variables, *args_j, method=JReproj.depth2gradcoords)
    gc, gP2 = port.depth2gradcoords(*args_t)
    _close(gc, c, 1e-5, "grad coords")
    _close(gP2, P2, 1e-6, "points")
    c, ds = jm.apply(variables, *args_j, method=JReproj.depthbins2coords)
    gc, gds = port.depthbins2coords(*args_t)
    assert gc.shape == (B, 2, 1, 96, h, w)
    _close(gc, c, 1e-5, "bin coords")
    _close(gds, ds, 1e-6, "bin depths")


@pytest.mark.parametrize("robust", [False, True])
def test_direct_align(robust):
    """One Gauss-Newton step on two samples: the first with a
    positive-definite H (the Cholesky path), the second with all its
    weights 0, so H = 0: the Cholesky fails in both packages, the fallback
    solve(H + 1e-6 I, b) gives 0, and the pose stays. `robust` adds the
    Barron weights and the in-image mask, with the evolving pose weight."""
    rng = np.random.RandomState(7)
    B, h, w, C = 2, 12, 16, 8
    src = rng.randn(B, h, w, C).astype(np.float32)
    tgt = rng.randn(B, h, w, C).astype(np.float32)
    src_w = rng.uniform(0.2, 1, (B, h, w, 1)).astype(np.float32)
    src_w[1] = 0.0
    tgt_w = rng.uniform(0.2, 1, (B, h, w, 1)).astype(np.float32)
    weight = (rng.uniform(0, 1, (B, h, w, 1)).astype(np.float32)
              if robust else None)
    depth = rng.uniform(2, 20, (B, h, w, 1)).astype(np.float32)
    K, T = _K(B, h, w), _poses(B, 8)
    p2, P2 = JReproj(corr_radius=2, num_levels=1).apply(
        {"params": {"delta": jnp.ones(1), "delta_p": jnp.ones(1)}},
        jnp.asarray(T), jnp.asarray(depth), jnp.asarray(K),
        method=JReproj.depth2gradcoords)
    want_pose, want_upd = jdirect_align(
        jnp.asarray(T), jnp.asarray(K), p2, P2, jnp.asarray(src),
        jnp.asarray(tgt), jnp.asarray(src_w), jnp.asarray(tgt_w),
        None if weight is None else jnp.asarray(weight),
        robust_pose_loss=robust)
    got_pose, got_upd = direct_align(
        _t(T), _t(K), _t(p2), _t(P2), *(torch.from_numpy(nchw(a)) for a in
                                        (src, tgt, src_w, tgt_w)),
        None if weight is None else torch.from_numpy(nchw(weight)),
        robust_pose_loss=robust)
    assert float(np.abs(want_upd[0]).max()) > 0
    np.testing.assert_array_equal(np.asarray(want_upd[1]), 0.0)
    np.testing.assert_array_equal(got_upd[1].numpy(), 0.0)
    _close(got_upd, want_upd, 1e-4, "update")
    _close(got_pose, want_pose, 1e-6, "pose")


def test_safe_cholesky_flags_what_is_not_positive_definite():
    """The same (L, ok) as `mal_tpu`'s guard: a PD matrix factors; an
    indefinite one and the zero matrix take the identity and ok False."""
    rng = np.random.RandomState(9)
    a = rng.randn(6, 6)
    H = np.stack([a @ a.T + np.eye(6), np.diag([1, 1, 1, 1, 1, -1.0]),
                  np.zeros((6, 6))]).astype(np.float32)
    L, ok = _safe_cholesky(_t(H))
    jL, jok = j_safe_cholesky(jnp.asarray(H))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [True, False, False]
    _close(L, jL, 1e-6, "L")


# --------------------------------------------------------------------------
# solvers
# --------------------------------------------------------------------------

N_FEAT = 12


def _contraction(seed=0, radius=0.6):
    rng = np.random.RandomState(seed)
    A = rng.randn(N_FEAT, N_FEAT)
    A = (radius * A / np.abs(np.linalg.eigvals(A)).max()).astype(np.float32)
    b = rng.randn(N_FEAT).astype(np.float32)
    z0 = (0.1 * rng.randn(3, N_FEAT)).astype(np.float32)
    return A, b, z0


def _f_jax(A, b):
    return lambda z: jnp.tanh(z @ A.T + b)


def _f_torch(A, b):
    return lambda z: torch.tanh(z @ A.T + b)


@pytest.mark.parametrize("solver", ["picard", "anderson", "broyden"])
def test_solvers(solver):
    """Result, the selected trajectory and both residual traces."""
    A, b, z0 = _contraction(1)
    steps, indexing = 8, [2, 5, 8]
    jfn = {"picard": jsol.fixed_point_iter, "anderson": jsol.anderson_solver,
           "broyden": jsol.broyden_solver}[solver]
    tfn = {"picard": solvers.fixed_point_iter,
           "anderson": solvers.anderson_solver,
           "broyden": solvers.broyden_solver}[solver]
    want = jfn(_f_jax(jnp.asarray(A), jnp.asarray(b)), jnp.asarray(z0),
               steps, indexing=indexing)
    got = tfn(_f_torch(_t(A), _t(b)), _t(z0), steps, indexing=indexing)
    for name in ("result", "trajectory", "rel_trace", "abs_trace"):
        _close(getattr(got, name), getattr(want, name), 1e-5, name)


@pytest.mark.parametrize("steps,stop_mode", [(6, "abs"), (7, "rel"),
                                             (2, "abs")])
def test_anderson_solver_aux(steps, stop_mode):
    """The Anderson solve with an unmixed auxiliary state (a pose-like
    matrix and a norm, updated from z at every evaluation): the
    lowest-residual mixed iterate, the aux after the last evaluation, both
    trajectories, the traces and the mixed iterates. With steps = 2 the
    mixing never runs and the result is z0."""
    A, b, z0 = _contraction(2)
    B = z0.shape[0]
    pose0 = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()

    def make_f(f, mean, norm):
        def vec_f(z, aux):
            z_new = f(z)
            pose = aux[0] * (1.0 + 0.01 * mean(z_new)[:, None, None])
            return z_new, (pose, norm(z_new - z))
        return vec_f

    jf = make_f(_f_jax(jnp.asarray(A), jnp.asarray(b)),
                lambda z: jnp.mean(z, axis=1),
                lambda d: jnp.linalg.norm(d, axis=-1))
    tf = make_f(_f_torch(_t(A), _t(b)), lambda z: z.mean(dim=1),
                lambda d: torch.linalg.vector_norm(d, dim=-1))
    want = jsol.anderson_solver_aux(jf, jnp.asarray(z0),
                                    (jnp.asarray(pose0), jnp.ones(B)), steps,
                                    stop_mode=stop_mode)
    got = solvers.anderson_solver_aux(tf, _t(z0), (_t(pose0), torch.ones(B)),
                                      steps, stop_mode=stop_mode)
    if steps == 2:
        np.testing.assert_array_equal(got.result.numpy(), z0)
    for name in ("result", "z_trajectory", "rel_trace", "abs_trace",
                 "mixed_trajectory"):
        _close(getattr(got, name), getattr(want, name), 1e-5, name)
    # the norms are of differences of O(1) iterates, ~1e-2 here: 1e-4 of
    # them is the iterates' rounding
    for i, rel in enumerate((1e-5, 1e-4)):
        _close(got.aux[i], want.aux[i], rel, f"aux {i}")
        _close(got.aux_trajectory[i], want.aux_trajectory[i], rel,
               f"aux trajectory {i}")


@pytest.mark.parametrize("backward", ["phantom", "ift", "ift_safe"])
def test_backward_gradients(backward):
    """The parameters' gradients of sum(c * out) through the phantom unroll
    (3 damped steps, tau 0.7) and the IFT output (6 adjoint steps); with
    `safe`, on a map whose adjoint series overflows, frozen at its last
    finite iterate in both packages."""
    A, b, z0 = _contraction(3)
    if backward == "ift_safe":
        A = (1e12 * np.eye(N_FEAT)).astype(np.float32)
    c = np.random.RandomState(4).randn(*z0.shape).astype(np.float32)
    zs = np.asarray(jsol.fixed_point_iter(
        _f_jax(jnp.asarray(A), jnp.asarray(b)), jnp.asarray(z0), 30).result)

    def jloss(A, b):
        f = _f_jax(A, b)
        out = (jsol.phantom_grad(f, zs, steps=3, tau=0.7)
               if backward == "phantom"
               else jsol.ift_output(f, zs, b_steps=6,
                                    safe=backward == "ift_safe"))
        return jnp.sum(c * out)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))
    tA, tb = _t(A).requires_grad_(), _t(b).requires_grad_()
    f = _f_torch(tA, tb)
    out = (solvers.phantom_grad(f, _t(zs), steps=3, tau=0.7)
           if backward == "phantom"
           else solvers.ift_output(f, _t(zs), b_steps=6,
                                   safe=backward == "ift_safe"))
    (torch.from_numpy(c) * out).sum().backward()
    for g, w_ in zip((tA.grad, tb.grad), want):
        assert np.isfinite(np.asarray(w_)).all()
        _close(g, w_, 1e-4, backward)


# --------------------------------------------------------------------------
# bins, RAFT utilities
# --------------------------------------------------------------------------

def test_bin_tracker_mean_and_median_emas():
    """`track_stats`: the mean of batch element 0 and the batch mean of the
    lower median of row medians (even row lengths), beside the min / max."""
    rng = np.random.RandomState(10)
    depth = rng.uniform(0.5, 30, (3, 6, 8, 1)).astype(np.float32)
    want = JBins.create().update(jnp.asarray(depth), 0.1, 0.9,
                                 track_stats=True)
    got = DepthBinTracker.create().update(torch.from_numpy(nchw(depth)), 0.1,
                                          0.9, track_stats=True)
    for field in ("min_depth", "max_depth", "mean_depth", "median_depth"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-6, err_msg=field)
    plain = DepthBinTracker.create().update(torch.from_numpy(nchw(depth)),
                                            0.1, 0.9)
    assert float(plain.mean_depth) == float(plain.median_depth) == 1.0


@pytest.mark.parametrize("what", ["colorwheel", "flow_to_image", "flo",
                                  "padder", "forward_interpolate"])
def test_raft_utils_copy(what, tmp_path):
    """The port's copy of `mal_tpu/dualref/raft_utils.py` against the
    original."""
    rng = np.random.RandomState(11)
    flow = (5 * rng.randn(12, 10, 2)).astype(np.float32)
    if what == "colorwheel":
        np.testing.assert_array_equal(raft_utils.make_colorwheel(),
                                      jraft.make_colorwheel())
    elif what == "flow_to_image":
        for clip in (None, 3.0):
            np.testing.assert_array_equal(
                raft_utils.flow_to_image(flow, clip),
                jraft.flow_to_image(flow, clip))
    elif what == "flo":
        raft_utils.write_flo(str(tmp_path / "a.flo"), flow)
        np.testing.assert_array_equal(jraft.read_flo(str(tmp_path / "a.flo")),
                                      flow)
        jraft.write_flo(str(tmp_path / "b.flo"), flow)
        np.testing.assert_array_equal(
            raft_utils.read_flo(str(tmp_path / "b.flo")), flow)
    elif what == "padder":
        x = rng.randn(2, 13, 21, 3).astype(np.float32)
        for mode in ("sintel", "kitti"):
            ours = raft_utils.InputPadder(x.shape, mode=mode)
            theirs = jraft.InputPadder(x.shape, mode=mode)
            (p,), (q,) = ours.pad(x), theirs.pad(x)
            np.testing.assert_array_equal(p, q)
            np.testing.assert_array_equal(ours.unpad(p), x)
    else:
        np.testing.assert_array_equal(raft_utils.forward_interpolate(flow),
                                      jraft.forward_interpolate(flow))
