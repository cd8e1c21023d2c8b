"""DynamicDepth's warps, the DOMD block and the DynamicDepth losses in the
port against `mal_tpu`'s, on the CPU at 64x96.

Images are NHWC for `mal_tpu` and NCHW for the port; every input comes from
a numpy seed.

The splat casts each projected (x, y) to its pixel by truncation, so a
one-ulp difference in x near an integer moves a point to the next pixel.
The projections come out of `linalg.inv` and matrix products that the two
packages sum in other orders, so the splats are held by the share of
pixels that differ (measured at these seeds: none), not to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu import losses as jl
from mal_tpu.config import Config as JConfig
from mal_tpu.dynamic import domd as jdomd
from mal_tpu.dynamic import warp as jwarp
from mal_tpu.ops import warp as jops_warp
from mal_tpu_torch import losses as tl
from mal_tpu_torch.dynamic import domd as tdomd
from mal_tpu_torch.dynamic import warp as twarp
from mal_tpu_torch.ops import warp as tops_warp

from test_torch_common import nchw, np_batch, to_jax, to_torch, torch_cfg
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

B, H, W = 2, 64, 96
MAX_SHARE = 1e-3    # share of splatted pixels that may land elsewhere
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = JConfig(height=H, width=W, num_depth_bins=16, batch_size=B,
              method="dynamicdepth", cv_min=True, cv_set_1=True,
              cv_pool_th=0.15)


def _scene(seed=0):
    """A smooth depth (B, H, W) of 1-6 m, source -> target poses with a
    small rotation and a forward / sideways step, and K3 (B, 3, 3)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (2.0 + 1.5 * np.sin(xx / 9.0)[None] + yy[None] / 32.0
             + 0.3 * rng.uniform(0, 1, (B, H, W))).astype(np.float32)
    T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    th = 0.03
    T[:, 0, 0] = T[:, 2, 2] = np.cos(th)
    T[:, 0, 2], T[:, 2, 0] = np.sin(th), -np.sin(th)
    T[:, :3, 3] = [[0.15, 0.02, 0.1], [-0.1, 0.0, 0.2]]
    K = np_batch(CFG, seed)["K"][:, :3, :3]
    return depth, T, K


def _share_differing(got, want, tol=1e-4):
    """The share of entries further apart than `tol` of max(1, |want|): a
    pixel that landed elsewhere, not `grid_sample`'s rounding (~2e-5 on
    these [0, 1] images)."""
    got, want = np.asarray(got), np.asarray(want)
    return np.mean(np.abs(got - want) > tol * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("dilate", [False, True])
def test_splat_depth(dilate):
    """The z-buffered splat (exact x3, and the dilated 1x approximation):
    at most MAX_SHARE of the pixels differ, and most pixels were hit."""
    depth, T, K = _scene()
    want = jwarp.splat_depth(jnp.asarray(depth), jnp.asarray(T),
                             jnp.asarray(K), upscale=3, dilate=dilate)
    got = twarp.splat_depth(torch.from_numpy(depth), torch.from_numpy(T),
                            torch.from_numpy(K), dilate=dilate)
    assert (np.asarray(want) > 0).mean() > 0.5
    assert _share_differing(got.numpy(), want) <= MAX_SHARE


def test_forward_and_inverse_warp():
    """`inverse_warp` (zeros padding) at 1e-5, its valid mask exactly;
    `forward_warp`'s image, depth and validity with at most MAX_SHARE of
    the pixels differing."""
    depth, T, K = _scene(1)
    img = np.random.RandomState(2).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (img, depth, T, K)]
    targs = [torch.from_numpy(nchw(img))] + [torch.from_numpy(a)
                                             for a in (depth, T, K)]
    want_img, want_valid = jwarp.inverse_warp(*jargs)
    got_img, got_valid = twarp.inverse_warp(*targs)
    np.testing.assert_allclose(got_img.permute(0, 2, 3, 1).numpy(), want_img,
                               **TOL)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)

    want = jwarp.forward_warp(*jargs)
    got = twarp.forward_warp(*targs)
    assert np.asarray(want[2]).mean() > 0.3          # most pixels landed
    for g, w_ in zip((got[0].permute(0, 2, 3, 1), got[1], got[2]), want):
        assert _share_differing(g.numpy(), w_) <= MAX_SHARE


def test_zbuffer_scatter_max_and_forward_splat_depth():
    """`ops/warp.py`: the rounded scatter-max (half to even in both) at
    1e-6, with points off the image, ties on a pixel and invalid points;
    the masked forward splat of a depth map by its differing share."""
    rng = np.random.RandomState(3)
    N = 400
    pix = rng.uniform(-3, 20, (B, N, 2)).astype(np.float32)
    pix[:, :40] = np.round(pix[:, :40]) + 0.5        # exact halves
    vals = rng.uniform(0.1, 2.0, (B, N)).astype(np.float32)
    valid = rng.uniform(0, 1, (B, N)) > 0.2
    want = jops_warp.zbuffer_scatter_max(jnp.asarray(pix), jnp.asarray(vals),
                                         jnp.asarray(valid), 16, 12)
    got = tops_warp.zbuffer_scatter_max(torch.from_numpy(pix),
                                        torch.from_numpy(vals),
                                        torch.from_numpy(valid), 16, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    depth, T, _ = _scene(4)
    batch = np_batch(CFG, 4)
    mask = (rng.uniform(0, 1, (B, H, W)) > 0.5).astype(np.float32)
    args = (depth, T, batch["K"], batch["inv_K"], mask)
    want = jops_warp.forward_splat_depth(*map(jnp.asarray, args), H, W)
    got = tops_warp.forward_splat_depth(*map(torch.from_numpy, args), H, W)
    assert (np.asarray(want) > 0).mean() > 0.2
    assert _share_differing(got.numpy(), want) <= MAX_SHARE


def _domd_inputs(seed=5):
    """A batch with dynamic-object masks, the teacher's disparity, the two
    poses, an augmentation mask with one augmented item and the lookup
    frames (B, 1, H, W, 3), as numpy."""
    batch = np_batch(CFG, seed)
    doj = np.zeros((B, H, W), np.float32)
    doj[:, 20:40, 30:60] = 1.0
    batch["doj_mask"] = doj
    batch["doj_mask-1"] = np.roll(doj, -4, axis=2)
    batch["doj_mask+1"] = np.roll(doj, 4, axis=2)
    rng = np.random.RandomState(seed)
    disp = rng.uniform(0.02, 0.08, (B, H, W, 1)).astype(np.float32)
    _, T, _ = _scene(seed)
    T_p1 = T.copy()
    T_p1[:, :3, 3] *= -1.0
    aug = np.asarray([0.0, 1.0], np.float32)
    return batch, disp, T, T_p1, aug, batch["color_aug"]["-1"][:, None]


@pytest.mark.parametrize("no_reproj_doj,is_train", [(False, True),
                                                    (True, False)])
def test_domd_warp_inputs(no_reproj_doj, is_train):
    """The DOMD block: both adjacent colour frames and the lookup frames,
    with at most MAX_SHARE of the pixel values differing; the objects did
    move (the frames changed), and the augmented item's lookup frame did
    not."""
    batch, disp, T_m1, T_p1, aug, lookup = _domd_inputs()
    cfg = CFG.replace(no_reproj_doj=no_reproj_doj)
    want = jdomd.domd_warp_inputs(
        cfg, to_jax(batch), jnp.asarray(disp), jnp.asarray(T_m1),
        jnp.asarray(T_p1), jnp.asarray(aug), jnp.asarray(lookup),
        is_train=is_train)
    tb = to_torch(batch)
    for key in ("color", "color_aug"):
        tb[key] = {f: v.permute(0, 3, 1, 2) for f, v in tb[key].items()}
    got = tdomd.domd_warp_inputs(
        torch_cfg(cfg), tb, torch.from_numpy(nchw(disp)),
        torch.from_numpy(T_m1), torch.from_numpy(T_p1), torch.from_numpy(aug),
        torch.from_numpy(lookup).permute(0, 1, 4, 2, 3), is_train=is_train)
    got = [got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1),
           got[2].permute(0, 1, 3, 4, 2)]
    for g, w_, what in zip(got, want, ("color_m1", "color_p1", "lookup")):
        assert _share_differing(g.numpy(), w_) <= MAX_SHARE, what
    assert not np.array_equal(np.asarray(want[0]), batch["color"]["-1"])
    assert np.array_equal(np.asarray(want[1]), batch["color"]["1"]) \
        == (not is_train)
    np.testing.assert_array_equal(got[2][1].numpy(), lookup[1])


# --------------------------------------------------------------------------
# the DynamicDepth losses (1e-5 relative, 1e-6 absolute in float32, as
# tests/test_torch_losses.py holds the others; selections exactly)
# --------------------------------------------------------------------------

LTOL = dict(rtol=1e-5, atol=1e-6)


def _images(seed, n=3, black=True):
    """n NHWC images of (B, 16, 24, 3); with `black`, the second and third
    have blanked (DOMD-like) regions, overlapping in part."""
    rng = np.random.RandomState(seed)
    imgs = [rng.uniform(0, 1, (B, 16, 24, 3)).astype(np.float32)
            for _ in range(n)]
    if black:
        imgs[1][:, 2:8, 3:12] = 0.0
        imgs[2][:, 5:11, 8:20] = 0.0
    return imgs


def _t(a):
    return torch.from_numpy(nchw(np.array(a)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def test_zero_img_losses():
    """`reprojection_loss_zero_img` and the stateful
    `zero_img_reproj_sequence`: each map, and the threaded target."""
    target, p1, p2 = _images(6)
    np.testing.assert_allclose(
        _nhwc(tl.reprojection_loss_zero_img(_t(p1), _t(target))),
        jl.reprojection_loss_zero_img(jnp.asarray(p1), jnp.asarray(target)),
        **LTOL)
    want_maps, want_t = jl.zero_img_reproj_sequence(
        jnp.asarray(target), [jnp.asarray(p1), jnp.asarray(p2)])
    got_maps, got_t = tl.zero_img_reproj_sequence(_t(target), [_t(p1), _t(p2)])
    for g, w_ in zip(got_maps, want_maps):
        np.testing.assert_allclose(_nhwc(g), w_, **LTOL)
    np.testing.assert_array_equal(_nhwc(got_t), want_t)
    assert (np.asarray(want_t) == 0).any()


def test_apply_selec_reproj():
    _, w0, w1 = _images(7)
    losses = np.random.RandomState(8).uniform(0, 1, (B, 16, 24, 2)).astype(
        np.float32)
    want = jl.apply_selec_reproj(jnp.asarray(losses),
                                 [jnp.asarray(w0), jnp.asarray(w1)])
    got = tl.apply_selec_reproj(_t(losses), [_t(w0), _t(w1)])
    np.testing.assert_array_equal(_nhwc(got), want)
    assert (np.asarray(want) == 0).any()      # both frames black somewhere


@pytest.mark.parametrize("size", [(4, 6), (5, 7)])
def test_feature_metric_loss(size):
    """Area resize where the sizes divide, bilinear where they do not."""
    rng = np.random.RandomState(9)
    feat = rng.normal(0, 1, (B,) + size + (8,)).astype(np.float32)
    img = _images(10, n=1, black=False)[0]
    want = jax.jit(jl.feature_metric_loss, static_argnums=(2, 3))(
        jnp.asarray(feat), jnp.asarray(img), 0.02, 0.03)   # one compile
    np.testing.assert_allclose(
        tl.feature_metric_loss(_t(feat), _t(img), 0.02, 0.03).numpy(), want,
        **LTOL)


def test_mono_and_multi_losses_with_dynamicdepth_options():
    """`mono_losses` / `multi_losses` with `selec_reproj` and with injected
    `zero_img` maps and smoothness colour, as the DynamicDepth step calls
    them."""
    color, w0, w1 = _images(11)
    rng = np.random.RandomState(12)
    disp = rng.uniform(0.05, 0.5, (B, 16, 24, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jnoise = np.asarray(jax.random.normal(key, (B, 16, 24, 1), jnp.float32))
    w_maps, tgt = jl.zero_img_reproj_sequence(
        jnp.asarray(color), [jnp.asarray(w0), jnp.asarray(w1)])
    i_maps, tgt = jl.zero_img_reproj_sequence(tgt, [jnp.asarray(w1),
                                                    jnp.asarray(w0)])
    for zero_img in (False, True):
        jkw = (dict(reproj_maps=w_maps, identity_maps=i_maps, smooth_color=tgt)
               if zero_img else {})
        tkw = ({k: ([_t(np.asarray(m)) for m in v] if isinstance(v, list)
                    else _t(np.asarray(v))) for k, v in jkw.items()})
        want = jl.mono_losses(key, jnp.asarray(disp), jnp.asarray(color),
                              [jnp.asarray(w0), jnp.asarray(w1)],
                              [jnp.asarray(w1), jnp.asarray(w0)],
                              selec_reproj=True, **jkw)
        got = tl.mono_losses(_t(jnoise), _t(disp), _t(color), [_t(w0), _t(w1)],
                             [_t(w1), _t(w0)], selec_reproj=True, **tkw)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(
                _nhwc(g) if g.dim() == 4 else g.numpy(), w_, **LTOL)

        depth = 1.0 / disp
        cmask = (rng.uniform(0, 1, (B, 16, 24)) > 0.3).astype(np.float32)
        augm = np.asarray([0.0, 1.0], np.float32).reshape(B, 1, 1, 1)
        jkw = dict(reproj_maps=w_maps, smooth_color=tgt) if zero_img else {}
        tkw = ({"reproj_maps": [_t(np.asarray(m)) for m in w_maps],
                "smooth_color": _t(np.asarray(tgt))} if zero_img else {})
        want = jl.multi_losses(
            jnp.asarray(disp), jnp.asarray(color),
            [jnp.asarray(w0), jnp.asarray(w1)], jnp.asarray(depth),
            jnp.asarray(depth * 1.1), jnp.asarray(cmask), jnp.asarray(augm),
            want.min_reproj, selec_reproj=True, **jkw)
        got = tl.multi_losses(
            _t(disp), _t(color), [_t(w0), _t(w1)], _t(depth), _t(depth * 1.1),
            torch.from_numpy(cmask), torch.from_numpy(augm),
            got.min_reproj, selec_reproj=True, **tkw)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(
                _nhwc(g) if g.dim() == 4 else g.numpy(), w_, **LTOL)
