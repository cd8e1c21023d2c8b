"""`mal_tpu_torch.losses` against `mal_tpu.losses`, on the CPU.

Inputs come from a numpy seed; images are NHWC for `mal_tpu` and NCHW for
the port. The automask noise is drawn once and handed to both. Tolerance:
1e-5 relative / 1e-6 absolute in float32 (sums over pixels in another
order), and equality for masks and selections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu import losses as jl
from mal_tpu_torch import losses as tl

from test_torch_common import nchw
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

B, H, W = 2, 16, 24
TOL = dict(rtol=1e-5, atol=1e-6)


def _img(seed, C=3):
    return np.random.RandomState(seed).uniform(0, 1, (B, H, W, C)).astype(np.float32)


def _t(a):
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(nchw(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, want, **tol):
    got = got.detach()
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("name", ["reprojection_loss", "l1_reprojection_loss"])
def test_reprojection(name):
    a, b = _img(0), _img(1)
    _close(getattr(tl, name)(_t(a), _t(b)), getattr(jl, name)(_j(a), _j(b)))


def test_smoothness():
    disp, img = _img(2, C=1), _img(3)
    _close(tl.smooth_loss(_t(disp), _t(img)), jl.smooth_loss(_j(disp), _j(img)))
    _close(tl.normalized_smooth_loss(_t(disp), _t(img)),
           jl.normalized_smooth_loss(_j(disp), _j(img)))


def test_automask_and_min_reprojection():
    a, b, c = _img(4), _img(5), _img(6)
    _close(tl.min_reprojection([_t(a), _t(b)], _t(c)),
           jl.min_reprojection([_j(a), _j(b)], _j(c)))
    r, i = _img(7, C=1), _img(8, C=1)
    i[0, 0, :4] = r[0, 0, :4]          # ties count as "reprojection wins"
    _close(tl.automask(_t(r), _t(i)), jl.automask(_j(r), _j(i)), rtol=0, atol=0)


def _mono_inputs():
    disp = _img(9, C=1)
    color = _img(10)
    warped = [np.clip(color + 0.1 * _img(11 + k) - 0.05, 0, 1) for k in range(2)]
    identity = [_img(13), _img(14)]
    return disp, color, warped, identity


def _syn_frames(seed):
    """Two temporal-hint frames, made as the warped frames are, so that
    they win some pixels of the min reprojection."""
    color = _img(10) if seed < 40 else _img(22)
    return [np.clip(color + 0.1 * _img(seed + k) - 0.05, 0, 1)
            for k in range(2)]


@pytest.mark.parametrize("variant", ["default", "avg_reprojection",
                                     "disable_automasking", "syn"])
def test_mono_losses(variant):
    disp, color, warped, identity = _mono_inputs()
    rng = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(rng, (B, H, W, 1), jnp.float32))
    kw = {variant: True} if variant not in ("default", "syn") else {}
    syn = _syn_frames(30) if variant == "syn" else []
    want = jl.mono_losses(rng, _j(disp), _j(color), [_j(w) for w in warped],
                          [_j(i) for i in identity],
                          syn=[_j(s) for s in syn], **kw)
    got = tl.mono_losses(_t(noise), _t(disp), _t(color),
                         [_t(w) for w in warped], [_t(i) for i in identity],
                         syn=[_t(s) for s in syn], **kw)
    # SSIM's variance terms cancel: one pixel of the syn frames' SSIM map
    # differs by 2.2e-6 between the packages, above TOL's atol
    tol = dict(rtol=1e-5, atol=5e-6) if syn else {}
    for g, w in zip(got, want, strict=True):
        _close(g, w, **tol)


def _multi_inputs():
    rng = np.random.RandomState(20)
    disp = _img(21, C=1)
    color = _img(22)
    warped = [np.clip(color + 0.1 * _img(23 + k) - 0.05, 0, 1) for k in range(2)]
    multi_depth = rng.uniform(1, 10, (B, H, W, 1)).astype(np.float32)
    mono_depth = rng.uniform(1, 10, (B, H, W, 1)).astype(np.float32)
    cmask = (rng.uniform(0, 1, (B, H, W)) > 0.3).astype(np.float32)
    aug = np.array([0.0, 1.0], np.float32).reshape(B, 1, 1, 1)
    mono_min = _img(25, C=1) * 0.3
    ens_min = _img(26, C=1) * 0.3
    return disp, color, warped, multi_depth, mono_depth, cmask, aug, mono_min, ens_min


@pytest.mark.parametrize("variant", ["ensemble", "no_ensemble", "dual_distil",
                                     "syn"])
def test_multi_losses(variant):
    (disp, color, warped, multi_depth, mono_depth, cmask, aug, mono_min,
     ens_min) = _multi_inputs()
    ens = ens_min if variant in ("ensemble", "syn") else None
    dual = mono_depth * 1.5 if variant == "dual_distil" else None
    syn = _syn_frames(50) if variant == "syn" else []
    want = jl.multi_losses(
        _j(disp), _j(color), [_j(w) for w in warped], _j(multi_depth),
        _j(mono_depth), _j(cmask), _j(aug), _j(mono_min),
        syn=[_j(s) for s in syn],
        ensemble_min_reproj=None if ens is None else _j(ens),
        dual_distil_mono_depth=None if dual is None else _j(dual))
    got = tl.multi_losses(
        _t(disp), _t(color), [_t(w) for w in warped], _t(multi_depth),
        _t(mono_depth), torch.from_numpy(cmask), torch.from_numpy(aug),
        _t(mono_min), syn=[_t(s) for s in syn],
        ensemble_min_reproj=None if ens is None else _t(ens),
        dual_distil_mono_depth=None if dual is None else _t(dual))
    for g, w in zip(got, want, strict=True):
        _close(g, w)


def test_multi_losses_gradient():
    """The gradient of the student loss + distillation w.r.t. the student
    disparity and depth, which carry the step's gradient."""
    (disp, color, warped, multi_depth, mono_depth, cmask, aug, mono_min,
     ens_min) = _multi_inputs()

    def jloss(d, md):
        out = jl.multi_losses(d, _j(color), [_j(w) for w in warped], md,
                              _j(mono_depth), _j(cmask), _j(aug), _j(mono_min),
                              ensemble_min_reproj=_j(ens_min))
        return out.loss + out.distil_loss

    gd, gm = jax.grad(jloss, argnums=(0, 1))(_j(disp), _j(multi_depth))
    d, md = _t(disp).requires_grad_(True), _t(multi_depth).requires_grad_(True)
    out = tl.multi_losses(d, _t(color), [_t(w) for w in warped], md,
                          _t(mono_depth), torch.from_numpy(cmask),
                          torch.from_numpy(aug), _t(mono_min),
                          ensemble_min_reproj=_t(ens_min))
    (out.loss + out.distil_loss).backward()
    _close(d.grad, gd)
    _close(md.grad, gm)


def test_matching_mask():
    rng = np.random.RandomState(30)
    mono = rng.uniform(1, 10, (B, H, W, 1)).astype(np.float32)
    lowest = rng.uniform(0.05, 1.5, (B, H, W)).astype(np.float32)
    _close(tl.matching_mask(_t(mono), torch.from_numpy(lowest)),
           jl.matching_mask(_j(mono), _j(lowest)), rtol=0, atol=0)


def test_loss_balance_sequence():
    """Three balancer updates (initialise, then two bounded adjustments,
    across a change of lambda) and an epoch reset."""
    js, ts = jl.LossBalancerState.create(), tl.LossBalancerState.create()
    for losses, lam in [((0.9, 0.02), 3.0), ((0.7, 0.03), 3.0),
                        ((0.8, 0.01), 1.5)]:
        jt, js = jl.loss_balance(js, jnp.asarray(losses, jnp.float32), lam)
        tt, ts = tl.loss_balance(ts, torch.tensor(losses), lam)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
        for field in ("w", "running_sum", "count", "prev_total", "prev_mean",
                      "initialized"):
            np.testing.assert_allclose(getattr(ts, field).numpy(),
                                       np.asarray(getattr(js, field)),
                                       rtol=1e-6, err_msg=field)
    js, ts = js.reset_epoch(), ts.reset_epoch()
    np.testing.assert_array_equal(ts.running_sum.numpy(), np.asarray(js.running_sum))
    np.testing.assert_array_equal(ts.count.numpy(), np.asarray(js.count))
