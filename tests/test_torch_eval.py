"""The port's depth evaluation (`mal_tpu_torch.eval`) against `mal_tpu.eval`,
on the CPU, with the same numpy inputs.

The host-side protocol (metrics, crops, median scaling, flip averaging,
saved predictions) is numpy in both packages except the disparity resize,
which each package does with its own bilinear resize: agreement to 1e-6
relative. `mal_tpu`'s side runs op by op (`jax.disable_jit()`): jitted, XLA
fuses the resize's interpolation and rounds it otherwise, up to 4e-5
relative from `mal_tpu`'s own op-by-op result on these random disparities,
while the port's resize equals the op-by-op one. `infer_disparities` and
DynamicDepth's `evaluate_dynamic` run `mal_tpu`'s jitted eval forward and
the port's on the same random weights: 1e-4, as `tests/test_torch_models.py`
holds the nets.
"""

import jax
import numpy as np
import pytest
import torch

from mal_tpu.dynamic.evaluate import _metrics_one as j_metrics_one
from mal_tpu.dynamic.evaluate import evaluate_dynamic as j_evaluate_dynamic
from mal_tpu.eval.evaluate import evaluate_depth_maps as j_evaluate
from mal_tpu.eval.evaluate import infer_disparities as j_infer
from mal_tpu.eval.evaluate import prepare_gt_and_pred as j_prepare
from mal_tpu.eval.metrics import compute_depth_errors_np as j_errors
from mal_tpu.eval.postprocess import load_ext_disps as j_load_ext
from mal_tpu.eval.postprocess import post_process_disparity as j_post
from mal_tpu.models import MALModel as JaxMALModel
from mal_tpu_torch.convert.jax_params import load_jax_dynamic_variables
from mal_tpu_torch.dynamic.evaluate import _metrics_one, evaluate_dynamic
from mal_tpu_torch.dynamic.model import DynDepthModel
from mal_tpu_torch.eval.evaluate import (evaluate_depth_maps,
                                         infer_disparities,
                                         prepare_gt_and_pred)
from mal_tpu_torch.eval.metrics import compute_depth_errors_np
from mal_tpu_torch.eval.postprocess import (load_ext_disps,
                                            post_process_disparity,
                                            save_pred_disps)

from test_torch_common import (CFG, np_batch, port_model, random_mal_variables,
                               torch_cfg)

HOST = dict(rtol=1e-6, atol=0)
NET = dict(rtol=1e-4, atol=1e-4)
BINS = (0.5, 10.0)
# `tests/test_torch_dynamic_step.py`'s DynamicDepth configuration
DYN_CFG = CFG.replace(method="dynamicdepth", cv_min=True, cv_set_1=True,
                      cv_pool_th=0.15, loss_blc=False, use_ensemble=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core then oversubscribes
    them (30x slower steps measured under a six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gt(rng, h, w):
    """GT depths in (0, 90) with holes, so the masks and caps matter."""
    gt = rng.uniform(0.5, 90.0, (h, w)).astype(np.float32)
    gt[rng.uniform(size=(h, w)) < 0.3] = 0.0
    return gt


def _disps(rng, n=3):
    return rng.uniform(0.01, 0.5, (n, CFG.height, CFG.width)).astype(np.float32)


def _assert_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **HOST, err_msg=k)


def test_depth_errors():
    rng = np.random.RandomState(0)
    gt = rng.uniform(1, 80, 5000)
    pred = gt * rng.uniform(0.6, 1.5, 5000)
    _assert_dicts(compute_depth_errors_np(gt, pred), j_errors(gt, pred))


@pytest.mark.parametrize("split,gt_shape", [
    ("eigen", (375, 1242)), ("cityscapes", (1024, 2048)),
    ("ddad", (375, 1242)), ("benchmark", (375, 1242))])
def test_prepare_gt_and_pred(split, gt_shape):
    rng = np.random.RandomState(1)
    gt = _gt(rng, *gt_shape)
    disp = _disps(rng, 1)[0]
    for median_scaling in (True, False):
        got = prepare_gt_and_pred(gt, disp, split,
                                  median_scaling=median_scaling,
                                  pred_depth_scale_factor=1.7)
        with jax.disable_jit():
            want = j_prepare(gt, disp, split, median_scaling=median_scaling,
                             pred_depth_scale_factor=1.7)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **HOST)


@pytest.mark.parametrize("split", ["eigen", "ddad"])
@pytest.mark.parametrize("median_scaling,scale", [(True, 1.0), (False, 5.4)])
def test_evaluate_depth_maps(split, median_scaling, scale):
    rng = np.random.RandomState(2)
    disps = _disps(rng)
    gts = [_gt(rng, 375, 1242) for _ in disps]
    got = evaluate_depth_maps(disps, gts, split, median_scaling=median_scaling,
                              pred_depth_scale_factor=scale)
    with jax.disable_jit():
        want = j_evaluate(disps, gts, split, median_scaling=median_scaling,
                          pred_depth_scale_factor=scale)
    _assert_dicts(got, want)


def test_post_process_disparity():
    rng = np.random.RandomState(3)
    d, df = _disps(rng), _disps(rng)
    np.testing.assert_array_equal(post_process_disparity(d, df), j_post(d, df))


def test_saved_and_external_disparities(tmp_path):
    rng = np.random.RandomState(4)
    disps = _disps(rng, 5)
    path = save_pred_disps(disps, str(tmp_path), "eigen", eval_teacher=True)
    assert path.endswith("teacher_eigen_split.npy")
    ids = tmp_path / "ids.npy"
    np.save(ids, np.array([4, 0, 2]))
    for idx in (None, str(ids)):
        np.testing.assert_array_equal(load_ext_disps(path, idx),
                                      j_load_ext(path, idx))


@pytest.fixture(scope="module")
def nets():
    params, stats = random_mal_variables(CFG, seed=0)
    batches = [np_batch(CFG, seed=s) for s in (10, 11)]
    return params, stats, port_model(CFG, params, stats), batches


@pytest.mark.parametrize("flags", [
    {}, {"eval_teacher": True}, {"zero_cost_volume": True, "static_camera": True}],
    ids=["student", "teacher", "zero_cost_volume+static_camera"])
def test_infer_disparities(nets, flags):
    params, stats, model, batches = nets
    want = j_infer(JaxMALModel(CFG), {"params": params, "batch_stats": stats},
                   batches, CFG, min_depth_bin=BINS[0], max_depth_bin=BINS[1],
                   **flags)
    got = infer_disparities(model, batches, torch_cfg(CFG),
                            min_depth_bin=BINS[0], max_depth_bin=BINS[1],
                            device="cpu", **flags)
    assert got.shape == (4, CFG.height, CFG.width)
    np.testing.assert_allclose(got, np.asarray(want), **NET)


def test_infer_disparities_post_process(nets):
    """Flip averaging: the teacher on each batch and on its mirror image,
    blended by `post_process_disparity`."""
    _, _, model, batches = nets
    kw = dict(min_depth_bin=BINS[0], max_depth_bin=BINS[1], device="cpu",
              eval_teacher=True)
    cfg = torch_cfg(CFG)
    mirrored = [dict(b, color={k: v[:, :, ::-1].copy()
                               for k, v in b["color"].items()})
                for b in batches]
    direct = infer_disparities(model, batches, cfg, **kw)
    flipped = infer_disparities(model, mirrored, cfg, **kw)[:, :, ::-1]
    got = infer_disparities(model, batches, cfg, post_process=True, **kw)
    np.testing.assert_allclose(got, post_process_disparity(direct, flipped),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="eval_teacher"):
        infer_disparities(model, batches, cfg, post_process=True,
                          device="cpu")


def test_infer_disparities_needs_the_card_unless_asked(nets, monkeypatch):
    _, _, model, batches = nets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_disparities(model, batches, torch_cfg(CFG))


def _box_mask(corners, h=CFG.height, w=CFG.width):
    """(B, h, w) dynamic-object masks: a 20x30 box at each (y, x), none
    where the corner is None."""
    doj = np.zeros((len(corners), h, w), np.float32)
    for b, c in enumerate(corners):
        if c is not None:
            doj[b, c[0]:c[0] + 20, c[1]:c[1] + 30] = 1.0
    return doj


@pytest.mark.parametrize("eval_split,split,gt_shape", [
    ("eigen", "eigen_zhou", (120, 400)),
    ("cityscapes", "cityscapes_preprocessed", (1024, 2048))])
@pytest.mark.parametrize("corner", [(20, 30), None], ids=["doj", "no_doj"])
def test_dynamic_metrics_one(eval_split, split, gt_shape, corner):
    """One image of DynamicDepth's protocol: the crops, the depth resize and
    caps, median scaling, the doj mask's nearest resize and its metrics."""
    rng = np.random.RandomState(6)
    gt = _gt(rng, *gt_shape)
    pred = rng.uniform(0.5, 60.0, (CFG.height, CFG.width)).astype(np.float32)
    doj = _box_mask([corner])[0]
    got = _metrics_one(gt, pred, doj, eval_split, split)
    with jax.disable_jit():
        want = j_metrics_one(gt, pred, doj, eval_split, split)
    _assert_dicts(got[0], want[0])
    _assert_dicts(got[1], want[1])
    assert got[2] == want[2] == int(corner is not None)


@pytest.fixture(scope="module")
def dyn_nets():
    params, stats = random_mal_variables(DYN_CFG, seed=1)
    model = DynDepthModel(torch_cfg(DYN_CFG), device="cpu",
                          init_weights=False)
    load_jax_dynamic_variables(model, params, stats)
    return params, stats, model


def test_evaluate_dynamic(dyn_nets):
    """DynamicDepth's eval loop, both packages on the same weights, batches,
    doj masks and GT: the student, `mono/`, `doj/` and `mono_doj/` families.
    One image has no doj pixel, so the doj families average over three
    images and the others over four."""
    params, stats, model = dyn_nets
    rng = np.random.RandomState(7)
    batches = []
    for seed, corners in ((10, [(20, 30), None]), (11, [(10, 50), (30, 10)])):
        b = np_batch(DYN_CFG, seed=seed)
        b["doj_mask"] = _box_mask(corners)
        b["doj_mask-1"] = np.roll(b["doj_mask"], -4, axis=2)
        b["doj_mask+1"] = np.roll(b["doj_mask"], 4, axis=2)
        batches.append(b)
    gts = [_gt(rng, 120, 400) for _ in range(4)]
    want = j_evaluate_dynamic(DYN_CFG, {"params": params, "batch_stats": stats},
                              batches, gts, *BINS)
    got = evaluate_dynamic(torch_cfg(DYN_CFG), model, batches, gts, *BINS,
                           device="cpu")
    assert set(got) == set(want)
    assert got["n_images"] == 4 and got["doj_batches"] == 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **NET, err_msg=k)
