"""DualRefine's weights and command line in the port, on the CPU:
`depth_pose.pth` both ways against `mal_tpu/convert/` (the exported keys,
a round trip bit for bit), the strict loads, and `python -m
mal_tpu_torch.cli train|eval|export-pth` with `method='dualrefine'` on a
fake KITTI tree (64x96, batch 2): two steps with a validation and the
end-of-epoch checkpoint, the freeze epoch, `--load_pretrained`, the
evaluation of the checkpoint and of its `.pth` export to the same
metrics, and those disparities against `mal_tpu`'s
`infer_disparities_dualref` on the same weights and batches (at 1e-4 of
their largest value).
"""

import contextlib
import copy
import math
import os
import shutil

import numpy as np
import pytest
import torch

from mal_tpu.config import Config as JConfig
from mal_tpu.convert.dualref import convert_dualrefine_checkpoint_dir
from mal_tpu.convert.export_dualref import PLACEHOLDER_KEYS
from mal_tpu.convert.export_dualref import \
    export_dualrefine_checkpoint_dir as jax_export_dir
from mal_tpu.dualref.evaluate import \
    infer_disparities_dualref as jax_infer_disparities
from mal_tpu.dualref.model import DEQDepthPose as JModel
from mal_tpu_torch.cli import build_eval_loader, main
from mal_tpu_torch.convert.dualref import (EXTRA_KEYS, PLACEHOLDER_PREFIXES,
                                           export_dualrefine_checkpoint_dir,
                                           load_dualrefine_checkpoint_dir,
                                           load_jax_dualref_variables)
from mal_tpu_torch.data.synthetic import write_fake_kitti
from mal_tpu_torch.dualref.evaluate import infer_disparities_dualref
from mal_tpu_torch.dualref.model import DEQDepthPose

from test_torch_common import leaves, torch_cfg
from test_torch_dualref_step import dualref_variables

CFG = JConfig(method="dualrefine", height=64, width=96, batch_size=2,
              deq_iters=4, corr_radius=2, corr_levels=2)
SMALL = ["height=64", "width=96", "batch_size=2", "method='dualrefine'",
         "deq_iters=4", "corr_radius=2", "corr_levels=2"]
# one validation (step 2); no checkpoint at it (`save_until`), so the end
# of each epoch writes the only ones (~0.5 GB each, with Adam's moments)
TRAIN = SMALL + ["compute_dtype='float32'", "validate_every=2",
                 "validate_from=0", "save_until=100", "log_every=1"]
EXTRAS = {"min_depth_bin": 0.5, "max_depth_bin": 40.0, "mean_depth_bin": 7.5,
          "median_depth_bin": 6.0, "height": 64, "width": 96}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_data.py says why."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def scratch(tmp_path):
    """`tmp_path`, emptied afterwards: each `depth_pose.pth` here is 0.2 GB
    and pytest keeps its last three temporary trees."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def weights():
    params, stats = dualref_variables()
    model = DEQDepthPose(torch_cfg(CFG), device="cpu", init_weights=False)
    load_jax_dualref_variables(model, params, stats)
    return params, stats, model


def _state(model) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _placeholder(key: str) -> bool:
    return key.startswith(PLACEHOLDER_PREFIXES)


def test_port_keys_are_the_reference_layout(weights, scratch):
    """The port's state dict is `mal_tpu`'s `depth_pose.pth` export less
    the extras and the placeholders, value for value; the placeholders are
    those `mal_tpu` flags (and torchvision's classifier heads)."""
    params, stats, model = weights
    path = jax_export_dir(params, stats, str(scratch), EXTRAS)
    ref = {k: v.numpy() for k, v in torch.load(path).items()
           if not k.endswith("num_batches_tracked")}
    for p in PLACEHOLDER_KEYS:
        assert _placeholder(p + ".")
    port = _state(model)
    kept = {k: v for k, v in ref.items()
            if k not in EXTRA_KEYS and not _placeholder(k)}
    assert set(port) == set(kept)
    for k, v in kept.items():
        np.testing.assert_array_equal(port[k], v, err_msg=k)
    assert set(ref) - set(kept) - set(EXTRA_KEYS) == {
        k for k in ref if _placeholder(k)}


def test_jax_load_is_strict(weights):
    """A missing flax leaf, or one the port has no tensor for, raises."""
    params, stats, model = weights
    short = copy.deepcopy(params)
    del short["update_block"]["gru"]["convq"]["g"]
    with pytest.raises(KeyError, match="convq"):
        load_jax_dualref_variables(copy.deepcopy(model), short, stats)
    extra = copy.deepcopy(params)
    extra["decoder"]["att72"]["stray"] = {"kernel": np.zeros((1, 1, 1, 1))}
    with pytest.raises(KeyError, match="stray"):
        load_jax_dualref_variables(copy.deepcopy(model), extra, stats)


def test_depth_pose_pth_both_ways(weights, scratch):
    """The port's export has `mal_tpu`'s export's keys and values (the
    placeholders included), reads back through `mal_tpu`'s converter to the
    original flax trees bit for bit, and a `mal_tpu` export loads into the
    port to the same state with its extras."""
    params, stats, model = weights
    ours = export_dualrefine_checkpoint_dir(model, str(scratch / "port"),
                                            EXTRAS)
    theirs = jax_export_dir(params, stats, str(scratch / "jax"), EXTRAS)
    a, b = torch.load(ours), torch.load(theirs)
    assert set(a) == set(b)
    for k in b:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(),
                                          err_msg=k)
    p2, s2, extras = convert_dualrefine_checkpoint_dir(str(scratch / "port"))
    for tree, back in ((params, p2), (stats, s2)):
        want, got = dict(leaves(tree)), dict(leaves(back))
        assert set(want) == set(got)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v,
                                          err_msg="/".join(k))
    assert {k: float(v) for k, v in extras.items()} == EXTRAS

    loaded = DEQDepthPose(torch_cfg(CFG), device="cpu", init_weights=False)
    got_extras = load_dualrefine_checkpoint_dir(loaded, str(scratch / "jax"))
    assert got_extras == EXTRAS
    got = _state(loaded)
    for k, v in _state(model).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A fake tree (4 training lines, 2 test lines) as the working
    directory, with one two-epoch `train` run in it: two steps and a
    validation each, the second epoch past `freeze_teacher_epoch`."""
    root = tmp_path_factory.mktemp("dualref_cli")
    with _cwd(root):
        paths = write_fake_kitti(".", n_train=4, n_test=2, size=(200, 60))
        trainer = main(["train", "--data_path", paths["data_path"], "--gt",
                        paths["gt"], "--device", "cpu", "--set", *TRAIN,
                        "num_epochs=2", "freeze_teacher_epoch=1",
                        "ckpt_dir='ck'"])
        yield paths, trainer
    shutil.rmtree(root, ignore_errors=True)


def _eval(paths, *extra):
    return main(["eval", "--data_path", paths["data_path"], "--gt",
                 paths["gt"], "--device", "cpu", *extra])


def _model_state(step_dir: str) -> dict:
    return torch.load(os.path.join(step_dir, "state.pt"))["model"]


def test_train_validates_saves_and_freezes(tree):
    """Four steps over two epochs, one validation; an end-of-epoch
    checkpoint per epoch (`save_frequency=1`) and no other; from epoch 1
    the optimizer moves only the refinement student."""
    paths, trainer = tree
    assert trainer.step == 4 and trainer.state.step == 4
    history = trainer.logger.history
    losses = [m for _, m in history if "loss" in m]
    assert len(losses) == 4 and losses[0]["pose_loss"] > 0
    assert all(math.isfinite(m["loss"]) for m in losses)
    assert [(s, math.isfinite(m["val/abs_rel"])) for s, m in history
            if "val/abs_rel" in m] == [(2, True)]
    assert sorted(os.listdir("ck")) == ["mal_e0", "mal_e1", "metrics.jsonl"]
    e0 = _model_state("ck/mal_e0/step_00000002")
    e1 = _model_state("ck/mal_e1/step_00000004")
    student = ("conv2.", "context.", "hidden.", "update_block.")
    moved = {k for k in e0 if "running" not in k and "num_batches" not in k
             and not torch.equal(e0[k], e1[k])}
    assert moved and all(k.startswith(student) for k in moved), sorted(moved)
    assert any(k.startswith("update_block.") for k in moved)
    assert float(trainer.state.bins.mean_depth) != 1.0


def test_eval_of_checkpoint_pth_and_mal_tpu(tree):
    """`eval` of the checkpoint and of its `export-pth` `depth_pose.pth`
    give the same metrics (to 1e-6); the disparities are those of
    `mal_tpu`'s `infer_disparities_dualref` on `mal_tpu`'s conversion of
    that file, over the same batches."""
    paths, _ = tree
    got = _eval(paths, "--ckpt", "ck/mal_e1")
    assert math.isfinite(got["abs_rel"]) and got["abs_rel"] > 0
    main(["export-pth", "--ckpt", "ck/mal_e1", "--out", "pth", "--device",
          "cpu"])
    pth = _eval(paths, "--ckpt", "pth", "--set", *SMALL)
    assert set(pth) == set(got)
    for k, v in got.items():
        assert abs(pth[k] - v) <= 1e-6 * max(abs(v), 1.0), k

    cfg = torch_cfg(CFG).replace(data_path=paths["data_path"])
    batches = list(build_eval_loader(cfg, paths["data_path"]))
    model = DEQDepthPose(cfg, device="cpu", init_weights=False)
    extras = load_dualrefine_checkpoint_dir(model, "pth")
    assert extras["height"] == 64 and extras["mean_depth_bin"] != 1.0
    ours = infer_disparities_dualref(model, batches, cfg, device="cpu")
    params, stats, _ = convert_dualrefine_checkpoint_dir("pth")
    theirs = jax_infer_disparities(JModel(CFG), {"params": params,
                                                 "batch_stats": stats},
                                   batches, CFG)
    assert ours.shape == theirs.shape == (2, 64, 96)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-4 * np.abs(theirs).max())


def test_load_pretrained_from_depth_pose_pth(tree):
    """`train --load_pretrained` of a `depth_pose.pth` directory sets every
    weight and the four bin statistics (zero epochs: nothing trains)."""
    paths, _ = tree
    if not os.path.isdir("pth"):
        main(["export-pth", "--ckpt", "ck/mal_e1", "--out", "pth",
              "--device", "cpu"])
    trainer = main(["train", "--data_path", paths["data_path"], "--device",
                    "cpu", "--no_eval", "--load_pretrained", "pth", "--set",
                    *TRAIN, "num_epochs=0", "ckpt_dir='ck_load'"])
    assert trainer.step == 0
    ref = torch.load("pth/depth_pose.pth")
    for k, v in trainer.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    bins = trainer.state.bins
    for field in ("min", "max", "mean", "median"):
        np.testing.assert_allclose(float(getattr(bins, f"{field}_depth")),
                                   float(ref[f"{field}_depth_bin"]),
                                   rtol=1e-6)
