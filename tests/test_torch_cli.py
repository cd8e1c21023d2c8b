"""The port's command line and trainer (`mal_tpu_torch.cli`,
`mal_tpu_torch.train.trainer`) on the CPU, on a fake KITTI tree at 64x96,
batch 2, 16 depth bins: train, validate and save; evaluate the checkpoint
and its reference-layout export to the same metrics; resume; the trainer's
first loss against the bare training step; the refusals; and
`finetune-seg` on a fake COCO tree at Swin-T, whose `model.pkl` both
packages read.
"""

import contextlib
import copy
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from mal_tpu_torch.cli import build_train_loader, main
from mal_tpu_torch.config import Config
from mal_tpu_torch.data.synthetic import KITTI_DRIVE, write_fake_kitti
from mal_tpu_torch.device import batch_to_device
from mal_tpu_torch.train.step import make_train_step
from mal_tpu_torch.train.trainer import MetricLogger, Trainer

SMALL = ["height=64", "width=96", "batch_size=2", "num_depth_bins=16"]
# exact fp32 on the CPU (train's default fast mode is for the card)
TRAIN = SMALL + ["compute_dtype='float32'", "cv_mxu_precision='highest'",
                 "validate_every=1", "validate_from=0", "save_until=0",
                 "log_every=1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core then oversubscribes
    them (30x slower steps measured under a six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """The fake tree (4 training lines, 2 test lines, 200x60 images), the
    working directory for every test here, with one `train` run in it."""
    root = tmp_path_factory.mktemp("cli")
    with _cwd(root):
        paths = write_fake_kitti(".", n_train=4, n_test=2, size=(200, 60))
        trainer = main(["train", "--data_path", paths["data_path"], "--gt",
                        paths["gt"], "--device", "cpu", "--set", *TRAIN,
                        "num_epochs=1", "ckpt_dir='ck'"])
        yield paths, trainer
    # a checkpoint with Adam's moments is ~0.5 GB
    shutil.rmtree(root, ignore_errors=True)


def _eval(paths, *extra):
    return main(["eval", "--data_path", paths["data_path"], "--gt",
                 paths["gt"], "--device", "cpu", *extra])


def test_train_runs_validates_and_saves(tree):
    paths, trainer = tree
    assert trainer.step == 2 and trainer.state.step == 2
    assert len(trainer.loader_wait_s) == len(trainer.step_s) == 2
    logged = dict(trainer.logger.history)
    assert sorted(logged) == [0, 1]
    assert math.isfinite(logged[0]["loss"])
    assert math.isfinite(logged[1]["val/abs_rel"])
    assert os.path.isfile("ck/mal_s1/step_00000002/state.pt")
    assert json.load(open("ck/mal_s1/config.json"))["height"] == 64


def test_eval_of_checkpoint_and_of_its_pth_export(tree):
    paths, _ = tree
    got = _eval(paths, "--ckpt", "ck/mal_s1")
    assert math.isfinite(got["abs_rel"]) and got["abs_rel"] > 0
    main(["export-pth", "--ckpt", "ck/mal_s1", "--out", "pth",
          "--device", "cpu"])
    assert _eval(paths, "--ckpt", "pth", "--set", *SMALL) == got
    teacher = _eval(paths, "--ckpt", "pth", "--eval_teacher",
                    "--post_process", "--save_pred_disps", "--set", *SMALL)
    assert math.isfinite(teacher["abs_rel"]) and teacher != got
    ext = _eval(paths, "--ext_disp_to_eval", "pth/teacher_eigen_split.npy",
                "--set", *SMALL)
    assert ext == teacher


def test_resume_continues_the_step_count(tree):
    paths, _ = tree
    trainer = main(["train", "--data_path", paths["data_path"], "--device",
                    "cpu", "--resume", "ck/mal_s1", "--set", *TRAIN,
                    "num_epochs=2", "ckpt_dir='ck2'", "save_until=100"])
    assert trainer.step == 4 and trainer.state.step == 4
    assert [s for s, m in trainer.logger.history if "loss" in m] == [2, 3]
    assert [s for s, m in trainer.logger.history if "val/n_images" in m] == [2, 3]
    assert not os.path.exists("ck2/mal_s3")     # before save_until


def test_first_loss_equals_the_training_step(tree):
    paths, _ = tree
    cfg = Config(data_path=paths["data_path"], native_loader=False,
                 num_epochs=1, log_every=1, height=64, width=96, batch_size=2,
                 num_depth_bins=16)

    def one_batch():      # the CLI's PIL loader over the first two lines
        loader = build_train_loader(cfg)
        loader.dataset.filenames = loader.dataset.filenames[:2]
        return loader

    history = MetricLogger(sink=lambda m, s: None)
    trainer = Trainer(cfg, one_batch(), logger=history, device="cpu", seed=4)
    state = copy.deepcopy(trainer.state)
    trainer.train()
    assert trainer.step == 1
    first = history.history[0][1]["loss"]

    step = make_train_step(cfg, "cpu")
    host = next(one_batch().epoch(0))
    _, metrics = step(state, batch_to_device(host, torch.device("cpu")), 0.0,
                      torch.Generator().manual_seed(4))
    np.testing.assert_allclose(first, metrics["loss"].item(), rtol=1e-6)


def test_dynamicdepth_train_and_eval_with_doj_masks(tree):
    paths, _ = tree
    os.makedirs("doj", exist_ok=True)
    mask = np.zeros((60, 200), np.float32)
    mask[20:50, 60:140] = 1.0
    for i in (1, 2):
        for suffix in ("", "-1", "+1"):
            np.save(f"doj/{KITTI_DRIVE.replace('/', '_')}_{i}_l{suffix}.npy",
                    mask)
    dyn = ["method='dynamicdepth'", "cv_min=True", "cv_set_1=True",
           "cv_pool_th=0.15"]
    trainer = main(["train", "--data_path", paths["data_path"], "--gt",
                    paths["gt"], "--device", "cpu", "--set", *TRAIN, *dyn,
                    "num_epochs=1", "ckpt_dir='ckd'"])
    assert trainer.step == 2
    got = _eval(paths, "--ckpt", "ckd/mal_s1", "--doj_root", "doj")
    assert got["n_images"] == 2 and got["doj_batches"] == 2
    for family in ("", "doj/", "mono/", "mono_doj/"):
        assert math.isfinite(got[family + "abs_rel"]), family
    main(["export-pth", "--ckpt", "ckd/mal_s1", "--out", "pthd",
          "--device", "cpu"])
    assert _eval(paths, "--ckpt", "pthd", "--doj_root", "doj",
                 "--set", *SMALL, *dyn) == got


def test_entry_points_need_the_card_unless_asked(tree, monkeypatch):
    paths, _ = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train", "--data_path", paths["data_path"], "--set", *TRAIN,
              "ckpt_dir='ck3'"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["eval", "--data_path", paths["data_path"], "--gt", paths["gt"],
              "--ckpt", "ck/mal_s1"])
    cfg = Config(data_path=paths["data_path"], height=64, width=96,
                 batch_size=2, num_depth_bins=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, build_train_loader(cfg))


@pytest.mark.parametrize("argv,error,match", [
    # refused before any process joins a group: the depth axis in one
    # process (a coordinator with the default --num_hosts 1, or none) ...
    (["train", "--data_path", "kitti", "--coordinator", "h:1", "--set",
      "num_depth_shards=2"], NotImplementedError, "one process.*--coordinator"),
    # ... and a world that num_depth_shards does not divide
    (["train", "--data_path", "kitti", "--num_hosts", "3", "--set",
      "num_depth_shards=2"], ValueError, "does not divide.*--num_hosts 3"),
    (["train", "--data_path", "kitti", "--coordinator", "h:1", "--num_hosts",
      "4", "--host_id", "1", "--set", "num_depth_shards=3"], ValueError,
     "does not divide.*--num_hosts 4"),
    (["train", "--data_path", "kitti", "--set", "method='dualrefine'",
      "num_depth_shards=2"], NotImplementedError, "one process.*--coordinator"),
    # one process: mal_tpu's device mesh, run as one process per card
    (["train", "--data_path", "kitti", "--set", "num_data_shards=2"],
     NotImplementedError, "M6"),
    (["train", "--data_path", "kitti", "--set", "num_depth_shards=2"],
     NotImplementedError, "one process.*--coordinator")])
def test_refusals_name_the_roadmap_item(tree, argv, error, match):
    with pytest.raises(error, match=match):
        main(argv + ["--device", "cpu"])


def test_temporal_needs_pretrained_segmenter_weights(tree):
    paths, _ = tree
    with pytest.raises(ValueError, match="Mask2Former"):
        main(["train", "--data_path", paths["data_path"], "--device", "cpu",
              "--set", *TRAIN, "temporal=True"])


def test_finetune_seg(tmp_path, capsys, monkeypatch):
    """`finetune-seg` with `mal_tpu`'s flags at Swin-T, 64x96, 8 queries, 2
    steps: finite losses, mask AP printed, `model.pkl` read back by the
    port and by `mal_tpu`'s converter to the same arrays, `seg_state.pt` to
    the same model; `--seg_pkl` starts from it (no step: the same AP); and
    without `--device cpu` it needs the card."""
    from mal_tpu.convert.mask2former import convert_mask2former_pkl
    from mal_tpu_torch.convert.jax_params import mask2former_state_dict
    from mal_tpu_torch.convert.mask2former import load_mask2former_pkl
    from mal_tpu_torch.data.synthetic import write_fake_coco
    from mal_tpu_torch.segment.mask2former import Mask2Former

    paths = write_fake_coco(str(tmp_path), n_images=4, n_categories=5,
                            size=(160, 120))
    argv = ["finetune-seg", "--images", paths["images"], "--annotations",
            paths["annotations"], "--size", "tiny", "--height", "64",
            "--width", "96", "--num_queries", "8", "--num_points", "64",
            "--max_instances", "4", "--lr", "1e-3"]
    out = str(tmp_path / "out")
    got = main(argv + ["--out", out, "--device", "cpu"])
    assert len(got["steps"]) == 2
    for m in got["steps"]:
        assert set(m) == {"loss", "loss_ce", "loss_mask", "loss_dice", "ms",
                          "match_copy_ms", "match_solve_ms"}
        assert all(math.isfinite(v) for v in m.values()), m
    printed = capsys.readouterr().out
    assert '"AP"' in printed and "step 2:" in printed
    assert set(got["AP"]) == {"AP", "AP50", "AP75"}
    assert got["saved"] == [os.path.join(out, "seg_state.pt"),
                            os.path.join(out, "model.pkl")]

    model = Mask2Former(num_classes=5, swin_size="tiny", num_queries=8,
                        device="cpu", init_weights=False)
    load_mask2former_pkl(model, got["saved"][1])
    jax_sd = mask2former_state_dict(
        convert_mask2former_pkl(got["saved"][1], size="tiny")["params"],
        "tiny")
    state = torch.load(got["saved"][0])
    assert set(jax_sd) == set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jax_sd[k]),
                                      err_msg=k)
        assert torch.equal(v, state[k]), k

    again = main(argv + ["--seg_pkl", got["saved"][1], "--epochs", "0",
                         "--device", "cpu"])
    assert again["steps"] == [] and again["AP"] == got["AP"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
