"""The online dynamic-object masks (`online_doj`) of the port, on the CPU.

`doj_from_instances` is held against `mal_tpu`'s on seeded instances (no
jit). The DynamicDepth step with a `doj_fn` is held against the same step
with those masks put in the batch, exactly: the masks are made before the
model runs, so nothing else may differ. Its segmenter is a stand-in module
whose logits and mask logits depend on the frame it sees, run through the
port's own `make_doj_fn` (`make_seg_fn`, `instance_inference`), in the
style of tests/test_torch_temporal.py; no `mal_tpu` program is built. The
trainer and the CLI refuse `online_doj` without the segmenter's weights.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.segment.doj import DYNAMIC_COCO_CLASSES as J_CLASSES
from mal_tpu.segment.doj import doj_from_instances as j_doj_from_instances
from mal_tpu.segment.instances import Instances as JInstances
from mal_tpu_torch.cli import main
from mal_tpu_torch.config import Config as TConfig
from mal_tpu_torch.segment.doj import (DYNAMIC_COCO_CLASSES,
                                       doj_from_instances, make_doj_fn)
from mal_tpu_torch.segment.instances import Instances
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import make_train_step
from mal_tpu_torch.train.trainer import Trainer

from test_torch_common import np_batch, to_torch, torch_cfg
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_dynamic_step import CFG, STEP_CFG

B, H, W = CFG.batch_size, CFG.height, CFG.width


# --------------------------------------------------------------------------
# doj_from_instances
# --------------------------------------------------------------------------

def _random_instances(seed, b=3, n=8, h=10, w=12):
    """numpy (masks, classes, scores, valid): random binary masks that
    overlap, classes drawn from the dynamic ones and from others (and -1),
    scores on both sides of the thresholds, some slots invalid."""
    rng = np.random.RandomState(seed)
    masks = (rng.uniform(0, 1, (b, n, h, w)) > 0.6).astype(np.float32)
    pool = np.array(list(DYNAMIC_COCO_CLASSES) + [4, 8, 9, 15, 79, -1])
    classes = rng.choice(pool, (b, n)).astype(np.int32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    scores[0, :3] = (0.5, 0.9, 0.3)    # at the thresholds: not above
    valid = rng.uniform(0, 1, (b, n)) > 0.25
    # item 0 surely has two kept dynamic masks, which overlap, a sure one
    # in an invalid slot, and a sure one of another class
    classes[0, 3:7] = (2, 0, 2, 9)
    scores[0, 3:7] = (0.95, 0.97, 0.99, 0.99)
    valid[0, 3:7] = (True, True, False, True)
    return masks, classes, scores, valid


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("threshold", [0.5, 0.9, 0.3])
def test_doj_from_instances_matches_mal_tpu(seed, threshold):
    inst = _random_instances(seed)
    got = doj_from_instances(Instances(*map(torch.from_numpy, inst)),
                             score_threshold=threshold)
    want = j_doj_from_instances(JInstances(*map(jnp.asarray, inst)),
                                score_threshold=threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert DYNAMIC_COCO_CLASSES == J_CLASSES
    # the cases the seed covers: an overlap of two kept masks, a kept mask
    # of a dynamic class, and a dynamic-class mask left out for its score
    # or its slot
    masks, classes, scores, valid = inst
    dyn = np.isin(classes, DYNAMIC_COCO_CLASSES)
    keep = dyn & (scores > threshold) & valid
    assert (np.einsum("bnhw,bn->bhw", masks, keep) > 1).any()
    assert (dyn & ~keep).any() and keep.any()
    assert got.max() == 1.0


def test_doj_from_instances_keeps_a_class_list():
    """Another class list, as `mal_tpu` takes one."""
    inst = _random_instances(7)
    got = doj_from_instances(Instances(*map(torch.from_numpy, inst)), (4, 8))
    want = j_doj_from_instances(JInstances(*map(jnp.asarray, inst)), (4, 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# The step with a doj_fn
# --------------------------------------------------------------------------

class StandInSegmenter(torch.nn.Module):
    """(logits (B, Q, 81), mask logits (B, Q, H/4, W/4)) from the frame:
    each query sure of one class (two dynamic, one not, one dynamic below
    the threshold) and a box whose place follows the frame's mean colour,
    so that every frame gets other masks."""

    def __init__(self):
        super().__init__()
        # the score threshold tests it against: ins_threshold
        self.classes = (2, 0, 9, 5)
        self.sure = (8.0, 8.0, 8.0, 0.5)

    def forward(self, images):
        Bn, Hn, Wn, _ = images.shape
        h, w = Hn // 4, Wn // 4
        logits = torch.zeros(Bn, 4, 81)
        masks = torch.full((Bn, 4, h, w), -5.0)
        for b in range(Bn):
            shift = int(images[b].mean() * 40) % (w // 2)
            for q, (c, s) in enumerate(zip(self.classes, self.sure)):
                logits[b, q, c] = s
                r0, c0 = 2 + 2 * q, shift + 3 * q
                masks[b, q, r0:r0 + h // 3, c0:c0 + w // 3] = 5.0
        return logits, masks


def _doj_fn(cfg):
    return make_doj_fn(StandInSegmenter(), cfg.max_instances,
                       score_threshold=cfg.ins_threshold)


def _batch(seed=0):
    batch = to_torch(np_batch(CFG, seed=seed, batch_size=B))
    batch["color"]["1"] = batch["color"]["1"] * 0.5   # frames differ
    return batch


def _draws():
    rng = np.random.RandomState(3)
    return {"matching_aug": torch.from_numpy(
                rng.uniform(0, 1, (B,)).astype(np.float32)),
            "automask_noise": torch.from_numpy(
                rng.randn(B, 1, H, W).astype(np.float32))}


@pytest.fixture(scope="module")
def stepped():
    """One step with `online_doj` and the stand-in's `doj_fn`, one without
    them on a batch that carries the same masks, from one state."""
    cfg = torch_cfg(STEP_CFG).replace(ins_threshold=0.9)
    state0 = create_train_state(cfg, device="cpu")
    doj_fn = _doj_fn(cfg)
    batch = _batch()
    masks = {"doj_mask": doj_fn(batch["color"]["0"])}
    for f in cfg.frame_ids[1:]:
        masks[f"doj_mask{f:+d}"] = doj_fn(batch["color"][str(f)])
    out = {}
    for name, c, fn, b in (
            ("online", cfg.replace(online_doj=True), doj_fn, batch),
            ("batch", cfg, None, {**batch, **masks})):
        state = copy.deepcopy(state0)
        state, m = make_train_step(c, device="cpu", doj_fn=fn)(
            state, b, 0.0, draws=_draws())
        out[name] = (state, m)
    return masks, out


def test_online_masks_are_real(stepped):
    """The masks are binary, without gradient, differ from frame to frame,
    and leave out the non-dynamic class and the unsure query."""
    masks, _ = stepped
    for k, m in masks.items():
        assert m.shape == (B, H, W) and not m.requires_grad, k
        assert set(m.unique().tolist()) == {0.0, 1.0}, k
    assert not torch.equal(masks["doj_mask"], masks["doj_mask+1"])
    seg = StandInSegmenter()
    only_kept = make_doj_fn(seg, 16, 0.9)(_batch()["color"]["0"])
    seg.classes = (2, 0, 2, 5)   # the third query now dynamic: more pixels
    more = make_doj_fn(seg, 16, 0.9)(_batch()["color"]["0"])
    assert torch.equal(only_kept, masks["doj_mask"])
    assert more.sum() > only_kept.sum()
    seg.sure = (8.0, 8.0, 8.0, 8.0)   # the fourth now sure as well
    assert make_doj_fn(seg, 16, 0.9)(_batch()["color"]["0"]).sum() > more.sum()


def test_step_with_doj_fn_equals_the_step_on_the_masks(stepped):
    """Loss and metrics, every gradient, and every parameter and BN
    statistic after the step: exact."""
    _, out = stepped
    (s1, m1), (s2, m2) = out["online"], out["batch"]
    assert set(m1) == set(m2)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert torch.isfinite(m1["loss"])
    g2 = dict(s2.model.named_parameters())
    for n, p in s1.model.named_parameters():
        assert torch.equal(p.grad, g2[n].grad), n
    sd2 = s2.model.state_dict()
    for k, v in s1.model.state_dict().items():
        assert torch.equal(v, sd2[k]), k
    assert torch.equal(s1.bins.min_depth, s2.bins.min_depth)
    assert torch.equal(s1.bins.max_depth, s2.bins.max_depth)


def test_online_doj_needs_a_doj_fn():
    cfg = torch_cfg(CFG).replace(online_doj=True)
    with pytest.raises(ValueError, match="doj_fn"):
        make_train_step(cfg, device="cpu")
    assert callable(make_train_step(cfg, device="cpu",
                                    doj_fn=_doj_fn(cfg)))


# --------------------------------------------------------------------------
# Refusals without the segmenter's weights
# --------------------------------------------------------------------------

def test_trainer_refuses_online_doj_without_weights():
    cfg = torch_cfg(CFG).replace(online_doj=True)
    with pytest.raises(ValueError, match="online_doj requires pretrained "
                       "Mask2Former weights"):
        Trainer(cfg, [], device="cpu")


def test_cli_refuses_online_doj_without_seg_pkl(tmp_path):
    from mal_tpu_torch.data.synthetic import write_fake_kitti

    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        paths = write_fake_kitti(".", n_train=2, n_test=1, size=(200, 60))
        with pytest.raises(ValueError, match="online_doj"):
            main(["train", "--data_path", paths["data_path"], "--device",
                  "cpu", "--no_eval", "--set", "height=64", "width=96",
                  "batch_size=2", "num_depth_bins=16", "method='dynamicdepth'",
                  "online_doj=True"])
    finally:
        os.chdir(old)
    assert TConfig().online_doj is False
