"""The port's checkpoints (`mal_tpu_torch.utils.checkpoint`, the Mask2Former
`.pkl` converter) against `mal_tpu.convert`, and its `step` schedule and
gradient clipping against optax, on the CPU, with the same numpy inputs.

Weights move between the packages as copies, so every comparison of
weights is exact.
"""

import copy
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mal_tpu.convert import (convert_imagenet_trunk,
                             convert_mal_checkpoint_dir,
                             export_dynamic_checkpoint_dir,
                             export_mal_checkpoint_dir)
from mal_tpu.convert.mask2former import (convert_mask2former_pkl,
                                         export_mask2former_pkl as j_export_pkl)
from mal_tpu.segment.mask2former import Mask2Former as JMask2Former
from mal_tpu.train.lr_schedule import step_lr_schedule as j_step_lr
from mal_tpu.train.state import make_optimizer as j_make_optimizer
from mal_tpu_torch.convert.jax_params import (flax_to_state_dict,
                                              load_jax_dynamic_variables,
                                              load_jax_mask2former)
from mal_tpu_torch.convert.mask2former import (export_mask2former_pkl,
                                               load_mask2former_pkl, load_pkl)
from mal_tpu_torch.dynamic.model import DynDepthModel
from mal_tpu_torch.segment.mask2former import Mask2Former
from mal_tpu_torch.train.lr_schedule import make_schedule
from mal_tpu_torch.train.state import (DepthBinTracker, apply_gradients,
                                       create_train_state, make_optimizer)
from mal_tpu_torch.train.step import make_train_step
from mal_tpu_torch.utils.checkpoint import (export_checkpoint_dir,
                                            latest_checkpoint,
                                            load_checkpoint, load_config,
                                            load_imagenet_trunks,
                                            load_pretrained, save_checkpoint)

from test_torch_common import (CFG, leaves, np_batch, port_model,
                               random_mal_variables, to_torch, torch_cfg)

BINS = {"min_depth_bin": 0.3, "max_depth_bin": 12.0}
TEACHER = ("mono_encoder", "mono_depth", "pose_encoder", "pose")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core then oversubscribes
    them (30x slower steps measured under a six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def remove_written_files(tmp_path):
    """The checkpoints written here take ~1 GB together: gone after each
    test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _weights(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _same(got: dict, want: dict, keys=None):
    keys = sorted(want) if keys is None else keys
    for k in keys:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def flax_weights():
    params, stats = random_mal_variables(CFG, seed=1)
    return params, stats, port_model(CFG, params, stats)


# ---------------------------------------------------------------------------
# The resumable checkpoint
# ---------------------------------------------------------------------------

def test_save_and_load_restore_everything(tmp_path):
    cfg = torch_cfg(CFG)
    state = create_train_state(cfg, "cpu", init_weights=False)
    step = make_train_step(cfg, "cpu")
    batch = to_torch(np_batch(CFG, seed=3))
    state, _ = step(state, batch, 0.0, torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), state, cfg)
    assert path == latest_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "step_00000001"
    assert load_config(str(tmp_path)) == cfg

    other = create_train_state(cfg, "cpu", init_weights=False)
    assert not torch.equal(other.model.depth.decoder[10].conv.weight,
                           state.model.depth.decoder[10].conv.weight)
    load_checkpoint(path, other)
    assert other.step == 1
    _same(other.model.state_dict(), state.model.state_dict())
    want, got = state.optimizer.state_dict(), other.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"])
    for i, moments in want["state"].items():
        assert float(moments["step"]) == 1.0
        assert moments["exp_avg"].any()
        _same(got["state"][i], moments)
    for part in ("bins", "balancer"):
        for k, v in vars(getattr(state, part)).items():
            torch.testing.assert_close(getattr(getattr(other, part), k), v,
                                       rtol=0, atol=0, msg=f"{part}.{k}")
    assert other.balancer.initialized.item()


# ---------------------------------------------------------------------------
# The reference's per-net layout
# ---------------------------------------------------------------------------

def test_load_pretrained_of_mal_tpu_export(flax_weights, tmp_path):
    params, stats, want = flax_weights
    export_mal_checkpoint_dir(params, stats, str(tmp_path), extras=BINS)
    model = copy.deepcopy(want)
    for p in model.parameters():
        torch.nn.init.zeros_(p)
    bins = DepthBinTracker.create()
    loaded = load_pretrained(model, str(tmp_path), bins=bins)
    assert loaded == ["encoder", "depth", "mono_encoder", "mono_depth",
                      "pose_encoder", "pose"]
    _same(_weights(model), _weights(want))
    assert bins.min_depth.item() == np.float32(0.3)
    assert bins.max_depth.item() == np.float32(12.0)


def test_load_pretrained_subset(flax_weights, tmp_path):
    """The teacher and pose nets alone, from a folder holding only theirs
    (`--mono_weights_folder`): the student keeps its weights."""
    params, stats, want = flax_weights
    full, part = tmp_path / "full", tmp_path / "part"
    export_mal_checkpoint_dir(params, stats, str(full), extras=BINS)
    part.mkdir()
    for name in TEACHER:
        shutil.copy(full / f"{name}.pth", part / f"{name}.pth")
    model = copy.deepcopy(want)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    before = _weights(model)
    bins = DepthBinTracker.create()
    assert load_pretrained(model, str(part), TEACHER, bins=bins) == list(TEACHER)
    got = _weights(model)
    teacher = [k for k in got if k.split(".")[0] in TEACHER]
    student = [k for k in got if k.split(".")[0] not in TEACHER]
    _same(got, _weights(want), teacher)
    _same(got, before, student)
    assert bins.min_depth.item() == np.float32(0.1)   # no encoder.pth read


def test_load_pretrained_is_strict(flax_weights, tmp_path):
    params, stats, want = flax_weights
    export_mal_checkpoint_dir(params, stats, str(tmp_path))
    sd = torch.load(tmp_path / "depth.pth", weights_only=True)
    del sd["decoder.10.conv.bias"]
    torch.save(sd, tmp_path / "depth.pth")
    with pytest.raises(KeyError, match="decoder.10.conv.bias"):
        load_pretrained(copy.deepcopy(want), str(tmp_path))
    sd["decoder.10.conv.bias"] = torch.zeros(1)
    sd["stray.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "depth.pth")
    with pytest.raises(KeyError, match="stray"):
        load_pretrained(copy.deepcopy(want), str(tmp_path))


def test_load_pretrained_dynamic(flax_weights, tmp_path):
    """`mal_tpu`'s DynamicDepth export (its trunk and `reduce_conv` hoisted
    to the top level) into the port's `DynDepthModel`, against
    `load_jax_dynamic_variables` on the same trees."""
    params, stats, _ = flax_weights
    dparams, dstats = dict(params), dict(stats)
    enc = dparams.pop("encoder")
    dparams["encoder"], dparams["reduce_conv"] = enc["encoder"], enc["reduce_conv"]
    dstats["encoder"] = dstats["encoder"]["encoder"]
    export_dynamic_checkpoint_dir(dparams, dstats, str(tmp_path), extras=BINS)
    cfg = torch_cfg(CFG).replace(method="dynamicdepth")
    want = DynDepthModel(cfg, device="cpu")
    load_jax_dynamic_variables(want, dparams, dstats)
    model = copy.deepcopy(want)
    for p in model.parameters():
        torch.nn.init.zeros_(p)
    bins = DepthBinTracker.create()
    load_pretrained(model, str(tmp_path), bins=bins)
    _same(_weights(model), _weights(want))
    assert bins.max_depth.item() == np.float32(12.0)


def test_export_read_back_by_mal_tpu(flax_weights, tmp_path):
    params, stats, model = flax_weights
    paths = export_checkpoint_dir(model, str(tmp_path), 0.3, 12.0,
                                  CFG.height, CFG.width)
    assert [os.path.basename(p) for p in paths] == [
        f"{n}.pth" for n in ("encoder", "depth", "mono_encoder", "mono_depth",
                             "pose_encoder", "pose")]
    enc = torch.load(tmp_path / "encoder.pth", weights_only=True)
    assert type(enc["min_depth_bin"]) is float and enc["height"] == CFG.height
    assert not torch.load(tmp_path / "mono_encoder.pth",
                          weights_only=True)["encoder.fc.weight"].any()
    got_p, got_s, extras = convert_mal_checkpoint_dir(str(tmp_path))
    for want, got in ((params, got_p), (stats, got_s)):
        want, got = dict(leaves(want)), dict(leaves(got))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert float(extras["min_depth_bin"]) == np.float32(0.3)
    assert float(extras["max_depth_bin"]) == 12.0


# ---------------------------------------------------------------------------
# Mask2Former .pkl
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_weights():
    """Random `mal_tpu` variables of a small Swin-T Mask2Former (shapes from
    `jax.eval_shape`, nothing compiled) and the port's model."""
    jmodel = JMask2Former(num_classes=5, swin_size="tiny", num_queries=8)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 96, 3)))
    rng = np.random.RandomState(0)
    variables = jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    port = Mask2Former(num_classes=5, swin_size="tiny", num_queries=8,
                       device="cpu", init_weights=False)
    return variables, port


def test_mask2former_pkl_from_mal_tpu(seg_weights, tmp_path):
    variables, port = seg_weights
    path = j_export_pkl(variables, str(tmp_path / "m.pkl"), size="tiny")
    want = copy.deepcopy(port)
    load_jax_mask2former(want, variables)
    load_mask2former_pkl(port, path)
    _same(port.state_dict(), want.state_dict())


def test_mask2former_pkl_to_mal_tpu(seg_weights, tmp_path):
    variables, port = seg_weights
    load_jax_mask2former(port, variables)
    path = export_mask2former_pkl(port, str(tmp_path / "m.pkl"))
    got = dict(leaves(convert_mask2former_pkl(path, size="tiny")["params"]))
    want = dict(leaves(variables["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_mask2former_pkl_is_strict(seg_weights, tmp_path):
    _, port = seg_weights
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    key = "sem_seg_head.predictor.class_embed.bias"
    for change, match in (({"criterion.empty_weight": np.ones(6)}, None),
                          ({"stray.weight": np.ones(1)}, "stray"),
                          ({key: None}, "class_embed")):
        sd2 = {**sd, **change}
        sd2 = {k: v for k, v in sd2.items() if v is not None}
        path = str(tmp_path / "m.pkl")
        import pickle
        with open(path, "wb") as f:
            pickle.dump({"model": sd2}, f)
        assert set(load_pkl(path)) == set(sd2)
        if match is None:
            load_mask2former_pkl(port, path)
        else:
            with pytest.raises(KeyError, match=match):
                load_mask2former_pkl(port, path)


# ---------------------------------------------------------------------------
# ImageNet trunks
# ---------------------------------------------------------------------------

def test_load_imagenet_against_convert_imagenet_trunk(flax_weights, tmp_path):
    _, _, base = flax_weights
    rng = np.random.RandomState(5)
    trunk = {k[len("encoder."):]: v for k, v in base.mono_encoder.state_dict().items()}
    sd = {k: rng.randn(*v.shape).astype(np.float32) if v.is_floating_point()
          else v.numpy() for k, v in trunk.items()}
    sd["fc.weight"] = rng.randn(1000, 512).astype(np.float32)
    sd["fc.bias"] = rng.randn(1000).astype(np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "resnet18.pth")

    model = copy.deepcopy(base)
    before = _weights(model)
    load_imagenet_trunks(model, torch.load(tmp_path / "resnet18.pth",
                                           weights_only=True))
    params, stats = {}, {}
    for net, n_images in (("encoder", 1), ("mono_encoder", 1),
                          ("pose_encoder", 2)):
        tp, ts = convert_imagenet_trunk(sd, 18, n_images)
        params[net], stats[net] = {"encoder": tp}, {"encoder": ts}
    want = {k: torch.from_numpy(v)
            for k, v in flax_to_state_dict(params, stats).items()}
    got = _weights(model)
    _same(got, want)
    rest = [k for k in got if k not in want]
    assert rest and all(k.split(".")[0] in ("depth", "mono_depth", "pose")
                        or k.startswith("encoder.reduce_conv") for k in rest)
    _same(got, before, rest)


# ---------------------------------------------------------------------------
# The step schedule and gradient clipping against optax
# ---------------------------------------------------------------------------

def test_step_schedule():
    cfg = CFG.replace(lr_scheduler="step", learning_rate=2e-4,
                      scheduler_step_size=2, steps_per_epoch=3)
    want = j_step_lr(2e-4, 2, 3)
    got = make_schedule(torch_cfg(cfg))
    for step in range(0, 40, 1):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-7,
                                   atol=0, err_msg=str(step))
    with pytest.raises(ValueError, match="steps_per_epoch"):
        make_schedule(torch_cfg(cfg.replace(steps_per_epoch=0)))
    with pytest.raises(NotImplementedError, match="cos"):
        make_schedule(torch_cfg(cfg.replace(lr_scheduler="cos")))


@pytest.mark.parametrize("freeze", [False, True],
                         ids=["all_train", "freeze_teacher_and_pose"])
def test_grad_clip_and_step_schedule_match_optax(freeze):
    """Four updates under the `step` schedule with `grad_clip_norm`: two
    whose gradients' global norm is above the limit (clipped), one below,
    and one with non-finite entries. With `freeze_teacher_and_pose` the
    frozen nets stay put, and the norm covers only the nets that train, as
    `mal_tpu`'s `multi_transform` around the whole chain gives. Tolerance
    as `tests/test_torch_optimizer.py`: 1e-6 on weights of ~0.5."""
    cfg = CFG.replace(lr_scheduler="step", learning_rate=1e-2,
                      scheduler_step_size=1, steps_per_epoch=2,
                      grad_clip_norm=1.5, freeze_teacher_and_pose=freeze)
    rng = np.random.RandomState(0)
    shapes = {"encoder": (4, 5), "depth": (7,), "mono_encoder": (3, 3),
              "pose": (6,)}
    params = {k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = []
    for scale in (1.0, 3.0, 0.01, 1.0):
        grads.append({k: (scale * rng.normal(0, 1, s)).astype(np.float32)
                      for k, s in shapes.items()})
    grads[3]["encoder"][1, 2] = np.nan
    grads[3]["mono_encoder"][0, 0] = np.inf

    tx = j_make_optimizer(cfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    tcfg = torch_cfg(cfg)
    optimizer = make_optimizer(tcfg, module)
    schedule = make_schedule(tcfg)
    norms = []
    for step, g in enumerate(grads):
        trained = [v for k, v in g.items()
                   if not (freeze and k in ("mono_encoder", "pose"))]
        norms.append(math.sqrt(sum(float(np.sum(np.nan_to_num(
            v, posinf=0.0, neginf=0.0) ** 2)) for v in trained)))
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        apply_gradients(optimizer, schedule(step), tcfg.grad_clip_norm)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6, err_msg=f"{k} {step}")
    assert norms[1] > 1.5 > norms[2]
    if freeze:
        for k in ("mono_encoder", "pose"):
            np.testing.assert_array_equal(module[k].detach().numpy(), params[k])
