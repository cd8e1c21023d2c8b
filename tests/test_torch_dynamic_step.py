"""The DynamicDepth slice of the port against `mal_tpu`'s, on the CPU at
`tests/test_dynamic_model.py`'s size: 64x96, D = 16, B = 2, `cv_min`,
`cv_set_1`, `cv_pool_th` 0.15.

Both packages start from the same weights (random draws on the flax tree's
shapes, carried by `load_jax_dynamic_variables`), see the same numpy batch
with dynamic-object masks, and the same random draws: the matching
augmentation's uniform and the automask noise are drawn in JAX from the
step's key, as `mal_tpu` draws them, and handed to the port. Checked: the
weight loader against `export_dynamic_checkpoint_dir`; the model's outputs;
one training step with `selec_reproj`, `zero_img` and the feature-metric
loss on, the reference's own defaults (loss, metrics, every sub-network's
gradient, the post-step parameters, BN statistics and bins); and one step
in fast mode, with those options off as `benchmarks/bench_methods.py` runs,
at `tests/test_torch_fast_step.py`'s bounds.

`mal_tpu` on the CPU builds the volume with its XLA twin, the port with
K6's plain version: they agree to ~2e-5, and the DOMD splats to the pixel
(tests/test_torch_dynamic_warp.py). Per-pixel selections whose two sides
are that close (the cost-volume argmin, the automask, min reprojection,
the distillation argmin) can pick the other side in one package, so the
bounds are those of tests/test_torch_train_step.py, with the measured
distances beside them.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.config import TRAIN_FAST_SETTINGS
from mal_tpu.config import Config as JConfig
from mal_tpu.convert.export_pth import export_dynamic_checkpoint_dir
from mal_tpu.dynamic.model import DynDepthModel as JDynModel
from mal_tpu.dynamic.step import make_dynamic_loss_fn as jax_loss_fn
from mal_tpu.dynamic.step import make_dynamic_train_step as jax_train_step
from mal_tpu.losses import LossBalancerState as JBalancer
from mal_tpu.train.state import DepthBinTracker as JBins
from mal_tpu.train.state import TrainState as JState
from mal_tpu.train.state import make_optimizer as jax_make_optimizer
from mal_tpu_torch.convert.jax_params import (flax_to_state_dict,
                                              load_jax_dynamic_variables,
                                              nest_dynamic_tree)
from mal_tpu_torch.dynamic.model import DynDepthModel, doj_metrics
from mal_tpu_torch.dynamic.step import make_dynamic_loss_fn
from mal_tpu_torch.losses import LossBalancerState
from mal_tpu_torch.train.state import (DepthBinTracker, TrainState,
                                       create_train_state, make_optimizer)
from mal_tpu_torch.train.step import make_train_step

from test_torch_common import (END_TO_END, as_f32, np_batch,
                               random_mal_variables, run_jitted, to_jax,
                               to_numpy, to_torch, torch_cfg)
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

CFG = JConfig(height=64, width=96, num_depth_bins=16, batch_size=2,
              method="dynamicdepth", cv_min=True, cv_set_1=True,
              cv_pool_th=0.15, loss_blc=False, use_ensemble=False)
B, H, W = CFG.batch_size, CFG.height, CFG.width
# the training step runs with what the reference's own defaults turn on
# (PARITY.md:196-201): `selec_reproj`, `zero_img`, and the feature-metric
# loss with them
STEP_CFG = CFG.replace(selec_reproj=True, zero_img=True, feat_loss=True)
KEY = jax.random.PRNGKey(2)
# a step's gradient per sub-network: as tests/test_torch_train_step.py
GRAD_RTOL = 3e-2
# what depends on per-pixel selections (see the module docstring)
LOSS_RTOL = 1e-3


def _batch():
    """np_batch with `tests/test_dynamic_model.py`'s dynamic-object masks."""
    batch = np_batch(CFG, seed=0, batch_size=B)
    doj = np.zeros((B, H, W), np.float32)
    doj[:, 20:40, 30:60] = 1.0
    batch["doj_mask"] = doj
    batch["doj_mask-1"] = np.roll(doj, -4, axis=2)
    batch["doj_mask+1"] = np.roll(doj, 4, axis=2)
    return batch


def _draws(key):
    """The draws `mal_tpu`'s step makes from its key, as port inputs."""
    rng_model, rng_noise = jax.random.split(key)
    return {"matching_aug": torch.from_numpy(np.array(
                jax.random.uniform(rng_model, (B,)))),
            "automask_noise": torch.from_numpy(np.array(jax.random.normal(
                rng_noise, (B, H, W, 1), jnp.float32))).reshape(B, 1, H, W)}


@functools.lru_cache(maxsize=None)
def _blank_model(cfg):
    return DynDepthModel(torch_cfg(cfg), device="cpu", init_weights=False)


def _port_model(cfg, params, stats):
    """The port's model carrying the flax weights: a copy of one built per
    config without drawing its weights (seconds): the strict load
    overwrites every one."""
    model = copy.deepcopy(_blank_model(cfg))
    load_jax_dynamic_variables(model, params, stats)
    return model


@pytest.fixture(scope="module")
def setup():
    batch = _batch()
    params, stats = random_mal_variables(CFG)
    return batch, params, stats, _port_model(CFG, params, stats)


def _grads_by_net(grads: dict) -> dict:
    """{sub-network: {name: grad}} in the port's names."""
    out: dict = {}
    for name, g in grads.items():
        out.setdefault(name.split(".")[0], {})[name] = g
    return out


def _assert_grads(got: dict, want: dict, rtol: float = GRAD_RTOL):
    """Per sub-network: the gradient within `rtol` in relative L2, and every
    entry within `rtol` of the sub-network's largest entry."""
    assert set(got) == set(want)
    for net, names in _grads_by_net(want).items():
        scale = max(np.abs(g).max() for g in names.values())
        err2 = sum(((got[n] - g) ** 2).sum() for n, g in names.items())
        norm2 = sum((g ** 2).sum() for g in names.values())
        assert norm2 > 0, net
        assert np.sqrt(err2 / norm2) <= rtol, (net, np.sqrt(err2 / norm2))
        for n, g in names.items():
            assert np.abs(got[n] - g).max() <= rtol * scale, n


def test_weights_carry_the_reference_layout(setup, tmp_path):
    """`load_jax_dynamic_variables` fills every port tensor from a flax leaf
    (it raises otherwise), and the port's names are those that
    `export_dynamic_checkpoint_dir` writes into the reference's per-net
    `.pth` files, with the same values."""
    _, params, stats, model = setup
    export_dynamic_checkpoint_dir(params, stats, str(tmp_path))
    port = {k: v.numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    exported = {}
    for net in ("encoder", "depth", "mono_encoder", "mono_depth",
                "pose_encoder", "pose"):
        for k, v in torch.load(tmp_path / f"{net}.pth").items():
            # torchvision's frozen head and BN step counters: no flax leaf
            if not (k.startswith("encoder.fc.")
                    or k.endswith("num_batches_tracked")):
                exported[f"{net}.{k}"] = v.numpy()
    assert set(port) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(port[k], v, err_msg=k)
    # every flax leaf has its own port tensor
    n_leaves = len(jax.tree_util.tree_leaves((params, stats)))
    assert len(flax_to_state_dict(*nest_dynamic_tree(params, stats))) \
        == n_leaves == len(port)


@pytest.fixture(scope="module")
def forward(setup):
    """Both models' training forward (train=True, with the step's matching
    draw) and eval forward (`dynamic/evaluate.py:108-116`) on the batch."""
    batch, params, stats, model = setup
    jmodel = JDynModel(CFG)
    rng_model, _ = jax.random.split(KEY)

    def run(p, s, b):
        train, _ = jmodel.apply({"params": p, "batch_stats": s}, b,
                                jnp.asarray(0.1), jnp.asarray(10.0),
                                rng_model, train=True, mutable=["batch_stats"])
        ev = jmodel.apply({"params": p, "batch_stats": s}, b,
                          jnp.asarray(0.1), jnp.asarray(10.0), rng_model,
                          train=False, is_train_phase=False, mutable=False)
        return train, ev

    want = to_numpy(run_jitted(run, params, stats, to_jax(batch)))
    tb = to_torch(batch)
    with torch.no_grad():   # on a copy: the training forward moves the BN EMA
        train = copy.deepcopy(model)(tb, torch.tensor(0.1), torch.tensor(10.0),
                                     aug_draw=_draws(KEY)["matching_aug"])
    ev = copy.deepcopy(model).eval_forward(tb, torch.tensor(0.1),
                                           torch.tensor(10.0))
    got = [{k: v.numpy() for k, v in out.items()} for out in (train, ev)]
    return got, want


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_model_outputs(forward, mode):
    """The disparities at 1e-4 (relative to their largest value); the DOMD
    colour frames with at most 1e-3 of the values off by more than 1e-4;
    the argmin-cost disparity and the consistency mask with at most 1e-2 of
    the pixels different: a cost-volume argmin whose two best planes lie
    within the twins' ~2e-5 picks the other plane in one package (measured
    here: none)."""
    got, want = forward
    i = ("train", "eval").index(mode)
    got, want = got[i], want[i]
    for k in ("disp", "mono_disp"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
    for k in ("domd_color/-1", "domd_color/1"):
        off = np.abs(got[k] - want[k]) > 1e-4
        assert off.mean() <= 1e-3, (k, off.mean())
    assert not np.array_equal(want["domd_color/-1"],
                              want["domd_color/1"])
    for k in ("lowest_cost", "consistency_mask"):
        assert got[k].shape == want[k].shape == (B, H, W)
        off = np.abs(got[k] - want[k]) > 1e-5 * np.abs(want[k]).max()
        assert off.mean() <= 1e-2, (k, off.mean())


@pytest.fixture(scope="module")
def step(setup):
    """One `make_dynamic_train_step` at STEP_CFG in each package from the
    same state: mal_tpu's metrics, parameters, BN statistics, bins and its
    gradients (from Adam's first moment, 0.1 g after one step); the port's
    metrics, gradients, state dict and bins."""
    batch, params, stats, model = setup
    tx = jax_make_optimizer(STEP_CFG)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=jparams,
                    batch_stats=jax.tree.map(jnp.asarray, stats),
                    opt_state=tx.init(jparams), bins=JBins.create(),
                    balancer=JBalancer.create())
    jstate, jm = run_jitted(
        jax_train_step(STEP_CFG, JDynModel(STEP_CFG), tx), jstate,
        to_jax(batch), KEY, jnp.zeros(()))
    mu = jstate.opt_state[1][0].mu
    want = {"metrics": to_numpy(jm),
            "grads": {k: v / 0.1 for k, v in flax_to_state_dict(
                *nest_dynamic_tree(to_numpy(mu), {})).items()},
            "state": flax_to_state_dict(*nest_dynamic_tree(
                to_numpy(jstate.params), to_numpy(jstate.batch_stats))),
            "bins": to_numpy(jstate.bins)}

    cfg = torch_cfg(STEP_CFG)
    tmodel = copy.deepcopy(model)
    tstate = TrainState(step=0, model=tmodel,
                        optimizer=make_optimizer(cfg, tmodel),
                        bins=DepthBinTracker.create(),
                        balancer=LossBalancerState.create())
    tstate, tm = make_train_step(cfg, device="cpu")(
        tstate, to_torch(batch), 0.0, draws=_draws(KEY))
    got = {"metrics": {k: v.numpy() for k, v in tm.items()},
           "grads": {n: p.grad.numpy().copy()
                     for n, p in tstate.model.named_parameters()},
           "state": {k: v.numpy() for k, v in
                     tstate.model.state_dict().items()},
           "bins": tstate.bins}
    return got, want


def test_step_loss_and_metrics(step):
    """Every metric within LOSS_RTOL (1e-3) of `mal_tpu`'s; the
    feature-metric term is on."""
    got, want = step
    for k in ("loss", "mono_reproj", "multi_reproj", "consistency_loss",
              "distil_loss", "feat_loss"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert np.isfinite(got["metrics"]["loss"])
    assert want["metrics"]["feat_loss"] != 0


def test_step_every_gradient(step):
    got, want = step
    _assert_grads(got["grads"], want["grads"])


def test_step_params_stats_and_bins(step):
    """Post-step parameters within two Adam moves of the first step's
    learning rate (1e-10; tests/test_torch_train_step.py says why), BN
    statistics at 1e-4, the bins at 1e-5: they follow the teacher's depth
    (the teacher trains by default)."""
    got, want = step
    for name, w_ in want["state"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][name], w_, rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got["state"][name], w_, rtol=0,
                                       atol=5e-7, err_msg=name)
    jb, tb = want["bins"], got["bins"]
    np.testing.assert_allclose(tb.min_depth.numpy(), jb.min_depth, rtol=1e-5)
    np.testing.assert_allclose(tb.max_depth.numpy(), jb.max_depth, rtol=1e-5)
    assert bool(tb.updated) and bool(jb.updated)


def _loss_and_grads(cfg, params, stats, batch, port_only=False):
    """`mal_tpu`'s loss and gradients at `cfg` (one jitted function), and
    the port's from the same weights, batch and draws (with `port_only`,
    the port's alone)."""
    model = _port_model(cfg, params, stats)
    draws = _draws(KEY)
    loss, aux = make_dynamic_loss_fn(torch_cfg(cfg), model)(
        to_torch(batch), torch.tensor(0.1), torch.tensor(10.0),
        aug_draw=draws["matching_aug"], noise=draws["automask_noise"])
    loss.backward()
    got = {"loss": float(loss.detach()),
           "metrics": {k: v.numpy() for k, v in aux["metrics"].items()},
           "grads": {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}}
    if port_only:
        return got
    rng_model, rng_noise = jax.random.split(KEY)
    jloss = jax_loss_fn(cfg, JDynModel(cfg))

    def total(p, s, b):
        loss, aux = jloss(p, s, jnp.asarray(0.1), jnp.asarray(10.0), b,
                          rng_model, rng_noise)
        return loss, aux["metrics"]

    (loss, metrics), grads = run_jitted(
        jax.value_and_grad(total, has_aux=True), params, stats, to_jax(batch))
    want = {"loss": float(loss), "metrics": to_numpy(metrics),
            "grads": flax_to_state_dict(*nest_dynamic_tree(
                to_numpy(grads), {}))}
    return got, want


def test_fast_mode_step(setup):
    """One step in fast mode (`**TRAIN_FAST_SETTINGS`: bf16 nets, an fp32
    volume), held as tests/test_torch_fast_step.py holds the fast ManyDepth
    step: the losses within 5e-3 of each other and within `END_TO_END`
    times the distance of `mal_tpu`'s bf16 loss from the port's fp32 one;
    each sub-network's gradient within 1.25 radians of `mal_tpu`'s and
    within `END_TO_END` times the angle between `mal_tpu`'s bf16 gradient
    and the fp32 one.

    The DOMD warp is off here (`no_warp`), and a black patch in frame -1
    makes K6's substitution fire instead. The splat truncates the teacher's
    projected depth to a pixel: a step function that turns bf16's ~1e-3
    depth noise into whole pixels moved, which two bf16 runs do not share.
    With the warp on, at this seed, the DOMD frames of the two bf16 runs lie
    1.7x as far apart as `mal_tpu`'s bf16 frames from the fp32 ones, and the
    gradients up to 2.0x (measured; 1.0-1.46x for the fast ManyDepth step at
    this size). The fp32 cases above hold the warp itself."""
    batch, params, stats, _ = setup
    batch = copy.deepcopy(batch)
    for key in ("color", "color_aug"):
        batch[key]["-1"][:, 20:40, 26:56] = 0.0
    cfg = CFG.replace(no_warp=True)
    got, want = _loss_and_grads(cfg.replace(**TRAIN_FAST_SETTINGS), params,
                                stats, batch)
    exact = _loss_and_grads(cfg, params, stats, batch, port_only=True)
    assert abs(got["loss"] - want["loss"]) <= 5e-3 * abs(want["loss"])
    assert abs(want["loss"] - exact["loss"]) > 0
    assert abs(got["loss"] - want["loss"]) <= END_TO_END * abs(
        want["loss"] - exact["loss"])

    def angle(a, b, names):
        va = np.concatenate([a[n].ravel().astype(np.float64) for n in names])
        vb = np.concatenate([b[n].ravel().astype(np.float64) for n in names])
        cos = va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb))
        return float(np.arccos(np.clip(cos, -1.0, 1.0)))

    for net, names in _grads_by_net(want["grads"]).items():
        ours = angle(got["grads"], want["grads"], names)
        modes = angle(want["grads"], exact["grads"], names)
        assert modes > 0, net
        assert ours <= 1.25 and ours <= END_TO_END * modes, (net, ours, modes)


def test_doj_metrics():
    """`doj_metrics` against `mal_tpu`'s on random depths and a mask."""
    from mal_tpu.dynamic.model import doj_metrics as jax_doj_metrics

    rng = np.random.RandomState(4)
    gt = rng.uniform(0.5, 90.0, (2, 8, 8)).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.4, gt.shape)).astype(np.float32)
    doj = (rng.uniform(0, 1, gt.shape) > 0.5).astype(np.float32)
    want = jax_doj_metrics(*map(jnp.asarray, (pred, gt, doj)))
    got = doj_metrics(*map(torch.from_numpy, (pred, gt, doj)))
    for k, v in want.items():
        np.testing.assert_allclose(as_f32(got[k]), as_f32(v), rtol=1e-5,
                                   err_msg=k)


def test_entry_points_and_options(monkeypatch):
    """`make_train_step` gives the DynamicDepth step for its method, and
    `create_train_state` its model; `online_doj` is refused without the
    `doj_fn` that makes its masks (tests/test_torch_doj.py runs it);
    `train_teacher_only` leaves the
    student (`encoder`, with its `reduce_conv`, and `depth`) out of the
    optimizer; without CUDA the entry points raise unless given the CPU."""
    from mal_tpu_torch.dynamic.step import make_dynamic_train_step
    from mal_tpu_torch.train.state import trainable_parameters

    cfg = torch_cfg(CFG)
    state = create_train_state(cfg, device="cpu", init_weights=False)
    assert isinstance(state.model, DynDepthModel)
    assert callable(make_train_step(cfg, device="cpu"))
    with pytest.raises(ValueError, match="doj"):
        make_train_step(cfg.replace(online_doj=True), device="cpu")
    kept = {id(p) for p in trainable_parameters(
        cfg.replace(train_teacher_only=True), state.model)}
    for name, p in state.model.named_parameters():
        assert (id(p) in kept) == (name.split(".")[0] not in ("encoder",
                                                             "depth")), name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (DynDepthModel, create_train_state, make_dynamic_train_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(cfg)
