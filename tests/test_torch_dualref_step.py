"""DualRefine in the port against `mal_tpu`, on the CPU at 64x96, batch 2,
frames (0, -1, 1), Anderson with 4 evaluations (so that the mixing runs:
at `mal_tpu`'s own test value of 2 it never does), corr radius 2 over 2
levels.

Both packages start from the same weights (random draws on the flax
tree's shapes, carried by `load_jax_dualref_variables`), see the same numpy
batch and the same automask draws, made in JAX from the step's key as
`mal_tpu` makes them. One jitted `mal_tpu` function gives the training
loss, its metrics, every gradient, the BN statistics after the training
forward and that forward's outputs (captured around `model.apply`).

The step runs in float64 in both packages (`jax.enable_x64`; the port's
model and batch in double). In float32 the gradient of HRNet's 150
train-mode BatchNorms is ill-conditioned: against a float64 reference,
`mal_tpu`'s float32 gradient of the trunk is 1.9e-2 off in relative L2 and
the port's 2e-3 (measured here), so two float32 runs cannot be held to the
ManyDepth step tests' 1.5e-2. In float64 they agree to 3e-5, what is left
of the casts to float32 that `mal_tpu` keeps at the trunk's taps and the
pose features (`mal_tpu/dualref/model.py:163,215`). The eval forward runs
in float32 in both, on the batch statistics of the training forward
(recovered from the EMA) in the HRNet and the uncertainty head, so that its
disparities are not saturated.

Tolerances: float64: losses and metrics at 1e-6 relative, each
sub-network's gradient at 1e-3 relative L2 (measured at most 2.2e-4, the
pose net's), outputs at 1e-5 of their largest value, BN statistics and
bins at 1e-6; float32 (eval): disparities at 1e-4 of their largest value,
poses at 1e-5; the consistency mask with at most 1e-3 of its pixels
different (an argmin over 96 bins whose two best costs tie within rounding
may pick the other).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.config import Config as JConfig
from mal_tpu.dualref.model import DEQDepthPose as JModel
from mal_tpu.dualref.step import make_dualref_loss_fn as jax_loss_fn
from mal_tpu.train.state import DepthBinTracker as JBins
from mal_tpu_torch.config import TRAIN_FAST_SETTINGS
from mal_tpu_torch.convert.dualref import (export_depth_pose,
                                           load_jax_dualref_variables)
from mal_tpu_torch.dualref.model import DEQDepthPose
from mal_tpu_torch.dualref.step import noise_keys
from mal_tpu_torch.train.state import (DepthBinTracker, TrainState,
                                       create_train_state, make_optimizer)
from mal_tpu_torch.train.step import check_supported, make_train_step
from mal_tpu_torch.losses import LossBalancerState

from test_torch_common import (nchw, np_batch, random_tree, run_jitted,
                               to_jax, to_numpy, to_torch, torch_cfg)

CFG = JConfig(method="dualrefine", height=64, width=96, batch_size=2,
              deq_iters=4, corr_radius=2, corr_levels=2)
B, H, W = CFG.batch_size, CFG.height, CFG.width
KEY = jax.random.PRNGKey(3)
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-3
OUT_RTOL = {"float64": 1e-5, "float32": 1e-4}
# the nets whose train-mode batch statistics the eval forward reads (the
# pose trunks run twice in a training forward, so theirs are not recovered)
CALIBRATED = ("cnet", "pose_weights")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_data.py says why."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def dualref_variables(seed: int = 0):
    """Random (params, batch_stats) on `mal_tpu`'s DEQDepthPose tree, from
    `jax.eval_shape` of the cheapest init that builds the same tree (plain
    iteration, one step, eval mode): no initialiser runs."""
    cfg = CFG.replace(deq_solver="iteration", deq_iters=1)
    b = to_jax(np_batch(CFG, 0, batch_size=1))
    shapes = jax.eval_shape(lambda r: JModel(cfg).init(
        {"params": r}, b["color_aug"]["0"], b["color_aug"]["-1"], b["K"],
        invert=True, train=False), jax.random.PRNGKey(0))
    tree = random_tree(shapes, seed)
    return tree["params"], tree["batch_stats"]


@functools.lru_cache(maxsize=None)
def _blank(cfg):
    return DEQDepthPose(torch_cfg(cfg), device="cpu", init_weights=False)


def port_model(cfg, params, stats) -> DEQDepthPose:
    model = copy.deepcopy(_blank(cfg))
    load_jax_dualref_variables(model, params, stats)
    return model


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def noise_draws(cfg, key) -> dict:
    """The automask draws of `mal_tpu`'s loss (`dualref/step.py:121,193`)
    in float64, as the port's `noise` (standard normal, (B, 1, H, W))."""
    out = {}
    with jax.enable_x64():
        for name in noise_keys(torch_cfg(cfg)):
            fold = 99 if name == "pose" else 10 * int(name[1]) + int(name[-1])
            n = jax.random.normal(jax.random.fold_in(key, fold),
                                  (B, H, W, 1), jnp.float64)
            out[name] = torch.from_numpy(nchw(n).copy())
    return out


class _Capture:
    """`model` whose `apply` also records its outputs in `stash`."""

    def __init__(self, model, stash):
        self.model, self.stash = model, stash

    def apply(self, *args, **kwargs):
        out = self.model.apply(*args, **kwargs)
        self.stash["out"] = out[0]
        return out


def jax_step(cfg, params, stats, batch, key) -> dict:
    """`mal_tpu`'s loss at `cfg` in float64, its metrics and gradients, the
    BN statistics after the forward and the forward's outputs, in one
    jitted function (numpy out)."""
    model = JModel(cfg)

    def fn(p, s, b, k):
        stash = {}

        def loss(p):
            total, aux = jax_loss_fn(cfg, _Capture(model, stash))(p, s, b, k)
            return total, (aux, stash["out"])

        (total, (aux, out)), grads = jax.value_and_grad(
            loss, has_aux=True)(p)
        return {"loss": total, "metrics": aux["metrics"], "grads": grads,
                "stats": aux["batch_stats"], "depth0": aux["depth0"],
                "out": out}

    with jax.enable_x64():
        return to_numpy(run_jitted(fn, f64(params), f64(stats),
                                   to_jax(f64(batch)), key))


def recovered_stats(stats: dict, after: dict) -> dict:
    """The batch statistics of one training forward, from the running
    statistics before (`stats`) and after it (momentum 0.9), in the nets
    of `CALIBRATED` (float32)."""
    out = dict(stats)
    for net in CALIBRATED:
        out[net] = jax.tree.map(
            lambda n, o: np.asarray((n - 0.9 * o) / 0.1, np.float32),
            after[net], stats[net])
    return out


def jax_eval(cfg, params, stats, batch):
    """`mal_tpu`'s eval forward in float32 (numpy out)."""
    model = JModel(cfg)
    return to_numpy(run_jitted(lambda p, s, b: model.apply(
        {"params": p, "batch_stats": s}, b["color"]["0"], b["color"]["-1"],
        b["K"], invert=True, train=False, mutable=False),
        params, stats, to_jax(batch)))


def to_double(batch: dict) -> dict:
    return {k: ({f: v.double() for f, v in x.items()} if isinstance(x, dict)
                else x.double()) for k, x in to_torch(batch).items()}


def close(got, want, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def assert_outputs(got: dict, want: dict, what: str):
    """Disparities, the consistency mask and `pose_p1` (NHWC `want`), at
    the tolerances of `want`'s type."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    rel = OUT_RTOL[str(np.asarray(want["disp_0_0"]).dtype)]
    for k, w in want.items():
        if k == "consistency_mask":
            off = got[k].numpy() != nchw(w)
            assert off.mean() <= 1e-3, (what, k, off.mean())
        elif k == "pose_p1":
            close(got[k], w, 1e-5, f"{what} {k}")
        else:
            close(got[k], nchw(w), rel, f"{what} {k}")


def grads_by_net(grads: dict) -> dict:
    """{sub-network: {name: grad}}: the trunk's stages and the pose nets
    each their own."""
    out: dict = {}
    for name, g in grads.items():
        parts = name.split(".")
        net = ".".join(parts[:2]) if parts[0] == "pnets" else parts[0]
        out.setdefault(net, {})[name] = g
    return out


def assert_grads(got: dict, want: dict, rtol: float = GRAD_RTOL):
    """Per sub-network: relative L2 within `rtol`, or both exactly 0 (the
    pose nets of the sides no sample has)."""
    assert set(got) == set(want)
    for net, names in grads_by_net(want).items():
        norm2 = sum((g.astype(np.float64) ** 2).sum() for g in names.values())
        err2 = sum(((got[n] - g).astype(np.float64) ** 2).sum()
                   for n, g in names.items())
        if norm2 == 0:
            assert err2 == 0, net
            continue
        assert np.sqrt(err2 / norm2) <= rtol, (net, np.sqrt(err2 / norm2))


@pytest.fixture(scope="module")
def setup():
    batch = np_batch(CFG, seed=0, batch_size=B)
    params, stats = dualref_variables()
    return batch, params, stats


@pytest.fixture(scope="module")
def step(setup):
    """One float64 step in each package from the same state and draws:
    `mal_tpu`'s results (`jax_step`), the port's through `make_train_step`
    with its training forward's outputs; then both eval forwards in float32
    on the same recovered statistics."""
    batch, params, stats = setup
    want = jax_step(CFG, params, stats, batch, KEY)

    cfg = torch_cfg(CFG)
    model = port_model(CFG, params, stats).double()
    stash = {}
    hook = model.register_forward_hook(
        lambda m, i, o: stash.setdefault("out", o))
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(cfg, model),
                       bins=DepthBinTracker.create(),
                       balancer=LossBalancerState.create())
    state, metrics = make_train_step(cfg, "cpu")(
        state, to_double(batch), draws={"automask_noise":
                                        noise_draws(CFG, KEY)})
    hook.remove()
    out, poses = stash["out"]
    got = {"metrics": {k: v.numpy() for k, v in metrics.items()},
           "grads": {n: (np.zeros(p.shape) if p.grad is None
                         else p.grad.numpy().copy())
                     for n, p in model.named_parameters()},
           "state": {k: v.numpy() for k, v in model.state_dict().items()},
           "bins": state.bins,
           "out": {k: v.detach() for k, v in out.items()},
           "poses": [p.detach() for p in poses]}

    calib = recovered_stats(stats, want["stats"])
    want["eval"] = jax_eval(CFG, params, calib, batch)
    ev_model = port_model(CFG, params, calib)
    color = {f: torch.from_numpy(nchw(c)) for f, c in batch["color"].items()}
    with torch.no_grad():
        ev_out, ev_poses = ev_model(color["0"], color["-1"],
                                    torch.from_numpy(batch["K"]),
                                    invert=True, train=False)
    got["eval"] = (ev_out, ev_poses)
    return got, want


def test_train_forward(step):
    """The training forward's outputs: the initial disparities at four
    scales, the phantom state's, the consistency mask (read at the initial
    depth), T0, T* and the frame +1 pose."""
    got, want = step
    out, (pose0, pose_star) = want["out"]
    assert np.asarray(out["disp_0_0"]).dtype == np.float64
    assert "disp_0_1" in out and "disp_2_1" in out and "pose_p1" in out
    assert_outputs(got["out"], out, "train")
    close(got["poses"][0], pose0, 1e-5, "T0")
    close(got["poses"][1], pose_star, 1e-5, "T*")
    assert np.abs(np.asarray(pose_star) - np.asarray(pose0)).max() > 0


def test_eval_forward(step):
    """The eval forward (int(deq_iters * deq_eval_factor) iterations, the
    refined disparity blended with the initial through the mask)."""
    got, want = step
    out, (pose0, pose_star) = want["eval"]
    assert np.asarray(out["disp_0_0"]).dtype == np.float32
    g_out, g_poses = got["eval"]
    assert_outputs(g_out, out, "eval")
    close(g_poses[0], pose0, 1e-5, "T0")
    close(g_poses[1], pose_star, 1e-5, "T*")
    # not saturated: the recovered statistics keep the sigmoid in range
    d = np.asarray(out["disp_0_1"])
    assert 0.05 < d.mean() < 0.95 and d.std() > 1e-3
    m = np.asarray(out["consistency_mask"])
    assert 0 < m.mean() < 1


def test_step_loss_and_metrics(step):
    got, want = step
    for k in ("loss", "pose_loss", "reproj_0", "reproj_1",
              "consistency_loss"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["metrics"]["loss"], want["loss"],
                               rtol=LOSS_RTOL)
    assert want["metrics"]["pose_loss"] > 0
    assert want["metrics"]["consistency_loss"] > 0


def test_step_every_gradient(step):
    """Every parameter's gradient, per sub-network: the trunk's stem and
    stages, the decoder, the feature heads, the update block (through the
    phantom unroll), the pose nets and the uncertainty head."""
    got, want = step
    wg = {k: v for k, v in export_depth_pose(want["grads"], want["stats"]).items()
          if k in got["grads"]}
    assert set(wg) == set(got["grads"])
    assert_grads(got["grads"], wg)
    nets = grads_by_net(wg)
    for net in ("update_block", "pnets.0", "pose_update", "cnet_stage4",
                "reproject_2"):
        assert any(np.abs(g).max() > 0 for g in nets[net].values()), net


def test_step_bn_statistics_and_bins(step):
    """The BN running statistics after the training forward (the stem's
    pooled over both images; pose net 0's moved twice, by frame -1 and
    frame +1), and the bins with the mean and median EMAs."""
    got, want = step
    ws = export_depth_pose(want["grads"], want["stats"])
    initial = export_depth_pose(*dualref_variables())
    moved = 0
    for k, w_ in ws.items():
        if k.endswith(("running_mean", "running_var")):
            close(got["state"][k], w_, 1e-6, k)
            moved += not np.array_equal(w_, initial[k])
    assert moved > 100
    with jax.enable_x64():
        jb = to_numpy(JBins.create().update(
            jnp.asarray(want["depth0"]), CFG.min_depth, CFG.depth_bin_ema,
            track_stats=True))
    tb = got["bins"]
    for field in ("min_depth", "max_depth", "mean_depth", "median_depth"):
        np.testing.assert_allclose(getattr(tb, field).numpy(),
                                   np.asarray(getattr(jb, field)), rtol=1e-6,
                                   err_msg=field)
    assert float(tb.mean_depth) != 1.0 and float(tb.median_depth) != 1.0


def test_fast_mode_forward(setup):
    """Fast mode (`**TRAIN_FAST_SETTINGS`): the same parameter tree, bf16
    HRNet and pose-trunk convolutions, fp32 outputs near the fp32 ones."""
    batch, params, stats = setup
    fast_cfg = CFG.replace(**TRAIN_FAST_SETTINGS)
    assert fast_cfg.compute_dtype == "bfloat16"
    fast = port_model(fast_cfg, params, stats)
    exact = port_model(CFG, params, stats)
    assert ([(k, v.shape, v.dtype) for k, v in fast.state_dict().items()]
            == [(k, v.shape, v.dtype) for k, v in exact.state_dict().items()])
    seen = set()
    for name, m in fast.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(
                lambda m, i, o, name=name: seen.add((name.split(".")[0],
                                                     o.dtype)))
    color = {f: torch.from_numpy(nchw(c)) for f, c in batch["color"].items()}
    K = torch.from_numpy(batch["K"])
    with torch.no_grad():
        out, poses = fast(color["0"], color["-1"], K, invert=True)
        ref, ref_poses = exact(color["0"], color["-1"], K, invert=True)
    assert ("cnet_stage4", torch.bfloat16) in seen
    assert ("pnets", torch.bfloat16) in seen
    assert ("update_block", torch.float32) in seen
    assert ("decoder", torch.float32) in seen
    for k, v in out.items():
        if v.dtype != torch.bool:
            assert v.dtype == torch.float32 and torch.isfinite(v).all(), k
    # random weights: bf16 noise moves the saturating sigmoid's rare
    # near-threshold pixels most (max 0.15 measured); on average far less
    gap = (out["disp_0_0"] - ref["disp_0_0"]).abs()
    assert gap.mean() <= 1e-2 and gap.max() <= 0.5, (gap.mean(), gap.max())
    assert torch.isfinite(poses[1]).all()


def test_entry_points_accept_dualrefine(monkeypatch):
    """`check_supported`, `make_train_step` and `create_train_state` take
    `method="dualrefine"`; the frame pair `mal_tpu` asserts is still
    required; without CUDA the entry points raise unless given the CPU."""
    cfg = torch_cfg(CFG)
    check_supported(cfg)
    assert callable(make_train_step(cfg, device="cpu"))
    with pytest.raises(ValueError, match="frame"):
        make_train_step(cfg.replace(frame_ids=(0, 1)), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (DEQDepthPose, create_train_state, make_train_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(cfg)


def test_frozen_optimizer_trains_the_student_only(setup):
    """`make_optimizer(freeze_backbone=True)` (the Trainer's from
    `freeze_teacher_epoch`): one step moves `conv2 / context / hidden /
    update_block` and nothing else."""
    batch, params, stats = setup
    cfg = torch_cfg(CFG).replace(init_lr=1e-3)
    model = port_model(CFG, params, stats)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(cfg, model,
                                                freeze_backbone=True),
                       bins=DepthBinTracker.create(),
                       balancer=LossBalancerState.create())
    make_train_step(cfg, "cpu")(state, to_torch(batch),
                                generator=torch.Generator().manual_seed(0))
    student = ("conv2", "context", "hidden", "update_block")
    for net in student:
        assert any(not torch.equal(p, before[n])
                   for n, p in model.named_parameters()
                   if n.startswith(net + ".")), net
    for n, p in model.named_parameters():
        if not n.startswith(tuple(s + "." for s in student)):
            assert torch.equal(p, before[n]), n
