"""One and two default-config training steps of the PyTorch port against
`mal_tpu.train.step.make_train_step`, on the CPU at a small size.

Both packages start from the same flax weights (carried by
`load_jax_variables`), see the same numpy batch and the same random draws:
the matching-augmentation uniform and the automask noise are drawn with JAX
from the step's key, exactly as `mal_tpu`'s step draws them, and injected
into the port. Each step then compares the loss, every per-parameter
gradient, the post-step parameters, the BN statistics, the depth bins and
the balancer.

The two steps run the default recipe, whose learning rate (1e-10, then
2e-7) moves no weight by more than its float32 rounding; a third step,
resumed at a later count, holds the Adam update itself against optax's.

Gradients come from `mal_tpu`'s Adam state: after step 1 the first moment
is 0.1 g1, after step 2 it is 0.9 (0.1 g1) + 0.1 g2.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.models import MALModel as JaxMALModel
from mal_tpu.train.state import create_train_state as jax_create_train_state
from mal_tpu.train.state import make_optimizer as jax_make_optimizer
from mal_tpu.train.step import make_train_step as jax_make_train_step
from mal_tpu_torch.convert.jax_params import (flax_to_state_dict,
                                              load_jax_variables)
from mal_tpu_torch.config import TRAIN_FAST_SETTINGS
from mal_tpu_torch.segment.mask2former import resolve_fused_swin
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import make_train_step

from test_torch_common import (CFG, compiled, np_batch, run_jitted, to_jax,
                               to_numpy, to_torch, torch_cfg)
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

STEPS = 2
# The resumed step: count 47999 is the last before the schedule's first 10x
# decay, so the schedule read before the increment (as optax reads it) gives
# 1e-4 and read after it 1e-5. One Adam move of 1e-4 stands far above the
# weights' float32 rounding.
RESUME_COUNT = 47999
RESUME_LR = 1e-4

# The distillation target is a per-pixel argmin over reprojection errors
# that picks a *depth*: where two errors nearly tie (see
# test_every_gradient), one package may pick the other depth, and that
# pixel moves distil_loss by its depth gap over B x H x W. Measured at
# step 1: 1.1e-4 of distil_loss with one torch thread, 4e-7 with eight
# (the thread count changes the convolutions' summation order). The
# balancer carries distil_loss into its weights and the total.
DISTIL_RTOL = 1e-3
DISTIL_KEYS = ("loss", "distil_loss", "w_ori", "w_distil")


def _draws(key, B, H, W):
    """The draws `mal_tpu`'s step makes from its key (`step.py:343`,
    `mal_model.py:153`, `losses.py:218`), as port inputs."""
    rng_model, rng_noise = jax.random.split(key)
    aug = jax.random.uniform(rng_model, (B,))
    noise = jax.random.normal(rng_noise, (B, H, W, 1), jnp.float32)
    return {"matching_aug": torch.from_numpy(np.array(aug)),
            "automask_noise": torch.from_numpy(
                np.asarray(noise)).reshape(B, 1, H, W)}


def jax_initial_state(cfg, jmodel, batch):
    """`mal_tpu`'s `create_train_state` from key 0, jitted (the same values
    as op by op, in a fraction of the time)."""
    return run_jitted(lambda r, b: jax_create_train_state(cfg, jmodel, r, b),
                      jax.random.PRNGKey(0), to_jax(batch))


@pytest.fixture(scope="module")
def setup():
    """Both packages' initial states from the same weights, their steps and
    the batch. `mal_tpu`'s step is compiled once, for every call here."""
    cfg = CFG
    batch = np_batch(cfg, seed=0, batch_size=cfg.batch_size)
    jmodel = JaxMALModel(cfg)
    jstate = jax_initial_state(cfg, jmodel, batch)
    jstep = compiled(jax_make_train_step(cfg, jmodel, jax_make_optimizer(cfg)),
                     jstate, to_jax(batch), jax.random.PRNGKey(1),
                     jnp.zeros(()))
    # the port's weights are all loaded next: no draw
    tstate = create_train_state(torch_cfg(cfg), device="cpu",
                                init_weights=False)
    load_jax_variables(tstate.model, to_numpy(jstate.params),
                       to_numpy(jstate.batch_stats))
    tstep = make_train_step(torch_cfg(cfg), device="cpu")
    return jstate, jstep, tstate, tstep, batch


def _step_both(setup, jstate, tstate, i):
    """Step `i` (draws from key i + 1) in both packages."""
    _, jstep, _, tstep, batch = setup
    B, H, W = CFG.batch_size, CFG.height, CFG.width
    key = jax.random.PRNGKey(i + 1)
    jstate, jm = jstep(jstate, to_jax(batch), key, jnp.zeros(()))
    tstate, tm = tstep(tstate, to_torch(batch), 0.0,
                       draws=_draws(key, B, H, W))
    return jstate, jm, tstate, tm


def _port_state(tstate):
    return {k: v.numpy().copy() for k, v in tstate.model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(setup):
    jstate, tstate = setup[0], copy.deepcopy(setup[2])
    jax_out, port_out = [], []
    for i in range(STEPS):
        jstate, jm, tstate, tm = _step_both(setup, jstate, tstate, i)
        adam = jstate.opt_state[1][0]
        jax_out.append({
            "metrics": to_numpy(jm), "params": to_numpy(jstate.params),
            "batch_stats": to_numpy(jstate.batch_stats),
            "mu": to_numpy(adam.mu), "bins": to_numpy(jstate.bins),
            "balancer": to_numpy(jstate.balancer)})
        port_out.append({
            "metrics": {k: v.numpy().copy() for k, v in tm.items()},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in tstate.model.named_parameters()},
            "state": _port_state(tstate),
            "bins": tstate.bins, "balancer": tstate.balancer})
    return jax_out, port_out


@pytest.fixture(scope="module")
def resumed(setup):
    """The parameters before and after one step from the initial weights at
    schedule count RESUME_COUNT, in both packages (Adam's own count stays
    0): (before, jax_after, port_after), under the port's names."""
    jstate, tstate = setup[0], copy.deepcopy(setup[2])
    before = _port_state(tstate)
    sanitize, (adam, schedule) = jstate.opt_state
    count = jnp.asarray(RESUME_COUNT, schedule.count.dtype)
    jstate = jstate.replace(
        opt_state=(sanitize, (adam, schedule._replace(count=count))))
    tstate.step = RESUME_COUNT
    jstate, _, tstate, _ = _step_both(setup, jstate, tstate, 0)
    return (before, flax_to_state_dict(to_numpy(jstate.params), {}),
            _port_state(tstate))


def _jax_grads(jax_out, step):
    """Per-parameter gradients of `step` (0-based) from the Adam moments,
    under the port's names and layouts."""
    mu = flax_to_state_dict(jax_out[step]["mu"], {})
    if step == 0:
        return {k: m / 0.1 for k, m in mu.items()}
    prev = flax_to_state_dict(jax_out[step - 1]["mu"], {})
    return {k: (m - 0.9 * prev[k]) / 0.1 for k, m in mu.items()}


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_and_metrics(runs, step):
    # fp32 convolutions summed in other orders: 1e-4 relative; what
    # depends on the distillation target: DISTIL_RTOL
    jax_out, port_out = runs
    jm, tm = jax_out[step]["metrics"], port_out[step]["metrics"]
    for k in ("loss", "ori_loss", "mono_reproj", "multi_reproj",
              "consistency_loss", "distil_loss", "w_ori", "w_distil"):
        rtol = DISTIL_RTOL if k in DISTIL_KEYS else 1e-4
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("step", range(STEPS))
def test_every_gradient(runs, step):
    # Tolerance, per sub-network (encoder, depth, mono_encoder, ...): every
    # entry of every gradient within 3e-2 of the sub-network's largest
    # gradient entry, and the sub-network's gradient within 3e-2 in
    # relative L2. Why so wide: the warped images agree only to ~2e-5
    # (fp32 projection rounding), so a per-pixel selection whose two sides
    # are that close (min reprojection over source frames, automask,
    # distillation argmin, cost-volume argmin) can pick the other side in
    # one package. At this seed one such pixel flips in the teacher's
    # min reprojection: the teacher and pose gradients then differ by that
    # pixel's share, 1.5e-2 in relative L2, while the sub-networks no flip
    # reaches agree to 1e-5.
    jax_out, port_out = runs
    want = _jax_grads(jax_out, step)
    got = port_out[step]["grads"]
    assert set(want) == set(got)
    for net in {name.split(".")[0] for name in want}:
        names = [n for n in want if n.split(".")[0] == net]
        scale = max(np.abs(want[n]).max() for n in names)
        err2 = sum(((got[n] - want[n]) ** 2).sum() for n in names)
        norm2 = sum((want[n] ** 2).sum() for n in names)
        assert np.sqrt(err2 / norm2) <= 3e-2, (net, np.sqrt(err2 / norm2))
        for n in names:
            err = np.abs(got[n] - want[n]).max()
            assert err <= 3e-2 * scale, (n, err, scale)


@pytest.mark.parametrize("step", range(STEPS))
def test_params_after_step(runs, step):
    # Adam moves each weight by about lr * sign(g) (lr 1e-10, then 2e-7):
    # an entry may differ by at most two such moves, where a gradient near
    # 0 has another sign. These moves are too small to tell an update from
    # none; test_update_at_a_resumed_count holds the update itself.
    jax_out, port_out = runs
    state = port_out[step]["state"]
    for name, want in flax_to_state_dict(jax_out[step]["params"], {}).items():
        np.testing.assert_allclose(state[name], want, rtol=0, atol=5e-7,
                                   err_msg=name)


def test_update_at_a_resumed_count(resumed):
    """One step at schedule count RESUME_COUNT from the same weights: each
    sub-network's parameter change against `mal_tpu`'s, in relative L2.

    Adam's first move is lr g / (|g| + eps), about lr sign(g) per entry, so
    an entry whose gradient has the other sign in one package moves 2 lr
    apart. The student (encoder, depth), whose gradients agree to 2e-5
    (test_every_gradient), has few such entries: 1e-2. The teacher and
    pose nets, which the one flipped teacher pixel reaches, differ in 1 %
    of their entries: 0.25. A schedule read after the increment (1e-5)
    is 0.9 off, an update that moves nothing 1.0."""
    before, jax_after, port_after = resumed
    for net in {name.split(".")[0] for name in jax_after}:
        names = [n for n in jax_after if n.split(".")[0] == net]
        dj = np.concatenate([(jax_after[n].astype(np.float64) - before[n]).ravel()
                             for n in names])
        dp = np.concatenate([(port_after[n].astype(np.float64) - before[n]).ravel()
                             for n in names])
        # the step moved mal_tpu's weights by about RESUME_LR each
        assert np.abs(dj).mean() > 0.5 * RESUME_LR, net
        rel = np.linalg.norm(dp - dj) / np.linalg.norm(dj)
        assert rel <= (1e-2 if net in ("encoder", "depth") else 0.25), (net, rel)


@pytest.mark.parametrize("step", range(STEPS))
def test_batch_stats_after_step(runs, step):
    # BN running statistics, updated once per trunk run in `mal_tpu`'s
    # order, with the biased batch variance
    jax_out, port_out = runs
    state = port_out[step]["state"]
    for name, want in flax_to_state_dict({}, jax_out[step]["batch_stats"]).items():
        np.testing.assert_allclose(state[name], want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("step", range(STEPS))
def test_bins_and_balancer(runs, step):
    jax_out, port_out = runs
    jb, tb = jax_out[step]["bins"], port_out[step]["bins"]
    np.testing.assert_allclose(tb.min_depth.numpy(), jb.min_depth, rtol=1e-5)
    np.testing.assert_allclose(tb.max_depth.numpy(), jb.max_depth, rtol=1e-5)
    assert bool(tb.updated) == bool(jb.updated)
    # every float field of the balancer carries distil_loss
    jl, tl = jax_out[step]["balancer"], port_out[step]["balancer"]
    for field in ("w", "running_sum", "prev_total", "prev_mean"):
        np.testing.assert_allclose(getattr(tl, field).numpy(),
                                   getattr(jl, field), rtol=DISTIL_RTOL,
                                   err_msg=field)
    assert float(tl.count) == float(jl.count)
    assert bool(tl.initialized) == bool(jl.initialized)


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    from mal_tpu_torch.models import MALModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_cfg(CFG)
    for entry in (MALModel, create_train_state, make_train_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(cfg)


@pytest.mark.parametrize("option", [
    {"method": "dualrefine", "num_data_shards": 2}, {"learn_ens": True},
    {"loss_pct": True}])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError):
        make_train_step(torch_cfg(CFG).replace(**option), device="cpu",
                        seg_fn=lambda images: None)


@pytest.mark.parametrize("option", [
    {"compute_dtype": "bfloat16"},
    {"main_temporal": True, "seg_fused_swin": True},
    {"temporal": True, **TRAIN_FAST_SETTINGS}])
def test_fast_mode_options_are_accepted(option):
    """The fast mode's switches, which an earlier slice refused."""
    step = make_train_step(torch_cfg(CFG).replace(**option), device="cpu",
                           seg_fn=lambda images: None)
    assert callable(step)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_step(torch_cfg(CFG).replace(compute_dtype="float16"),
                        device="cpu")


@pytest.mark.parametrize("option,want", [
    ({}, False),                                    # exact mode: off
    (TRAIN_FAST_SETTINGS, False),                   # auto, but on the CPU
    ({"seg_fused_swin": True}, True),               # set: on, in fp32 too
    ({"seg_fused_swin": False, **TRAIN_FAST_SETTINGS}, False)])
def test_resolve_fused_swin(option, want):
    """Auto turns the fused Swin blocks on only in fast mode on a CUDA
    device; a set value wins."""
    cfg = torch_cfg(CFG).replace(**option)
    assert resolve_fused_swin(cfg, "cpu") is want


def test_temporal_needs_a_segmenter():
    with pytest.raises(ValueError, match="seg_fn"):
        make_train_step(torch_cfg(CFG).replace(main_temporal=True),
                        device="cpu")


def test_frozen_teacher_and_pose_stay_put():
    """`freeze_teacher_and_pose`: the optimizer leaves the teacher and the
    pose net out (optax's `set_to_zero` partition in `mal_tpu`), the
    student moves."""
    cfg = torch_cfg(CFG).replace(freeze_teacher_and_pose=True)
    state = create_train_state(cfg, device="cpu")
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    step = make_train_step(cfg, device="cpu")
    batch = to_torch(np_batch(CFG, seed=1))
    g = torch.Generator().manual_seed(0)
    for _ in range(2):  # step 0 trains at init_lr = 1e-10
        state, _ = step(state, batch, 0.0, g)
    for name, p in state.model.named_parameters():
        moved = not torch.equal(p, before[name])
        frozen = name.split(".")[0] in ("mono_encoder", "mono_depth",
                                        "pose_encoder", "pose")
        assert moved == (not frozen), name
    assert not bool(state.bins.updated)  # the bins follow the teacher only


@pytest.mark.parametrize("option", [
    {"distil": False, "loss_blc": False, "no_ssim": True},
    {"loss_blc": False, "use_ensemble": False, "dual_distil": True,
     "disable_motion_masking": True},
    {"disable_automasking": True, "avg_reprojection": True, "pose_cnn": True}])
def test_step_variants(option):
    """The loss branches `mal_tpu`'s step has besides the default: each
    trains (finite loss, moving weights) and keeps its invariant. At
    64x64: the decoder's reflect padding needs 2 pixels at 1/32 scale."""
    cfg = torch_cfg(CFG).replace(height=64, width=64, **option)
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, device="cpu")
    batch = to_torch(np_batch(cfg, seed=2))
    g = torch.Generator().manual_seed(0)
    w0 = state.model.depth.decoder[10].conv.weight.clone()
    for _ in range(2):
        state, m = step(state, batch, 0.0, g)
    assert all(torch.isfinite(v).all() for v in m.values())
    assert not torch.equal(state.model.depth.decoder[10].conv.weight, w0)
    if not cfg.distil:
        # without the distillation hint the total is the original loss
        torch.testing.assert_close(m["loss"], m["ori_loss"])
    if not cfg.loss_blc:
        assert float(state.balancer.count) == 0.0  # balancer untouched
