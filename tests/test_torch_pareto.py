"""The port's pareto (MGDA) weighting (`mal_tpu_torch.pareto`) and its
pareto training step against `mal_tpu`'s, on the CPU.

The weights' closed form is held against `mal_tpu.pareto` on seeded
gradient lists: its bounds, its degenerate case and the weighted sum. The
step is held against `mal_tpu`'s jitted pareto step at the configuration
of tests/test_pareto.py, from the same weights, batch and draws (as
tests/test_torch_train_step.py does): the weights, the loss metrics, every
gradient and the parameters after Adam.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu import pareto as jpareto
from mal_tpu.models import MALModel as JaxMALModel
from mal_tpu.train.state import make_optimizer as jax_make_optimizer
from mal_tpu.train.step import make_train_step as jax_make_train_step
from mal_tpu_torch import pareto
from mal_tpu_torch.convert.jax_params import (flax_to_state_dict,
                                              load_jax_variables)
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import _pareto_backward, make_train_step

from test_torch_common import (CFG, np_batch, run_jitted, to_jax, to_numpy,
                               to_torch, torch_cfg)
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_step import (DISTIL_KEYS, DISTIL_RTOL, _draws,
                                   _jax_grads, jax_initial_state)

PARETO = CFG.replace(pareto=True, loss_blc=False)


def _lists(seed, sizes=(20, 7, 13), scale1=1.0):
    rng = np.random.RandomState(seed)
    g0 = [rng.randn(n).astype(np.float32) for n in sizes]
    g1 = [scale1 * rng.randn(n).astype(np.float32) for n in sizes]
    return g0, g1


def _both(g0, g1, c=(0.1, 0.3)):
    """(port (w0, w1), mal_tpu (w0, w1)) on the same lists."""
    t = pareto.pareto_weights_2task([torch.from_numpy(a) for a in g0],
                                    [torch.from_numpy(b) for b in g1], *c)
    j = jpareto.pareto_weights_2task(
        {str(i): jnp.asarray(a) for i, a in enumerate(g0)},
        {str(i): jnp.asarray(b) for i, b in enumerate(g1)}, *c)
    return [float(w) for w in t], [float(w) for w in j]


@pytest.mark.parametrize("seed,scale1,c", [
    (0, 1.0, (0.1, 0.3)), (1, 1.0, (0.0, 0.0)), (2, 0.7, (0.05, 0.05)),
    (3, 1.3, (0.1, 0.3))])
def test_weights_match_mal_tpu(seed, scale1, c):
    """Unclipped and clipped solutions of the closed form."""
    (t0, t1), (j0, j1) = _both(*_lists(seed, scale1=scale1), c)
    np.testing.assert_allclose([t0, t1], [j0, j1], rtol=0, atol=1e-6)
    assert abs(t0 + t1 - 1.0) < 1e-6
    assert c[1] - 1e-7 <= t1 <= 1.0 - c[0] + 1e-7


def test_bounds_keep_both_tasks_alive():
    g_big = [np.full(8, 10.0, np.float32)] * 2
    g_tiny = [np.full(8, 1e-3, np.float32)] * 2
    (t0, t1), (j0, j1) = _both(g_big, g_tiny)
    assert (t0, t1) == pytest.approx((0.1, 0.9)) == (j0, j1)
    (t0, t1), (j0, j1) = _both(g_tiny, g_big)
    assert t1 == pytest.approx(0.3) == j1


def test_identical_gradients_take_the_midpoint():
    g = [np.ones(4, np.float32), np.ones(3, np.float32)]
    (t0, t1), (j0, j1) = _both(g, g)
    assert (t0, t1) == (0.5, 0.5) == (j0, j1)


def test_combine_is_the_weighted_sum():
    g0, g1 = _lists(7)
    tg0 = [torch.from_numpy(a) for a in g0]
    tg1 = [torch.from_numpy(b) for b in g1]
    grads, w0, w1 = pareto.pareto_combine_grads(tg0, tg1, 0.0, 0.0)
    jgrads, jw0, jw1 = jpareto.pareto_combine_grads(
        {str(i): jnp.asarray(a) for i, a in enumerate(g0)},
        {str(i): jnp.asarray(b) for i, b in enumerate(g1)}, 0.0, 0.0)
    for i, g in enumerate(grads):
        torch.testing.assert_close(g, w0 * tg0[i] + w1 * tg1[i])
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[str(i)]),
                                   rtol=1e-6, atol=1e-7)


def test_step_weights_cover_every_parameter():
    """The dot products run over every parameter of the model, frozen or
    not, as `mal_tpu`'s run over all of `state.params`; a parameter a loss
    does not reach counts as zero."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    model.extra = torch.nn.Parameter(torch.randn(4))
    x = torch.randn(5, 3)
    y = model(x)
    comps = torch.stack([y[:, 0].pow(2).sum() + model.extra.sum(),
                         y[:, 1].sum(), 2.0 * y.mean()])
    grads = [torch.autograd.grad(comps[i], list(model.parameters()),
                                 retain_graph=True) for i in range(3)]
    cfg = torch_cfg(PARETO).replace(pareto_c=(0.0, 0.0))
    m = _pareto_backward(cfg, model, comps)
    w0, w1 = pareto.pareto_weights_2task(list(grads[0]), list(grads[1]),
                                         0.0, 0.0)
    assert 0.0 < float(w1) < 1.0     # unclipped, so every dot counts
    torch.testing.assert_close(m["w_ori"], w0)
    for p, a, b, c in zip(model.parameters(), *grads):
        torch.testing.assert_close(p.grad, w0 * a + w1 * b + c)


@pytest.fixture(scope="module")
def stepped():
    """One pareto step in both packages from the same weights, batch and
    draws."""
    cfg = PARETO
    batch = np_batch(cfg, seed=0, batch_size=cfg.batch_size)
    jmodel = JaxMALModel(cfg)
    jstate = jax_initial_state(cfg, jmodel, batch)
    tstate = create_train_state(torch_cfg(cfg), device="cpu",
                                init_weights=False)
    load_jax_variables(tstate.model, to_numpy(jstate.params),
                       to_numpy(jstate.batch_stats))
    before = copy.deepcopy(tstate.model.state_dict())
    jstep = jax_make_train_step(cfg, jmodel, jax_make_optimizer(cfg))
    key = jax.random.PRNGKey(1)
    jstate, jm = run_jitted(jstep, jstate, to_jax(batch), key, jnp.zeros(()))
    tstep = make_train_step(torch_cfg(cfg), device="cpu")
    tstate, tm = tstep(tstate, to_torch(batch), 0.0,
                       draws=_draws(key, cfg.batch_size, cfg.height,
                                    cfg.width))
    jax_out = {"metrics": to_numpy(jm), "params": to_numpy(jstate.params),
               "mu": to_numpy(jstate.opt_state[1][0].mu),
               "balancer": to_numpy(jstate.balancer)}
    return jax_out, tstate, {k: v.numpy() for k, v in tm.items()}, before


def test_step_weights_and_metrics(stepped):
    # tolerances of tests/test_torch_train_step.py: 1e-4 relative, and
    # DISTIL_RTOL where a near-tie flip of the distillation target reaches
    jax_out, _, tm, _ = stepped
    jm = jax_out["metrics"]
    for k in ("w_ori", "w_distil"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert abs(tm["w_ori"] + tm["w_distil"] - 1.0) < 1e-6
    for k in ("loss", "ori_loss", "mono_reproj", "multi_reproj",
              "consistency_loss", "distil_loss"):
        rtol = DISTIL_RTOL if k in DISTIL_KEYS else 1e-4
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)


def test_step_leaves_the_balancer(stepped):
    # pareto wins over loss_blc, as tests/test_pareto.py pins for mal_tpu
    jax_out, tstate, _, _ = stepped
    assert float(tstate.balancer.count) == 0.0
    assert float(jax_out["balancer"].count) == 0.0


def test_step_gradients(stepped):
    # per sub-network, as test_torch_train_step.test_every_gradient: every
    # entry within 3e-2 of the largest, 3e-2 in relative L2
    jax_out, tstate, _, _ = stepped
    want = _jax_grads([jax_out], 0)
    got = {n: p.grad.numpy() for n, p in tstate.model.named_parameters()}
    assert set(want) == set(got)
    for net in {name.split(".")[0] for name in want}:
        names = [n for n in want if n.split(".")[0] == net]
        scale = max(np.abs(want[n]).max() for n in names)
        err2 = sum(((got[n] - want[n]) ** 2).sum() for n in names)
        norm2 = sum((want[n] ** 2).sum() for n in names)
        assert np.sqrt(err2 / norm2) <= 3e-2, (net, np.sqrt(err2 / norm2))
        for n in names:
            assert np.abs(got[n] - want[n]).max() <= 3e-2 * scale, n


def test_step_parameters_after_adam(stepped):
    # as test_torch_train_step.test_params_after_step: at init_lr an
    # entry may differ by two Adam moves where a gradient near 0 flips sign
    jax_out, tstate, _, before = stepped
    state = tstate.model.state_dict()
    moved = 0
    for name, want in flax_to_state_dict(jax_out["params"], {}).items():
        np.testing.assert_allclose(state[name].numpy(), want, rtol=0,
                                   atol=5e-7, err_msg=name)
        moved += not torch.equal(state[name], before[name])
    assert moved > 0
