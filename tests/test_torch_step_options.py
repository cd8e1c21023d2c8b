"""The ManyDepth step's options in the port, on the CPU: `remat` against
the same step without it, `train_teacher_only` and a combination of the
loss variants against `mal_tpu`'s jitted step, and the refusal of
`loss_pct`, which `mal_tpu` cannot run.

`remat` must change nothing but memory: the same loss, gradients,
parameters after Adam and BN running statistics (the recompute in the
backward must not move them a second time), the same draws from the
generator, and K1's cost volume computed once a step. The `mal_tpu` steps
start from the same weights, batch and draws as in
tests/test_torch_train_step.py and are held to its bounds.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.losses import MonoLossOut, MultiLossOut
from mal_tpu.models import MALModel as JaxMALModel
from mal_tpu.train.state import make_optimizer as jax_make_optimizer
from mal_tpu.train.step import make_train_step as jax_make_train_step
from mal_tpu_torch.convert.jax_params import (flax_to_state_dict,
                                              load_jax_variables)
from mal_tpu_torch.models import encoders
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import make_train_step

from test_torch_common import (CFG, np_batch, run_jitted, to_jax, to_numpy,
                               to_torch, torch_cfg)
from test_torch_train_step import (DISTIL_KEYS, DISTIL_RTOL, _draws,
                                   jax_initial_state)

STUDENT = ("encoder", "depth")
K1 = encoders.plane_sweep_cost_volume_kernel
LOSS_KEYS = ("loss", "ori_loss", "mono_reproj", "multi_reproj",
             "consistency_loss", "distil_loss", "w_ori", "w_distil")
# the loss branches of `mal_tpu`'s step besides the default, in one step
VARIANTS = dict(no_ssim=True, disable_motion_masking=True, dual_distil=True,
                avg_reprojection=True, disable_automasking=True,
                pose_cnn=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_data.py says why."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def initial():
    """One set of weights (flax's initialisers in the port) for the remat
    runs."""
    return create_train_state(torch_cfg(CFG), device="cpu").model.state_dict()


def _port_step(cfg, weights, batch, steps=1, monkeypatch=None, **kwargs):
    """`steps` port steps from `weights`; returns (state, last metrics,
    gradients, K1 calls, the generator's state)."""
    state = create_train_state(cfg, device="cpu", init_weights=False)
    state.model.load_state_dict(weights)
    calls = []
    if monkeypatch is not None:
        def counted(*args):
            calls.append(1)
            return K1(*args)
        monkeypatch.setattr(encoders, "plane_sweep_cost_volume_kernel",
                            counted)
    step = make_train_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(11)
    for _ in range(steps):
        state, m = step(state, batch, 0.0, gen, **kwargs)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
             if p.grad is not None}
    return state, m, grads, len(calls), gen.get_state()


@pytest.mark.parametrize("option", [{}, {"pareto": True, "loss_blc": False},
                                    {"compute_dtype": "bfloat16"}])
def test_remat_changes_nothing_but_memory(initial, option, monkeypatch):
    """Two steps with and without `remat`, the draws from the generator:
    loss, every gradient, every parameter and BN statistic after the steps
    equal to 1e-6 (a second BN update in the recompute moves the running
    statistics by 10 % of the batch's); the generator drawn as often; the
    cost volume computed once a step. With pareto the backward recomputes
    three times."""
    cfg = torch_cfg(CFG).replace(**option)
    batch = to_torch(np_batch(CFG, seed=2, batch_size=CFG.batch_size))
    plain = _port_step(cfg, initial, batch, 2, monkeypatch)
    remat = _port_step(cfg.replace(remat=True), initial, batch, 2,
                       monkeypatch)
    for k, v in plain[1].items():
        torch.testing.assert_close(remat[1][k], v, rtol=0, atol=1e-6, msg=k)
    assert set(remat[2]) == set(plain[2])
    for n, g in plain[2].items():
        torch.testing.assert_close(remat[2][n], g, rtol=0, atol=1e-6, msg=n)
    after = remat[0].model.state_dict()
    for n, v in plain[0].model.state_dict().items():
        torch.testing.assert_close(after[n], v, rtol=0, atol=1e-6, msg=n)
    assert plain[3] == remat[3] == 2
    assert torch.equal(plain[4], remat[4])


def test_remat_wraps_the_trunks():
    model = create_train_state(torch_cfg(CFG).replace(remat=True),
                               device="cpu", init_weights=False).model
    assert model.encoder.remat and model.mono_encoder.remat
    assert model.pose_encoder.remat


# --------------------------------------------------------------------------
# train_teacher_only and the loss variants against mal_tpu
# --------------------------------------------------------------------------

def _against_mal_tpu(cfg):
    """One step of `cfg` in both packages from the same weights, batch and
    draws: (mal_tpu metrics, mal_tpu params, mal_tpu Adam first moment,
    port state, port metrics, port weights before the step)."""
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
    draws = _draws(key, cfg.batch_size, cfg.height, cfg.width)
    if cfg.disable_automasking:
        draws.pop("automask_noise")     # mal_tpu draws none either
    tstate, tm = make_train_step(torch_cfg(cfg), device="cpu")(
        tstate, to_torch(batch), 0.0, draws=draws)
    opt = jstate.opt_state
    if cfg.train_teacher_only:      # optax's partition: the trained nets
        mu = opt.inner_states["train"].inner_state[1][0].mu
        mu = {k: v for k, v in mu.items() if k not in STUDENT}
    else:
        mu = opt[1][0].mu
    return (to_numpy(jm), to_numpy(jstate.params), to_numpy(mu), tstate,
            {k: v.numpy() for k, v in tm.items()}, before)


def _check_metrics(jm, tm):
    for k in LOSS_KEYS:
        rtol = DISTIL_RTOL if k in DISTIL_KEYS else 1e-4
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)


def _check_gradients(mu, tstate, pose_cnn=False):
    # per sub-network, as test_torch_train_step.test_every_gradient: every
    # entry within 3e-2 of the largest, 3e-2 in relative L2
    want = {k: m / 0.1 for k, m in
            flax_to_state_dict(mu, {}, pose_cnn).items()}
    got = {n: p.grad.numpy() for n, p in tstate.model.named_parameters()}
    for net in {name.split(".")[0] for name in want}:
        names = [n for n in want if n.split(".")[0] == net]
        scale = max(np.abs(want[n]).max() for n in names)
        err2 = sum(((got[n] - want[n]) ** 2).sum() for n in names)
        norm2 = sum((want[n] ** 2).sum() for n in names)
        assert np.sqrt(err2 / norm2) <= 3e-2, (net, np.sqrt(err2 / norm2))
        for n in names:
            assert np.abs(got[n] - want[n]).max() <= 3e-2 * scale, n
    return want


def test_train_teacher_only_against_mal_tpu():
    """The student (cost-volume encoder and decoder) stays bit-identical,
    in both packages; the rest trains as `mal_tpu`'s does."""
    cfg = CFG.replace(train_teacher_only=True)
    jm, jparams, mu, tstate, tm, before = _against_mal_tpu(cfg)
    _check_metrics(jm, tm)
    want = _check_gradients(mu, tstate)
    assert not {n.split(".")[0] for n in want} & set(STUDENT)
    jafter = flax_to_state_dict(jparams, {})
    after = tstate.model.state_dict()
    moved = set()
    for name, v in tstate.model.named_parameters():
        if name.split(".")[0] in STUDENT:
            assert torch.equal(v, before[name]), name
            np.testing.assert_array_equal(jafter[name], before[name].numpy())
        else:
            np.testing.assert_allclose(after[name].numpy(), jafter[name],
                                       rtol=0, atol=5e-7, err_msg=name)
            if not torch.equal(v, before[name]):
                moved.add(name.split(".")[0])
    assert moved == {"mono_encoder", "mono_depth", "pose_encoder", "pose"}
    # the student's BN statistics still follow its forward, as in mal_tpu
    assert not torch.equal(after["encoder.layer0.1.running_mean"],
                           before["encoder.layer0.1.running_mean"])


def test_loss_variants_against_mal_tpu():
    """`no_ssim`, `disable_motion_masking`, `dual_distil`,
    `avg_reprojection`, `disable_automasking` and `pose_cnn` in one step:
    the loss metrics and every gradient."""
    cfg = CFG.replace(**VARIANTS)
    jm, _, mu, tstate, tm, _ = _against_mal_tpu(cfg)
    _check_metrics(jm, tm)
    want = _check_gradients(mu, tstate, pose_cnn=True)
    assert {n.split(".")[0] for n in want} == {
        "encoder", "depth", "mono_encoder", "mono_depth", "pose_encoder"}


# --------------------------------------------------------------------------
# loss_pct
# --------------------------------------------------------------------------

def test_loss_pct_is_refused_for_the_reason_mal_tpu_cannot_run_it():
    # `mal_tpu`'s step logs mono_out.mask_pct / multi_out.mask_pct, which
    # its loss outputs do not have: it raises AttributeError at trace time
    assert "mask_pct" not in MonoLossOut._fields
    assert "mask_pct" not in MultiLossOut._fields
    with pytest.raises(NotImplementedError, match="mask_pct"):
        make_train_step(torch_cfg(CFG).replace(loss_pct=True), device="cpu")
