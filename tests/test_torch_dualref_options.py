"""DualRefine's training options in the port against `mal_tpu`, in one
combined step at tests/test_torch_dualref_step.py's size and in float64 (as
that file says why): plain (Picard) iteration instead of Anderson, two
supervised states (`deq_n_losses=2`), two phantom steps each supervised
(`deq_sup_all`), damping `deq_tau=0.8`, and the last state's gradient from
the implicit function theorem (`deq_ift`, 3 adjoint steps). The same
weights, batch and draws go to both packages.

Held: the loss and its metrics (1e-6 relative), the BN statistics (1e-6),
the training forward's outputs (1e-5 of their largest value) and the
gradients of the sub-networks these options act on: the update block,
the feature heads, the uncertainty head and the gap scales (1e-3 relative
L2). `mal_tpu`'s gradient is taken for those alone, so the trunk's
backward, held by the default step, is not compiled again.
"""

import jax
import numpy as np
import pytest
import torch

from mal_tpu.dualref.model import DEQDepthPose as JModel
from mal_tpu.dualref.step import make_dualref_loss_fn as jax_loss_fn
from mal_tpu_torch.convert.dualref import export_depth_pose
from mal_tpu_torch.dualref.step import make_dualref_loss_fn

from test_torch_common import to_numpy, torch_cfg
from test_torch_dualref_step import (CFG, KEY, LOSS_RTOL, _Capture,
                                     assert_grads, assert_outputs, close,
                                     dualref_variables, f64, noise_draws,
                                     np_batch, port_model, run_jitted,
                                     to_double, to_jax)

OPTIONS = CFG.replace(deq_solver="iteration", deq_n_losses=2,
                      deq_sup_all=True, phantom_grad_steps=2, deq_tau=0.8,
                      deq_ift=True, deq_b_thres=3)
# the sub-networks whose gradients the options change
DEQ_NETS = ("conv2", "context", "hidden", "update_block", "pose_weights",
            "reproject_2")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_data.py says why."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def step():
    batch = np_batch(CFG, seed=0, batch_size=CFG.batch_size)
    params, stats = dualref_variables()
    model = JModel(OPTIONS)

    def fn(deq, rest, s, b, k):
        stash = {}

        def loss(deq):
            total, aux = jax_loss_fn(OPTIONS, _Capture(model, stash))(
                {**rest, **deq}, s, b, k)
            return total, (aux, stash["out"])

        (total, (aux, out)), grads = jax.value_and_grad(
            loss, has_aux=True)(deq)
        return {"loss": total, "metrics": aux["metrics"], "grads": grads,
                "stats": aux["batch_stats"], "out": out}

    p64 = f64(params)
    deq = {k: v for k, v in p64.items() if k in DEQ_NETS}
    rest = {k: v for k, v in p64.items() if k not in DEQ_NETS}
    with jax.enable_x64():
        want = to_numpy(run_jitted(fn, deq, rest, f64(stats),
                                   to_jax(f64(batch)), KEY))

    tmodel = port_model(OPTIONS, params, stats).double()
    stash = {}
    tmodel.register_forward_hook(lambda m, i, o: stash.setdefault("out", o))
    total, aux = make_dualref_loss_fn(torch_cfg(OPTIONS), tmodel)(
        to_double(batch), noise=noise_draws(OPTIONS, KEY))
    total.backward()
    got = {"loss": total.item(),
           "metrics": {k: v.numpy() for k, v in aux["metrics"].items()},
           "grads": {n: (np.zeros(p.shape) if p.grad is None
                         else p.grad.numpy().copy())
                     for n, p in tmodel.named_parameters()},
           "state": {k: v.numpy() for k, v in tmodel.state_dict().items()},
           "out": {k: v.detach() for k, v in stash["out"][0].items()}}
    full = {**params, **want["grads"]}
    want["grads"] = export_depth_pose(full, want["stats"])
    return got, want, params


def test_options_loss_metrics_and_outputs(step):
    """Two supervised states from two taps, each unrolled two phantom steps
    (both supervised: four refined states), and the metrics."""
    got, want, _ = step
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    for k in ("loss", "pose_loss", "reproj_0", "reproj_1", "reproj_2",
              "consistency_loss"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=LOSS_RTOL, atol=1e-12, err_msg=k)
    out, _ = want["out"]
    # tap 0: two phantom states; tap 1 (the last): one IFT state
    assert {f"disp_0_{k}" for k in range(4)} == {
        k for k in out if k.startswith("disp_0_")}
    assert_outputs(got["out"], out, "options")


def test_options_gradients(step):
    """The update block's and the heads' gradients, through the damped
    phantom unrolls and the IFT output."""
    got, want, params = step
    nets = ("conv2.", "context.", "hidden.", "update_block.", "pose_update.",
            "reproject_2.")
    wg = {k: v for k, v in want["grads"].items()
          if k in got["grads"] and k.startswith(nets)}
    gg = {k: got["grads"][k] for k in wg}
    assert len(wg) > 50
    assert_grads(gg, wg)


def test_options_bn_statistics(step):
    got, want, params = step
    for k, w_ in export_depth_pose(params, want["stats"]).items():
        if k.endswith(("running_mean", "running_var")):
            close(got["state"][k], w_, 1e-6, k)
