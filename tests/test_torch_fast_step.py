"""The depth and pose nets and one training step in the port's fast mode
(`Config(**TRAIN_FAST_SETTINGS)`: bf16 convolutions and BN outputs on fp32
parameters, bf16 warp payloads, an fp32 loss) against `mal_tpu`'s, on the CPU
at a small size, from the same weights and inputs.

tests/test_torch_fast_mode.py says how bf16 results are compared and why:
layer by layer given `mal_tpu`'s own bf16 activations (`SHARE` of the
bf16-to-fp32 distance, a ResNet stage at 0.35), whole networks end to end at
`END_TO_END` times that distance. The fp32 side is the port's own fp32 module
or step on the same input, which tests/test_torch_models.py and
tests/test_torch_train_step.py hold against `mal_tpu`'s.

The weights are random numpy draws on the flax tree's shapes
(`random_mal_variables`: initialising through flax costs a compile). The one
jitted `mal_tpu` function of this file is the loss and its gradients at
64x64, one item: the smallest frame the decoder's reflect padding takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.config import TRAIN_FAST_SETTINGS
from mal_tpu.losses import LossBalancerState as JBalancer
from mal_tpu.models import MALModel as JaxMALModel
from mal_tpu.models.depth_decoder import DepthDecoder as JDepthDecoder
from mal_tpu.models.pose_decoder import PoseDecoder as JPoseDecoder
from mal_tpu.models.resnet import ResNetFeatures as JResNet
from mal_tpu.models.resnet import _max_pool_3x3s2p1, imagenet_normalize
from mal_tpu.train.step import make_loss_fn as jax_make_loss_fn
from mal_tpu_torch import losses
from mal_tpu_torch.convert.jax_params import flax_to_state_dict
from mal_tpu_torch.train.step import make_loss_fn

from test_torch_common import (CFG, END_TO_END, as_f32, as_torch, check_bf16,
                               np_batch, port_model, random_mal_variables,
                               to_jax, to_torch, torch_cfg)
from test_torch_common import one_torch_thread, run_jitted  # noqa: F401

FAST_CFG = CFG.replace(**TRAIN_FAST_SETTINGS)
STEP_CFG = CFG.replace(height=64, width=64, batch_size=1)


@pytest.fixture(scope="module")
def weights():
    params, stats = random_mal_variables(CFG, seed=0)
    return (params, stats, port_model(FAST_CFG, params, stats),
            port_model(CFG, params, stats))


def test_resnet_trunk_stage_by_stage(weights):
    """The teacher's ResNet-18 trunk in training mode (batch statistics) in
    bf16, each stage given `mal_tpu`'s bf16 output of the stage before:
    post-ReLU activations of up to ~8 after two blocks (four convolutions):
    elementwise two ulps of the value (2^-6 of it), and 0.05 for the small
    outputs that a flip further up in the stage moves. A stage is four
    convolutions deep, so some of its noise is already its own: on average
    within 0.35 of the bf16-to-fp32 distance (measured: up to 0.24)."""
    params, stats, fast, exact = weights
    variables = {"params": params["mono_encoder"]["encoder"],
                 "batch_stats": stats["mono_encoder"]["encoder"]}
    image = np.random.RandomState(3).uniform(
        0, 1, (2, CFG.height, CFG.width, 3)).astype(np.float32)
    x = imagenet_normalize(jnp.asarray(image))
    chain, _ = JResNet(18, 1, dtype=jnp.bfloat16).apply(
        variables, x, train=True, mutable=["batch_stats"])   # [f0 .. f4]
    trunk = fast.mono_encoder.encoder.train()
    trunk32 = exact.mono_encoder.encoder.train()
    tol = dict(atol=0.05, rtol=2 ** -6, share=0.35)
    xt = as_torch(x, channels_first=True)
    got = trunk(xt)[0]
    assert got.dtype == torch.bfloat16 and chain[0].dtype == jnp.bfloat16
    check_bf16(got, as_torch(chain[0], channels_first=True), trunk32(xt)[0],
               **tol, what="stem")
    for k in range(1, 5):
        inp = _max_pool_3x3s2p1(chain[0]) if k == 1 else chain[k - 1]
        inp = as_torch(inp, torch.bfloat16, channels_first=True)
        check_bf16(getattr(trunk, f"layer{k}")(inp),
                   as_torch(chain[k], channels_first=True),
                   getattr(trunk32, f"layer{k}")(inp.float()), **tol,
                   what=f"layer{k}")


def test_decoders_in_bf16(weights):
    """The depth decoder and the pose decoder in bf16 on a bf16 feature
    pyramid: fp32 disparities in (0, 1) (an ulp of the logit before the
    fp32 sigmoid moves the output by at most 2^-8 x 0.25 of it: 1e-2; eleven
    convolutions deep, so held at half the bf16-to-fp32 distance) and fp32
    poses of ~1e-3 (1e-4)."""
    params, _, fast, exact = weights
    rng = np.random.RandomState(5)
    shapes = [(2, 32, 48, 64), (2, 16, 24, 64), (2, 8, 12, 128),
              (2, 4, 6, 256), (2, 2, 3, 512)]
    feats = [jnp.asarray(rng.normal(0, 1, s).astype(np.float32),
                         jnp.bfloat16) for s in shapes]
    tfeats = [as_torch(f, torch.bfloat16, channels_first=True) for f in feats]
    want = JDepthDecoder(dtype=jnp.bfloat16).apply(
        {"params": params["depth"]}, feats)
    got = fast.depth(tfeats)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    check_bf16(got.permute(0, 2, 3, 1), want,
               exact.depth([f.float() for f in tfeats]).permute(0, 2, 3, 1),
               atol=1e-2, share=0.5, what="disp")
    want = JPoseDecoder(2, dtype=jnp.bfloat16).apply(
        {"params": params["pose"]}, feats[-1])
    for g, w, e, what in zip(fast.pose(tfeats[-1]), want,
                             exact.pose(tfeats[-1].float()),
                             ("axisangle", "translation")):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        check_bf16(g, w, e, atol=1e-4, what=what)


@pytest.fixture(scope="module")
def step(weights):
    """One fast-mode training step without the hint at 64x64, one item, in
    both packages (the one jitted `mal_tpu` function of this file): the
    loss, every gradient, the teacher's depth and the BN statistics after
    the forward; and the port's own fp32 step as the exact side."""
    cfg = STEP_CFG.replace(**TRAIN_FAST_SETTINGS)
    params, stats, _, _ = weights
    batch = np_batch(cfg, seed=3, batch_size=cfg.batch_size)
    rng_model, rng_noise = jax.random.split(jax.random.PRNGKey(5))
    B, Hs, Ws = cfg.batch_size, cfg.height, cfg.width
    draws = dict(
        aug_draw=torch.from_numpy(np.array(jax.random.uniform(rng_model, (B,)))),
        noise=torch.from_numpy(np.array(jax.random.normal(
            rng_noise, (B, Hs, Ws, 1), jnp.float32))).reshape(B, 1, Hs, Ws))
    jloss = jax_make_loss_fn(cfg, JaxMALModel(cfg))

    def total(p):
        loss, aux = jloss(p, stats, jnp.asarray(0.1), jnp.asarray(10.0),
                          JBalancer.create(), to_jax(batch), rng_model,
                          rng_noise, jnp.zeros(()))
        return loss, (aux["mono_depth"], aux["batch_stats"])

    (loss, (depth, new_stats)), grads = run_jitted(
        jax.value_and_grad(total, has_aux=True), params)
    out = {"want": {"loss": float(loss), "mono_depth": as_f32(depth),
                    "grads": flax_to_state_dict(jax.device_get(grads), {}),
                    "stats": flax_to_state_dict({}, jax.device_get(new_stats))}}
    for name, c in (("got", cfg), ("exact", STEP_CFG)):
        model = port_model(c, params, stats)
        loss, aux = make_loss_fn(torch_cfg(c), model)(
            to_torch(batch), torch.tensor(0.1), torch.tensor(10.0),
            losses.LossBalancerState.create(), 0.0, **draws)
        loss.backward()
        state = model.state_dict()
        out[name] = {
            "loss": float(loss),
            "mono_depth": as_f32(aux["mono_depth"].permute(0, 2, 3, 1)),
            "grads": {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()},
            "stats": {k: state[k].numpy().copy() for k in out["want"]["stats"]}}
    return out


def test_fast_step_model_outputs(step):
    """What the bf16 nets hand the fp32 loss, end to end: the teacher's
    depth (0.1 to 10: 2 % of the value elementwise, `END_TO_END` on
    average), and every BN running statistic after the training forward
    (means and variances over a map average the rounding noise out, down to
    the 2x2 maps of the last stage, which average four positions: 0.1 of
    the statistic's largest entry elementwise, and on average no farther
    from `mal_tpu`'s bf16 statistics than `END_TO_END` times what separates
    those from fp32 ones)."""
    want, got, exact = step["want"], step["got"], step["exact"]
    np.testing.assert_allclose(got["mono_depth"], want["mono_depth"],
                               rtol=2e-2)
    check_bf16(got["mono_depth"], want["mono_depth"], exact["mono_depth"],
           atol=np.inf, share=END_TO_END, what="mono_depth")
    assert set(got["stats"]) == set(want["stats"])
    ours = theirs = 0.0
    for k, w in want["stats"].items():
        scale = np.abs(w).max() + 1e-6
        np.testing.assert_allclose(got["stats"][k], w, rtol=0,
                                   atol=0.1 * scale, err_msg=k)
        ours += np.abs(got["stats"][k] - w).mean() / scale
        theirs += np.abs(exact["stats"][k] - w).mean() / scale
    assert theirs > 0 and ours <= END_TO_END * theirs, (ours, theirs)


def test_fast_step_loss(step):
    """bf16 nets under an fp32 loss, end to end: the two packages' totals
    agree to 5e-3 of the loss, and no worse than `END_TO_END` times the
    distance of `mal_tpu`'s bf16 total from the fp32 one (the port's own,
    which tests/test_torch_train_step.py holds against `mal_tpu`'s)."""
    want, got, exact = (step[k]["loss"] for k in ("want", "got", "exact"))
    assert abs(got - want) <= 5e-3 * abs(want), (got, want)
    assert abs(want - exact) > 0
    assert abs(got - want) <= END_TO_END * abs(want - exact), (got, want, exact)


def test_fast_step_gradient_directions(step):
    """Per sub-network, the angle (in radians) between the port's bf16
    gradient and `mal_tpu`'s, end to end through the bf16 forward and
    backward of one item at 64x64: no wider than `END_TO_END` times the
    angle between `mal_tpu`'s bf16 gradient and the fp32 gradient (the
    port's own, which tests/test_torch_train_step.py holds against
    `mal_tpu`'s to 3e-2 in relative L2), and under 1.25 radians. At this
    size and with random weights bf16 gradients are that noisy: `mal_tpu`'s
    own lie 0.2 (depth) to 1.1 radians (pose_encoder) off the fp32 ones."""
    want, got, exact = (step[k]["grads"] for k in ("want", "got", "exact"))
    assert set(want) == set(got) == set(exact)

    def angle(a, b, names):
        va = np.concatenate([a[n].ravel().astype(np.float64) for n in names])
        vb = np.concatenate([b[n].ravel().astype(np.float64) for n in names])
        cos = va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb))
        return float(np.arccos(np.clip(cos, -1.0, 1.0)))

    for net in sorted({name.split(".")[0] for name in want}):
        names = [n for n in want if n.split(".")[0] == net]
        ours, modes = angle(got, want, names), angle(want, exact, names)
        assert modes > 0, net
        assert ours <= 1.25 and ours <= END_TO_END * modes, (net, ours, modes)


