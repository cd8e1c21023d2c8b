"""The port's networks against `mal_tpu.models`, on the CPU.

Each net gets `mal_tpu`'s random flax weights through `load_jax_variables`
and the same numpy inputs, in eval mode and in train mode; train mode also
compares the BN statistics after the forward (flax keeps the biased batch
variance, which `mal_tpu_torch.models.resnet.BatchNorm2d` reproduces).
Tolerance: 1e-4 relative and absolute on float32 activations of random
deep nets (convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.convert.export_pth import (export_depth_decoder,
                                        export_matching_encoder,
                                        export_pose_decoder,
                                        export_resnet_trunk)
from mal_tpu.models import MALModel as JaxMALModel
from mal_tpu.models.depth_decoder import DepthDecoder as JDepthDecoder
from mal_tpu.models.encoders import ResnetEncoder as JResnetEncoder
from mal_tpu.models.encoders import ResnetEncoderMatching as JMatching
from mal_tpu.models.pose_decoder import PoseCNN as JPoseCNN
from mal_tpu.models.pose_decoder import PoseDecoder as JPoseDecoder
from mal_tpu.models.resnet import ResNetFeatures as JResNetFeatures
from mal_tpu_torch.convert.jax_params import flax_to_state_dict
from mal_tpu_torch.models.pose_decoder import PoseCNN
from mal_tpu_torch.models.resnet import ResNetFeatures

from test_torch_common import (CFG, jax_variables, nchw, np_batch, port_model,
                               to_jax, to_numpy, to_torch)
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
# ResNet-50 in train mode: flax takes the batch variance as E[x^2] - E[x]^2,
# torch in two passes; over 53 batch-normalised layers the two drift apart
# to 6e-3 on activations of ~10 at 128x128 (ResNet-18, 20 layers: 1.4e-4)
TOL_R50_TRAIN = dict(rtol=1e-3, atol=1e-2)


@pytest.fixture(scope="module")
def weights():
    params, stats = jax_variables(CFG, seed=0)
    return params, stats, port_model(CFG, params, stats)


def _close(got: torch.Tensor, want, nhwc=True):
    got = got.detach()
    if nhwc and got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _stats_close(module_prefix, port_model_, new_stats):
    state = port_model_.state_dict()
    for name, want in flax_to_state_dict({}, new_stats).items():
        if name.startswith(module_prefix):
            np.testing.assert_allclose(state[name].numpy(), want, **TOL,
                                       err_msg=name)


def _images(seed, B=2, C=3):
    return np.random.RandomState(seed).uniform(
        0, 1, (B, CFG.height, CFG.width, C)).astype(np.float32)


def test_state_dict_equals_export_pth(weights):
    """Keys and values equal `mal_tpu/convert/export_pth.py`'s reference
    layout, net by net."""
    params, stats, model = weights
    want = {}
    parts = {
        "encoder": export_matching_encoder(params["encoder"], stats["encoder"]),
        "depth": export_depth_decoder(params["depth"]),
        "mono_depth": export_depth_decoder(params["mono_depth"]),
        "pose": export_pose_decoder(params["pose"]),
        "mono_encoder": export_resnet_trunk(
            params["mono_encoder"]["encoder"], stats["mono_encoder"]["encoder"],
            prefix="encoder."),
        "pose_encoder": export_resnet_trunk(
            params["pose_encoder"]["encoder"], stats["pose_encoder"]["encoder"],
            prefix="encoder."),
    }
    for net, sd in parts.items():
        want.update({f"{net}.{k}": v for k, v in sd.items()})
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("net", ["mono_encoder", "pose_encoder"])
def test_resnet_encoder(weights, net, train):
    params, stats, model = weights
    n_img = 2 if net == "pose_encoder" else 1
    x = _images(1, C=3 * n_img)
    jmod = JResnetEncoder(num_layers=18, num_input_images=n_img)
    variables = {"params": params[net], "batch_stats": stats[net]}
    if train:
        want, mut = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=False)
    port = port_model(CFG, params, stats)
    sub = getattr(port, net).train(train)
    got = sub(torch.from_numpy(nchw(x)))
    for g, w in zip(got, want, strict=True):
        _close(g, w)
    if train:
        _stats_close(net + ".", port, {net: to_numpy(mut["batch_stats"])})
    if net == "pose_encoder":
        aa, t = JPoseDecoder(2).apply({"params": params["pose"]}, want[-1])
        got_aa, got_t = port.pose(got[-1])
        _close(got_aa, aa, nhwc=False)
        _close(got_t, t, nhwc=False)


@pytest.mark.parametrize("train", [False, True])
def test_matching_encoder(weights, train):
    params, stats, _ = weights
    B, H, W = 2, CFG.height, CFG.width
    cur, lookup = _images(2), _images(3)[:, None]
    rng = np.random.RandomState(4)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 1, 4, 4)).copy()
    poses[:, 0, :3, 3] = rng.uniform(-0.2, 0.2, (B, 3))
    poses[1] = 0.0  # missing frame
    K = np.asarray(np_batch(CFG, 0)["K"]) * np.float32([0.25, 0.25, 1, 1])[None, :, None]
    invK = np.linalg.inv(K).astype(np.float32)
    jmod = JMatching(num_layers=18, num_depth_bins=CFG.num_depth_bins)
    variables = {"params": params["encoder"], "batch_stats": stats["encoder"]}
    args = [jnp.asarray(a) for a in (cur, lookup, poses, K, invK)]
    args += [jnp.asarray(0.5), jnp.asarray(10.0)]
    if train:
        (feats, lowest, conf), mut = jmod.apply(
            variables, *args, train=True, mutable=["batch_stats"])
    else:
        feats, lowest, conf = jmod.apply(variables, *args, train=False)
    port = port_model(CFG, params, stats)
    enc = port.encoder.train(train)
    got_feats, got_lowest, got_conf = enc(
        torch.from_numpy(nchw(cur)),
        torch.from_numpy(np.moveaxis(lookup, -1, 2).copy()),
        *[torch.from_numpy(a) for a in (poses, K, invK)],
        torch.tensor(0.5), torch.tensor(10.0))
    for g, w in zip(got_feats, feats, strict=True):
        _close(g, w)
    np.testing.assert_array_equal(got_conf.numpy(), np.asarray(conf))
    np.testing.assert_allclose(got_lowest.numpy(), np.asarray(lowest),
                               rtol=1e-6)
    if train:
        _stats_close("encoder.", port, {"encoder": to_numpy(mut["batch_stats"])})


def test_depth_decoder(weights):
    params, _, model = weights
    rng = np.random.RandomState(5)
    shapes = [(2, 32, 48, 64), (2, 16, 24, 64), (2, 8, 12, 128),
              (2, 4, 6, 256), (2, 2, 3, 512)]
    feats = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    want = JDepthDecoder().apply({"params": params["depth"]},
                                 [jnp.asarray(f) for f in feats])
    got = model.depth([torch.from_numpy(nchw(f)) for f in feats])
    _close(got, want)


def test_mal_model_train_forward(weights):
    """The full training forward with the matching augmentation's draw
    injected, and the BN statistics of every net after it."""
    params, stats, _ = weights
    batch = np_batch(CFG, seed=6)
    rng = jax.random.PRNGKey(7)
    want, mut = JaxMALModel(CFG).apply(
        {"params": params, "batch_stats": stats}, to_jax(batch),
        jnp.asarray(0.5), jnp.asarray(10.0), rng, train=True,
        mutable=["batch_stats"])
    draw = torch.from_numpy(np.asarray(jax.random.uniform(rng, (2,))))
    port = port_model(CFG, params, stats)
    got = port(to_torch(batch), torch.tensor(0.5), torch.tensor(10.0),
               aug_draw=draw)
    assert set(got) == set(want)
    for k in want:
        if k == "lowest_cost":
            # an argmin over depth bins: equal up to bins that tie within
            # float32 noise; no such tie at this seed
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), rtol=1e-6)
        else:
            _close(got[k], want[k], nhwc=False)
    _stats_close("", port, to_numpy(mut["batch_stats"]))


@pytest.mark.parametrize("zero_cost_volume", [False, True])
def test_mal_model_eval_forward(weights, zero_cost_volume):
    params, stats, model = weights
    batch = np_batch(CFG, seed=8)
    want = JaxMALModel(CFG).apply(
        {"params": params, "batch_stats": stats}, to_jax(batch),
        jnp.asarray(0.5), jnp.asarray(10.0), zero_cost_volume,
        method=JaxMALModel.eval_forward)
    got = model.eval_forward(to_torch(batch), torch.tensor(0.5),
                             torch.tensor(10.0), zero_cost_volume)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], nhwc=False)


def _load_prefixed(module, sd, prefix):
    module.load_state_dict({k[len(prefix):]: torch.tensor(v)
                            for k, v in sd.items() if k.startswith(prefix)},
                           strict=False)


@pytest.mark.parametrize("train", [False, True])
def test_resnet50_trunk(train):
    """The Bottleneck blocks of ResNet-50 (`num_layers=50`)."""
    x = np.random.RandomState(9).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    jmod = JResNetFeatures(50)
    variables = to_numpy(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    if train:
        want, mut = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x))
    sd = flax_to_state_dict({"mono_encoder": {"encoder": variables["params"]}},
                            {"mono_encoder": {"encoder": variables["batch_stats"]}})
    port = ResNetFeatures(50)
    missing = [k for k in port.state_dict()
               if not k.endswith("num_batches_tracked")
               and "mono_encoder.encoder." + k not in sd]
    assert not missing
    _load_prefixed(port, sd, "mono_encoder.encoder.")
    got = port.train(train)(torch.from_numpy(nchw(x)))
    tol = TOL_R50_TRAIN if train else TOL
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), **tol)
    if train:
        new = flax_to_state_dict({}, {"mono_encoder": {
            "encoder": to_numpy(mut["batch_stats"])}})
        state = port.state_dict()
        for k, v in new.items():
            np.testing.assert_allclose(
                state[k[len("mono_encoder.encoder."):]].numpy(), v, **tol)


def test_pose_cnn():
    x = np.random.RandomState(10).uniform(0, 1, (2, 64, 96, 6)).astype(np.float32)
    jmod = JPoseCNN(num_input_frames=2)
    params = to_numpy(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    aa, t = jmod.apply({"params": params}, jnp.asarray(x))
    port = PoseCNN(num_input_frames=2)
    _load_prefixed(port, flax_to_state_dict({"pose_encoder": params}, {},
                                            pose_cnn=True), "pose_encoder.")
    got_aa, got_t = port(torch.from_numpy(nchw(x)))
    _close(got_aa, aa, nhwc=False)
    _close(got_t, t, nhwc=False)
