"""The port's `ResnetEncoderDYJ` (`mal_tpu_torch.models.encoders`) against
`mal_tpu`'s, on the CPU: one seeded state dict in the reference's layout
(`encoder.*` with its unused `fc`, `net.0`-`net.3`) loads strictly into
the port's module and goes through `mal_tpu.convert.torch_weights.convert_pose_dyj` into
`mal_tpu`'s; both take the same three frames, stacked channel-major, and
return (axisangle, translation), each (B, 2, 3), in eval mode."""

import jax.numpy as jnp
import numpy as np
import torch

from mal_tpu.convert.torch_weights import convert_pose_dyj
from mal_tpu.models.encoders import ResnetEncoderDYJ as JResnetEncoderDYJ
from mal_tpu_torch.models.encoders import ResnetEncoderDYJ

from test_torch_common import one_torch_thread  # noqa: F401 (autouse)


def _reference_state(model: torch.nn.Module, seed: int = 0) -> dict:
    """Numpy draws on every tensor of the module's state dict: weights
    scaled by their fan-in, positive running variances."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v.numpy().copy()
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("weight") and v.dim() > 1:
            fan_in = v[0].numel()
            sd[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k.endswith("weight"):          # BN scale
            sd[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:                               # biases, running means
            sd[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
    return sd


def test_pose_dyj_matches_mal_tpu():
    """The outputs at 1e-5 relative and 1e-7 absolute: 0.01 x the spatial
    mean of the head's last conv, after ResNet-18 in fp32."""
    port = ResnetEncoderDYJ(18, 3).eval()
    sd = _reference_state(port)
    assert {"encoder.fc.weight", "net.0.weight", "net.3.bias"} <= set(sd)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    params, batch_stats = convert_pose_dyj(sd, 18)

    frames = np.random.RandomState(1).uniform(
        0, 1, (2, 3, 64, 96, 3)).astype(np.float32)     # (B, T, H, W, 3)
    want = JResnetEncoderDYJ(18, 3).apply(
        {"params": params, "batch_stats": batch_stats}, jnp.asarray(frames))
    with torch.no_grad():
        got = port(torch.from_numpy(frames).permute(0, 1, 4, 2, 3))
    for g, w, what in zip(got, want, ("axisangle", "translation")):
        assert g.shape == (2, 2, 3), what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7, err_msg=what)
