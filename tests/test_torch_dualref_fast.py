"""DualRefine's fast mode (`**TRAIN_FAST_SETTINGS`: bf16 HRNet and pose
trunks, the DEQ nets fp32) against `mal_tpu`'s, on the CPU at
tests/test_torch_dualref_step.py's shapes (64x96, batch 2, frames 0 / -1 /
+1, Anderson with 4 evaluations, corr radius 2 over 2 levels) and weights.

One jitted `mal_tpu` function: the bf16 training forward (batch
statistics, so that the disparities are not saturated as they are on the
random running statistics), compiled with `xla_allow_excess_precision`
off: by default XLA on the CPU keeps fused bf16 intermediates in fp32, so
`mal_tpu`'s CPU result is not the bf16 computation its code states (its
bf16-to-fp32 distance on the disparities came out 1.1-1.3x smaller, over
six batches, than with every rounding made, as the TPU makes it).

The port's bf16 training forward is held against it as every other bf16
network is (tests/test_torch_fast_mode.py says why): on average no farther
from `mal_tpu`'s bf16 outputs than `END_TO_END` (1.5) times `mal_tpu`'s own
bf16-to-fp32 distance, the fp32 side being the port's fp32 forward
(tests/test_torch_dualref_step.py holds it against `mal_tpu`'s to 1e-7 on
the poses). The disparities (the initial ones at four scales, the refined
ones at two) batch by batch, elementwise within 0.25 (a near-threshold
pixel of the saturating sigmoid moves most); the poses (T0, T* and frame
+1's, 12 numbers a batch each) over six seeded batches together,
elementwise within 1e-2: T* comes out of the DEQ's Gauss-Newton
iterations, which amplify the bf16 noise of the features, so one batch's
ratio ranged 0.2-2.1 over the seeds with the same argmin picks in both
packages (2.1 on the first batch, where the port's own bf16 forward is as
far from fp32: 2.1 times `mal_tpu`'s distance). So that a fault on one
batch cannot hide in the pooled mean, each batch's poses are also held at
`POSE_BATCH_SHARE`, the largest ratio read (2.08) with a margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.dualref.model import DEQDepthPose as JModel
from mal_tpu_torch.config import TRAIN_FAST_SETTINGS

from test_torch_common import (END_TO_END, as_f32, check_bf16,  # noqa: F401
                               nchw, np_batch, one_torch_thread, to_jax,
                               to_numpy)
from test_torch_dualref_step import CFG, B, dualref_variables, port_model

FAST = CFG.replace(**TRAIN_FAST_SETTINGS)
KEYS = ("disp_0_0", "disp_1_0", "disp_2_0", "disp_3_0", "disp_0_1",
        "disp_2_1")
POSES = ("T0", "T*", "pose_p1")
SEEDS = range(6)
POSE_BATCH_SHARE = 3.0   # one batch's poses: ratios read 0.21-2.08


def _port_forward(model, batch):
    aug = {f: torch.from_numpy(nchw(c)) for f, c in batch["color_aug"].items()}
    with torch.no_grad():
        out, poses = model(aug["0"], aug["-1"], torch.from_numpy(batch["K"]),
                           invert=True, train=True, image3=aug["1"])
    got = {k: out[k].permute(0, 2, 3, 1).numpy() for k in KEYS}
    got.update(zip(POSES, (poses[0].numpy(), poses[1].numpy(),
                           out["pose_p1"].numpy())))
    return got


@pytest.fixture(scope="module")
def forwards():
    """Per seeded batch: (mal_tpu bf16, port bf16, port fp32) outputs."""
    params, stats = dualref_variables()
    assert FAST.compute_dtype == "bfloat16"
    model = JModel(FAST)

    def fn(p, s, b):
        return model.apply({"params": p, "batch_stats": s},
                           b["color_aug"]["0"], b["color_aug"]["-1"], b["K"],
                           invert=True, train=True, mutable=["batch_stats"],
                           image3=b["color_aug"]["1"])[0]

    batches = [to_jax(np_batch(CFG, seed=s, batch_size=B)) for s in SEEDS]
    jfn = jax.jit(fn).lower(params, stats, batches[0]).compile(
        {"xla_llvm_disable_expensive_passes": True,
         "xla_allow_excess_precision": False})
    fast, exact = port_model(FAST, params, stats), port_model(CFG, params,
                                                              stats)
    runs = []
    for s, jb in zip(SEEDS, batches):
        out, poses = to_numpy(jfn(params, stats, jb))
        want = {k: as_f32(jnp.asarray(out[k])) for k in KEYS}
        want.update(zip(POSES, (as_f32(poses[0]), as_f32(poses[1]),
                                as_f32(out["pose_p1"]))))
        batch = np_batch(CFG, seed=s, batch_size=B)
        runs.append((want, _port_forward(fast, batch),
                     _port_forward(exact, batch)))
    return runs


@pytest.mark.parametrize("key", KEYS)
def test_fast_disparities(forwards, key):
    for s, (want, got, exact) in zip(SEEDS, forwards):
        w = want[key]
        assert 0.05 < w.mean() < 0.95 and w.std() > 1e-3, (s, w.mean())
        check_bf16(got[key], w, exact[key], atol=0.25, share=END_TO_END,
                   what=f"{key}, batch {s}")


@pytest.mark.parametrize("key", POSES)
def test_fast_poses(forwards, key):
    got, want, exact = (np.stack([run[i][key] for run in forwards])
                        for i in (1, 0, 2))
    check_bf16(got, want, exact, atol=1e-2, share=END_TO_END, what=key)
    for s, run in zip(SEEDS, forwards):
        check_bf16(run[1][key], run[0][key], run[2][key], atol=1e-2,
                   share=POSE_BATCH_SHARE, what=f"{key}, batch {s}")
