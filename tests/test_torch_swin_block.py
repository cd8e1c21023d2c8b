"""The plain versions of kernels K2, K3 (the fused Swin block halves) and K5b
(the sample-major deformable sampler) against `mal_tpu`'s Pallas kernels in
interpret mode, on the CPU, from the same numpy-seeded inputs.

fp32: K2 / K3 at rtol 2e-4, atol 2e-5, the scale at which
tests/test_swin_block_fused.py holds the Pallas kernels against the unfused
block (sums in another order; `torch.erf` against the Pallas polynomial erf
of 1.5e-7 absolute error).

bf16 (a bf16 stream and the bf16 compute type): both sides round at the same
places, so they differ only where an fp32 sum in another order falls on the
other side of a bf16 rounding boundary: single bf16 ulps, on a few elements.
Elementwise that is an ulp or two, which is also how far `mal_tpu`'s bf16
result lies from its fp32 one at its worst element; so besides the elementwise
bound each bf16 case holds the *mean* distance to a fifth of `mal_tpu`'s own
mean bf16-to-fp32 distance on these inputs (asserted to be non-zero), which
is what tells the modes apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.ops.pallas.deform_sample import SAMPLE_TILE
from mal_tpu.ops.pallas.deform_sample import deform_sample_fused as j_sample
from mal_tpu.ops.pallas.swin_block import swin_attn_fused as j_attn
from mal_tpu.ops.pallas.swin_block import swin_mlp_fused as j_mlp
from mal_tpu.segment.swin import _shift_mask as j_shift_mask
from mal_tpu.segment.swin import relative_position_index as j_rpi
from mal_tpu_torch.ops.cuda.deform_sample import deform_sample_fused
from mal_tpu_torch.ops.cuda.swin_block import swin_attn_fused, swin_mlp_fused
from mal_tpu_torch.segment.swin import shift_mask

from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

FP32_TOL = dict(rtol=2e-4, atol=2e-5)
# bf16 outputs of O(1), elementwise: a bf16 ulp is 2^-8 of the value's
# binade, and a rounding flipped upstream moves an output by an ulp or two
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -8)
# bf16, on average: the mean distance of the port from mal_tpu's bf16 result
# may be at most this share of mal_tpu's own mean bf16-to-fp32 distance
BF16_SHARE = 0.2

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dtype)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def _check(got, want, exact, mode):
    """fp32: the fp32 tolerance. bf16: the elementwise bf16 tolerance, and
    the mean distance from `want` (mal_tpu in bf16) within `BF16_SHARE` of
    the mean distance of `want` from `exact` (mal_tpu in fp32)."""
    got, want = _f32(got), _f32(want)
    if mode == "fp32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
        return
    np.testing.assert_allclose(got, want, **BF16_TOL)
    mode_gap = np.abs(want - _f32(exact)).mean()
    assert mode_gap > 1e-4, mode_gap   # the two modes do differ here
    assert np.abs(got - want).mean() <= BF16_SHARE * mode_gap


def _attn_inputs(B, H, W, C, heads, ws, shifted, seed):
    """One block's K2 inputs: the stream padded to window multiples and
    rolled (as `mal_tpu/segment/swin.py:229-235`), `valid`, the parameters
    in flax's layout, the table and the shift mask."""
    rng = np.random.RandomState(seed)
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    shift = ws // 2 if min(Hp, Wp) > ws else 0
    roll = -shift if shifted else 0
    x = np.pad(rng.randn(B, H, W, C).astype(np.float32),
               ((0, 0), (0, Hp - H), (0, Wp - W), (0, 0)))
    valid = np.pad(np.ones((H, W), np.float32), ((0, Hp - H), (0, Wp - W)))
    p = {
        "xr": np.roll(x, (roll, roll), axis=(1, 2)),
        "valid": np.roll(valid, (roll, roll), axis=(0, 1)),
        "ln_s": 1.0 + 0.1 * rng.randn(C), "ln_b": 0.1 * rng.randn(C),
        "wqkv": rng.randn(C, 3 * C) / np.sqrt(C), "bqkv": 0.1 * rng.randn(3 * C),
        "wproj": rng.randn(C, C) / np.sqrt(C), "bproj": 0.1 * rng.randn(C),
        "table": 0.5 * rng.randn((2 * ws - 1) ** 2, heads),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["mask"] = (np.asarray(j_shift_mask(Hp, Wp, ws, shift))
                 if shifted and shift else None)
    return p


def _run_attn(p, heads, ws, mode):
    jdt, tdt = DTYPES[mode]
    N = ws * ws
    bias = p["table"][j_rpi(ws).reshape(-1)].reshape(N, N, heads)
    bias_all = bias.transpose(2, 0, 1)[None]
    if p["mask"] is not None:
        bias_all = bias_all + p["mask"][:, None]
    want = j_attn(jnp.asarray(p["xr"]).astype(jdt), jnp.asarray(p["valid"]),
                  jnp.asarray(p["ln_s"]), jnp.asarray(p["ln_b"]),
                  jnp.asarray(p["wqkv"]), jnp.asarray(p["bqkv"]),
                  jnp.asarray(bias_all), jnp.asarray(p["wproj"]),
                  jnp.asarray(p["bproj"]), window_size=ws, num_heads=heads,
                  compute_dtype=jdt, interpret=True)
    got = swin_attn_fused(
        _t(p["xr"], tdt), _t(p["valid"]), _t(p["ln_s"]), _t(p["ln_b"]),
        _t(p["wqkv"].T), _t(p["bqkv"]), _t(p["table"]),
        None if p["mask"] is None else _t(p["mask"]), _t(p["wproj"].T),
        _t(p["bproj"]), window_size=ws, num_heads=heads, compute_dtype=tdt)
    assert got.dtype == tdt and want.dtype == jdt
    return got, want


# the four structural cases of tests/test_swin_block_fused.py (dim 16, 4
# heads, window 4) and one Swin-L stage-2 block (C = 768, 24 heads, window
# 12), where the Pallas plan streams head groups
ATTN_CASES = [(2, 8, 12, 16, 4, 4, False), (2, 8, 12, 16, 4, 4, True),
              (2, 7, 10, 16, 4, 4, False), (2, 7, 10, 16, 4, 4, True),
              (1, 12, 12, 768, 24, 12, False)]


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,heads,ws,shifted", ATTN_CASES)
def test_k2_plain_matches_pallas_kernel(B, H, W, C, heads, ws, shifted, mode):
    p = _attn_inputs(B, H, W, C, heads, ws, shifted, seed=H + W + C)
    if shifted:
        np.testing.assert_array_equal(
            shift_mask(*p["valid"].shape, ws, ws // 2).numpy(), p["mask"])
    got, want = _run_attn(p, heads, ws, mode)
    exact = _run_attn(p, heads, ws, "fp32")[1] if mode == "bf16" else None
    _check(got, want, exact, mode)


def _run_mlp(p, mode):
    jdt, tdt = DTYPES[mode]
    want = j_mlp(jnp.asarray(p["x"]).astype(jdt), jnp.asarray(p["ln_s"]),
                 jnp.asarray(p["ln_b"]), jnp.asarray(p["w1"]),
                 jnp.asarray(p["b1"]), jnp.asarray(p["w2"]),
                 jnp.asarray(p["b2"]), compute_dtype=jdt, interpret=True)
    got = swin_mlp_fused(_t(p["x"], tdt), _t(p["ln_s"]), _t(p["ln_b"]),
                         _t(p["w1"].T), _t(p["b1"]), _t(p["w2"].T),
                         _t(p["b2"]), compute_dtype=tdt)
    assert got.dtype == tdt and want.dtype == jdt
    return got, want


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("tokens,C", [(192, 16), (140, 16), (144, 768)])
def test_k3_plain_matches_pallas_kernel(tokens, C, mode):
    rng = np.random.RandomState(tokens + C)
    p = {"x": rng.randn(tokens, C), "ln_s": 1.0 + 0.1 * rng.randn(C),
         "ln_b": 0.1 * rng.randn(C), "w1": rng.randn(C, 4 * C) / np.sqrt(C),
         "b1": 0.1 * rng.randn(4 * C),
         "w2": rng.randn(4 * C, C) / np.sqrt(4 * C), "b2": 0.1 * rng.randn(C)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    got, want = _run_mlp(p, mode)
    exact = _run_mlp(p, "fp32")[1] if mode == "bf16" else None
    _check(got, want, exact, mode)


def test_k5b_plain_matches_pallas_kernel():
    """Three levels, coordinates in [-0.2, 1.2] (zeros-padding corners), a
    tail of pad samples with aw = 0. The Pallas kernel interpolates by
    three-pass bf16 products (`mxu_precision="high"`), good to ~2^-16 of
    each value; values of O(1), 12 corners a sample: 1e-4."""
    rng = np.random.RandomState(5)
    G, T, ch = 3, 1, 8
    shapes = ((2, 3), (3, 5), (6, 10))
    vms = [rng.randn(G, h * ch, w).astype(np.float32) for h, w in shapes]
    x, y = (rng.uniform(-0.2, 1.2, (G, T, 3, SAMPLE_TILE)).astype(np.float32)
            for _ in range(2))
    aw = rng.uniform(0, 1, (G, T, 3, SAMPLE_TILE)).astype(np.float32)
    aw[..., -100:] = 0.0
    got = deform_sample_fused(*(_t(a) for a in (*vms, x, y, aw)), shapes, ch)
    want = j_sample(*(jnp.asarray(a) for a in (*vms, x, y, aw)), shapes=shapes,
                    ch=ch, interpret=True)
    assert got.shape == want.shape == (G, T, ch, SAMPLE_TILE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert (got[..., -100:] == 0).all() and got.abs().max() > 1.0
