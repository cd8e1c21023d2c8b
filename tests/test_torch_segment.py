"""The port's frozen Mask2Former and its two kernels' plain versions against
`mal_tpu.segment`, on the CPU.

- K4 (window attention) and K5 (deformable sampling): the port's plain
  versions against `mal_tpu`'s Pallas kernels in interpret mode, at 1e-5,
  as tests/test_window_attention.py and tests/test_segment.py hold those
  kernels against their XLA references.
- The modules (Swin, pixel decoder, transformer decoder, the whole
  `Mask2Former(num_classes=5, swin_size="tiny", num_queries=8)` at 64x96)
  with `mal_tpu`'s flax weights carried by `load_jax_mask2former`. The
  weights are random numpy draws on the flax tree's shapes (drawing them
  with flax's own initialisers costs a compile; the values only need to be
  non-trivial: the deformable offsets are not 0, so samples land off the
  pixel centres and outside the maps). Each module gets the same inputs in
  both packages; tolerances are stated beside each comparison.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.convert.mask2former import export_mask2former_state
from mal_tpu.ops.pallas.window_attention import window_attention_fused
from mal_tpu.segment.mask2former import Mask2Former as JMask2Former
from mal_tpu.segment.mask2former import instance_inference as j_inference
from mal_tpu.segment.mask2former import preprocess_images as j_preprocess
from mal_tpu.segment.msdeform import (ms_deform_attn_core_pallas,
                                      ms_deform_attn_core_per_level)
from mal_tpu.segment.pixel_decoder import MSDeformAttnPixelDecoder
from mal_tpu.segment.pixel_decoder import position_embedding_sine as j_pos
from mal_tpu.segment.swin import SwinTransformer as JSwin
from mal_tpu.segment.swin import relative_position_index as j_rpi
from mal_tpu.segment.transformer_decoder import MaskedTransformerDecoder
from mal_tpu_torch.convert.jax_params import (load_jax_mask2former,
                                              mask2former_state_dict)
from mal_tpu_torch.ops.cuda.deform_sample import ms_deform_attn_core
from mal_tpu_torch.ops.cuda.window_attention import (relative_position_index,
                                                     window_attention)
from mal_tpu_torch.segment.mask2former import (Mask2Former,
                                               instance_inference,
                                               preprocess_images)
from mal_tpu_torch.segment.pixel_decoder import position_embedding_sine
from mal_tpu_torch.segment.swin import shift_mask

from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASSES, QUERIES, H, W = 5, 8, 64, 96


def _np(x):
    return np.array(x)   # a writable copy, for torch.from_numpy


# --------------------------------------------------------------------------
# K4: window attention
# --------------------------------------------------------------------------

# (window, images, shifted, heads, padded map): unshifted (nm = 1) and
# shifted blocks (the real shift mask of a 2x2-window map) with 2 heads of
# 32, and a Swin-T-like one: window 7 on the 21x28 map of its stage 2 (12
# windows), 3 heads
@pytest.mark.parametrize("ws,images,shifted,heads,hw", [
    pytest.param(12, 3, False, 2, None, id="12-3-False"),
    pytest.param(12, 2, True, 2, None, id="12-2-True"),
    pytest.param(7, 2, True, 2, None, id="7-2-True"),
    pytest.param(7, 2, True, 3, (21, 28), id="7-2-True-swin-t")])
def test_k4_plain_matches_pallas_kernel(ws, images, shifted, heads, hw):
    """The port's K4 on the CPU (its plain version) against the Pallas
    kernel in interpret mode."""
    N = ws * ws
    Hp, Wp = hw or (2 * ws, 2 * ws)
    nm = (Hp // ws) * (Wp // ws) if shifted else 1
    nW = images * nm
    rng = np.random.RandomState(ws + nm)
    qkv = rng.randn(nW, N, 3 * heads * 32).astype(np.float32)
    table = (0.1 * rng.randn((2 * ws - 1) ** 2, heads)).astype(np.float32)
    mask = shift_mask(Hp, Wp, ws, ws // 2).numpy() if shifted else None
    got = window_attention(torch.from_numpy(qkv), torch.from_numpy(table),
                           None if mask is None else torch.from_numpy(mask),
                           heads)

    assert np.array_equal(relative_position_index(ws), j_rpi(ws))
    bias = table[j_rpi(ws).reshape(-1)].reshape(N, N, heads).transpose(2, 0, 1)
    bias_all = bias[None] if mask is None else bias[None] + mask[:, None]
    q, k, v = (np.ascontiguousarray(
        qkv.reshape(nW, N, 3, heads, 32)[:, :, i].transpose(0, 2, 1, 3))
        for i in range(3))
    want = window_attention_fused(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(bias_all),
                                  num_wins_per_image=nm, interpret=True)
    want = _np(want).transpose(0, 2, 1, 3).reshape(nW, N, heads * 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Hp,Wp,ws", [(48, 168, 12), (24, 84, 12),
                                      (14, 21, 7), (16, 24, 8)])
def test_shift_mask_is_symmetric(Hp, Wp, ws):
    """K4 reads the shift mask by columns as rows, so it must be symmetric;
    Swin-L stage 0 and 1 at 192x640 and the tiny Swin's maps at 64x96."""
    mask = shift_mask(Hp, Wp, ws, ws // 2)
    assert mask.shape == ((Hp // ws) * (Wp // ws), ws * ws, ws * ws)
    assert torch.equal(mask, mask.transpose(1, 2))
    assert (mask != 0).any()


# --------------------------------------------------------------------------
# K5: multi-scale deformable sampling
# --------------------------------------------------------------------------

def test_k5_plain_matches_pallas_kernel_and_per_level():
    """Three levels, locations in [-0.2, 1.2] (zeros-padding corners)."""
    rng = np.random.RandomState(11)
    B, heads, C, L, P, Lq = 2, 4, 8, 3, 4, 37
    shapes = [(6, 10), (3, 5), (2, 3)]
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, heads, C).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (B, Lq, heads, L, P, 2)).astype(np.float32)
    aw = rng.uniform(0, 1, (B, Lq, heads, L, P)).astype(np.float32)
    aw /= aw.sum(axis=(3, 4), keepdims=True)
    got = ms_deform_attn_core(torch.from_numpy(value), shapes,
                              torch.from_numpy(locs), torch.from_numpy(aw))
    args = (jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(aw))
    for want in (ms_deform_attn_core_pallas(*args, interpret=True),
                 ms_deform_attn_core_per_level(*args)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# The modules, with the same weights
# --------------------------------------------------------------------------

def _random_variables(model, *inputs, seed=0):
    """Random numpy values on the shapes of `model.init`'s tree."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":       # Dense (in, out), stacked or not; conv
            fan_in = math.prod(s.shape[-4:-1]) if len(s.shape) == 4 \
                else s.shape[-2]
            a = rng.randn(*s.shape) / np.sqrt(fan_in)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*s.shape)
        elif name in ("bias", "relative_position_bias_table"):
            a = 0.1 * rng.randn(*s.shape)
        else:                      # level and query embeddings
            a = rng.randn(*s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def seg():
    """Both segmenters with the same weights, an input and `mal_tpu`'s
    intermediate outputs, each module run once."""
    jmodel = JMask2Former(num_classes=NUM_CLASSES, swin_size="tiny",
                          num_queries=QUERIES)
    rng = np.random.RandomState(1)
    images = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    variables = _random_variables(jmodel, jnp.asarray(images))
    params = variables["params"]

    x = j_preprocess(jnp.asarray(images))
    feats = JSwin("tiny").apply({"params": params["backbone"]}, x)
    mask_features, multi_scale = MSDeformAttnPixelDecoder().apply(
        {"params": params["pixel_decoder"]}, feats)
    decoded = MaskedTransformerDecoder(
        num_classes=NUM_CLASSES, num_queries=QUERIES).apply(
        {"params": params["predictor"]}, multi_scale, mask_features)
    logits, masks = jmodel.apply(variables, jnp.asarray(images))

    port = Mask2Former(num_classes=NUM_CLASSES, swin_size="tiny",
                       num_queries=QUERIES, device="cpu", init_weights=False)
    load_jax_mask2former(port, variables)
    jax_out = {"x": _np(x), "feats": {k: _np(v) for k, v in feats.items()},
               "mask_features": _np(mask_features),
               "multi_scale": [_np(m) for m in multi_scale],
               "decoded": [_np(d) for d in decoded],
               "logits": _np(logits), "masks": _np(masks)}
    return variables, port, images, jax_out


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), want, err_msg=what,
                               **tol)


def test_preprocessing_and_position_embedding(seg):
    _, port, images, jax_out = seg
    _close(preprocess_images(torch.from_numpy(images), mean=port.pixel_mean,
                             std=port.pixel_std), jax_out["x"],
           dict(rtol=1e-6, atol=1e-5), "preprocess")   # values up to ~2.6
    for h, w in ((2, 3), (8, 12), (48, 160)):
        _close(position_embedding_sine(h, w), _np(j_pos(h, w)),
               dict(rtol=0, atol=1e-5), f"pos {h}x{w}")


def test_swin_features(seg):
    # LayerNorm outputs of O(1) after 10 fp32 blocks: 1e-4
    _, port, _, jax_out = seg
    with torch.no_grad():
        feats = port.backbone(torch.from_numpy(jax_out["x"]))
    assert set(feats) == set(jax_out["feats"])
    for k, want in jax_out["feats"].items():
        _close(feats[k], want, dict(rtol=1e-4, atol=1e-4), k)


def test_pixel_decoder(seg):
    # six deformable layers, each ending in a LayerNorm: 1e-4
    _, port, _, jax_out = seg
    feats = {k: torch.from_numpy(v) for k, v in jax_out["feats"].items()}
    with torch.no_grad():
        mask_features, multi_scale = port.sem_seg_head.pixel_decoder(feats)
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(mask_features, jax_out["mask_features"], tol, "mask_features")
    for i, (g, w) in enumerate(zip(multi_scale, jax_out["multi_scale"],
                                   strict=True)):
        _close(g, w, tol, f"multi_scale[{i}]")


def test_transformer_decoder(seg):
    # logits and mask logits before any threshold: 1e-4 (the masked
    # attention's sigmoid < 0.5 does not flip at these inputs)
    _, port, _, jax_out = seg
    with torch.no_grad():
        logits, masks = port.sem_seg_head.predictor(
            [torch.from_numpy(m) for m in jax_out["multi_scale"]],
            torch.from_numpy(jax_out["mask_features"]))
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(logits, jax_out["decoded"][0], tol, "logits")
    _close(masks, jax_out["decoded"][1], tol, "masks")


def test_mask2former_end_to_end(seg):
    # the whole forward, logits and mask logits before any threshold;
    # mask logits reach ~10 here: 1e-4 relative and absolute
    _, port, images, jax_out = seg
    with torch.no_grad():
        logits, masks = port(torch.from_numpy(images))
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(logits, jax_out["logits"], tol, "logits")
    _close(masks, jax_out["masks"], tol, "masks")


def test_instance_inference(seg):
    """The same logits and mask logits through both packages' top-k and
    thresholding: classes and scores agree; mask bits agree except where
    an upsampled logit lies within rounding of the threshold (none here;
    at most 0.1 % allowed)."""
    _, _, _, jax_out = seg
    logits, masks = jax_out["logits"], jax_out["masks"]
    got = instance_inference(torch.from_numpy(logits), torch.from_numpy(masks),
                             H, W, max_instances=6)
    want = j_inference(jnp.asarray(logits), jnp.asarray(masks), H, W,
                       max_instances=6)
    np.testing.assert_array_equal(got.classes.numpy(), _np(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), _np(want.scores),
                               rtol=1e-5, atol=1e-7)
    assert got.valid.all()
    assert (got.masks.numpy() != _np(want.masks)).mean() <= 1e-3


def test_converter_matches_export(seg):
    """`mask2former_state_dict` writes the keys and values of
    `mal_tpu`'s `export_mask2former_state`, and they are the port
    model's state-dict keys."""
    variables, port, _, _ = seg
    got = mask2former_state_dict(variables["params"], "tiny")
    want = export_mask2former_state(variables, "tiny")
    assert set(got) == set(want) == set(port.state_dict())
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=key)


def test_converter_is_strict(seg):
    variables, port, _, _ = seg
    params = dict(variables["params"])
    extra = {"params": dict(params, stray={"kernel": np.zeros((2, 2))})}
    with pytest.raises(KeyError, match="stray"):
        load_jax_mask2former(port, extra)
    pred = dict(params["predictor"])
    del pred["class_embed"]
    with pytest.raises(KeyError, match="class_embed"):
        load_jax_mask2former(port, {"params": dict(params, predictor=pred)})
