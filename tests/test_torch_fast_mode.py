"""The port's fast mode (`Config(**TRAIN_FAST_SETTINGS)`: bf16 trunks and
payloads, the frozen segmenter's Swin blocks fused and in bf16) against
`mal_tpu`'s, on the CPU at a small size, from the same weights and inputs.

On the CPU the port's K2 / K3 wrappers take their plain versions and
`mal_tpu` runs its Pallas kernels in interpret mode. Both packages round to
bf16 at the same places, so one layer given the same input differs only
where an fp32 sum taken in another order lands on the other side of a bf16
rounding boundary: an ulp (2^-8 of the value) on a few elements.

That does not survive depth. One flipped rounding perturbs every output of
the next layer a little, each of which then flips with a probability of about
its perturbation over its ulp; after a few layers the two packages' rounding
noise is independent, and their distance is that of two bf16 runs, which is
what separates a bf16 run from the fp32 one too. So the comparisons come in
two kinds:

- *layer by layer* (`check_bf16` with `SHARE`, tests/test_torch_common.py):
  each Swin block, ResNet stage and decoder is given `mal_tpu`'s own bf16
  activations as input. Elementwise
  within a stated tolerance, and the mean distance of the port from
  `mal_tpu`'s bf16 output at most `SHARE` of the mean distance of that output
  from the fp32 output on the same input, which is asserted to be there: a
  port that rounded elsewhere, or ran in fp32, fails.
- *end to end* (`END_TO_END`): the whole backbone, segmenter, model and
  training step, where the port may be as far from `mal_tpu`'s bf16 result
  as two independent bf16 runs are from each other, which is sqrt(2) of one
  run's distance from fp32: at most 1.5 times `mal_tpu`'s own bf16-to-fp32
  distance on average, and within a stated elementwise bound.

The fp32 side is `mal_tpu`'s own for the Swin blocks; elsewhere it is the
port's fp32 module on the same input, which tests/test_torch_segment.py and
tests/test_torch_models.py hold against `mal_tpu`'s fp32 at 1e-4, a few per
cent of the distances measured here (running `mal_tpu` a second time in fp32
would double this file's time in the tier-1 run). The depth nets and the
training step are in tests/test_torch_fast_step.py.

The unfused bf16 Swin block differs by design and is held at `UNFUSED_SHARE`:
off the TPU `mal_tpu` computes its attention scores by a bf16 einsum
(`mal_tpu/segment/swin.py:108`), on the TPU by its attention kernel, which
upcasts q, k, v to fp32 (`ops/pallas/window_attention.py:36-38`); the port
follows the TPU and feeds K4 the fp32 cast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mal_tpu.segment.instances import Instances as JInstances
from mal_tpu.segment.mask2former import Mask2Former as JMask2Former
from mal_tpu.segment.mask2former import preprocess_images as j_preprocess
from mal_tpu.segment.pixel_decoder import DeformableEncoderLayer as JEncoderLayer
from mal_tpu.segment.pixel_decoder import MSDeformAttnPixelDecoder as JPixelDecoder
from mal_tpu.segment.swin import CONFIGS
from mal_tpu.segment.swin import PatchMerging as JPatchMerging
from mal_tpu.segment.swin import SwinBlock as JSwinBlock
from mal_tpu.segment.swin import SwinTransformer as JSwin
from mal_tpu.segment.transformer_decoder import MaskedTransformerDecoder as JDecoder
from mal_tpu.temporal import image_synthesis as j_image_synthesis
from mal_tpu_torch.convert.jax_params import (load_jax_mask2former,
                                              mask2former_state_dict)
from mal_tpu_torch.segment.instances import Instances
from mal_tpu_torch.segment.mask2former import Mask2Former
from mal_tpu_torch.segment.swin import SwinTransformer, shift_mask
from mal_tpu_torch.temporal import image_synthesis

from test_torch_common import (END_TO_END, SHARE, as_f32, as_torch,
                               check_bf16)
from test_torch_segment import _random_variables
from test_torch_common import one_torch_thread, run_jitted  # noqa: F401

UNFUSED_SHARE = 0.85   # the unfused bf16 Swin block, see the module docstring
NUM_CLASSES, QUERIES, H, W = 5, 8, 64, 96


# --------------------------------------------------------------------------
# The frozen segmenter
# --------------------------------------------------------------------------

def _port_segmenter(variables=None, **kwargs) -> Mask2Former:
    """The tiny segmenter; without a draw of its weights where they are
    loaded next."""
    kwargs.setdefault("init_weights", variables is None)
    port = Mask2Former(num_classes=NUM_CLASSES, swin_size="tiny",
                       num_queries=QUERIES, device="cpu", **kwargs)
    if variables is not None:
        load_jax_mask2former(port, variables)
    return port


@pytest.fixture(scope="module")
def seg():
    """Random weights on `mal_tpu`'s Mask2Former tree (tiny Swin), an input,
    the port's segmenter carrying them in fast mode and in fp32, and
    `mal_tpu`'s fast Swin features (one jitted call)."""
    jmodel = JMask2Former(num_classes=NUM_CLASSES, swin_size="tiny",
                          num_queries=QUERIES)
    images = np.random.RandomState(1).uniform(
        0, 1, (2, H, W, 3)).astype(np.float32)
    variables = _random_variables(jmodel, jnp.asarray(images))
    x = j_preprocess(jnp.asarray(images))
    fast = _port_segmenter(variables, bf16_backbone=True, fused_swin=True)
    exact = _port_segmenter(init_weights=False)
    exact.load_state_dict(fast.state_dict())
    feats = run_jitted(lambda p, im: JSwin(
        "tiny", bf16_compute=True, fused_block=True).apply(p, im),
        {"params": variables["params"]["backbone"]}, x)
    return variables, x, fast, exact, feats


def _port_backbone(port: Mask2Former, **kwargs) -> SwinTransformer:
    """The tiny Swin in another form, on the fast model's weights."""
    backbone = SwinTransformer("tiny", **kwargs).eval()
    backbone.load_state_dict(port.backbone.state_dict())
    return backbone


def test_one_state_dict_loads_into_every_form(seg):
    """The fused and bf16 forms keep the parameters and their names: the
    state dict converted from `mal_tpu`'s tree (whose keys
    tests/test_torch_segment.py holds against the plain model's) loads
    strictly into the fast segmenter, and the fast backbone's into the other
    forms, as tests/test_swin_block_fused.py::test_param_tree_identical holds
    for `mal_tpu`'s own two trees."""
    variables, _, fast, exact, _ = seg
    converted = mask2former_state_dict(variables["params"], "tiny")
    assert set(converted) == set(fast.state_dict()) == set(exact.state_dict())
    fast.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in converted.items()}, strict=True)
    for kwargs in ({"bf16_compute": True}, {"fused_block": True}):
        other = _port_backbone(fast, **kwargs)
        assert list(other.state_dict()) == list(fast.backbone.state_dict())


@pytest.mark.parametrize("fused", [True, False])
def test_swin_blocks_layer_by_layer(seg, fused):
    """The two blocks of the tiny Swin's first stage (C = 96, the 16x24 map
    padded to 21x28, the second block shifted) and the merging after them,
    each given `mal_tpu`'s own stream as input: the fused bf16 block on the
    bf16 stream, the unfused bf16 block on the fp32 stream. The exact side
    is `mal_tpu`'s own fp32 block on that input. Block outputs of O(1), up
    to ~8: an ulp of the bf16 stream is up to 2^-5, and a flip inside a
    block moves a few outputs by one: 0.1 elementwise. (Wider blocks, other
    windows: tests/test_torch_swin_block.py.)"""
    variables, x, fast, _, _ = seg
    params = variables["params"]["backbone"]
    dim, depths, heads, ws = CONFIGS["tiny"]
    layer = (fast.backbone if fused
             else _port_backbone(fast, bf16_compute=True)).layers[0]
    stream_j, stream_t = ((jnp.bfloat16, torch.bfloat16) if fused
                          else (jnp.float32, torch.float32))
    y = JSwin("tiny").apply({"params": params}, x, max_stage=0)["patch"]
    y = y.astype(stream_j)
    Hs, Ws = y.shape[1:3]
    Hp, Wp = -(-Hs // ws) * ws, -(-Ws // ws) * ws
    assert min(Hp, Wp) > ws and (Hp, Wp) != (Hs, Ws)     # shifted and padded
    mask = shift_mask(Hp, Wp, ws, ws // 2)
    valid = F.pad(torch.ones(Hs, Ws), (0, Wp - Ws, 0, Hp - Hs))
    for b in range(depths[0]):
        p = {"params": jax.tree.map(lambda a: a[b], params["stage0"]["blocks"])}
        flag = jnp.asarray(float(b % 2))
        want = JSwinBlock(dim, heads[0], ws, compute_dtype=jnp.bfloat16,
                          fused_block=fused).apply(p, y, flag)
        exact = JSwinBlock(dim, heads[0], ws).apply(
            p, y.astype(jnp.float32), flag)
        with torch.no_grad():
            got = layer.blocks[b](as_torch(y, stream_t), mask, ws // 2, valid)
        assert got.dtype == stream_t and want.dtype == stream_j
        check_bf16(got, want, exact, atol=0.1,
                   share=SHARE if fused else UNFUSED_SHARE, what=f"block {b}")
        y = want
    if fused:   # the merging reduces in bf16 on the bf16 stream
        p = {"params": params["merge0"]}
        want = JPatchMerging(dim, compute_dtype=jnp.bfloat16).apply(p, y)
        exact = JPatchMerging(dim).apply(p, y.astype(jnp.float32))
        with torch.no_grad():
            got = layer.downsample(as_torch(y, stream_t))
        assert got.dtype == stream_t and want.dtype == stream_j
        check_bf16(got, want, exact, atol=0.1, what="merge 0")


def test_swin_backbone_end_to_end(seg):
    """The whole tiny Swin (12 blocks, C = 96 to 768) in fast mode, in
    unfused bf16 and, for `seg_fused_swin=True` in exact mode, fused in
    fp32. Fast: fp32 LayerNorm outputs of O(1) (up to ~4) after 2 to 12
    blocks on a bf16 stream: 0.1 elementwise, `END_TO_END` on average; the
    first stage's output, two blocks deep, still within 0.35. Unfused bf16
    has no `mal_tpu` run of its own here (see the module docstring): it must
    lie about as near `mal_tpu`'s fast features as two bf16 runs do. Fused
    fp32 against the unfused fp32 Swin: the 5e-4 / 5e-5 of
    tests/test_swin_block_fused.py's backbone test, doubled for the erf
    (`torch.erf` against the Pallas polynomial)."""
    _, x, fast, exact, feats = seg
    with torch.no_grad():
        got = fast.backbone(as_torch(x))
        want_fp32 = exact.backbone(as_torch(x))
        got_unfused = _port_backbone(fast, bf16_compute=True)(as_torch(x))
        got_fp32 = _port_backbone(fast, fused_block=True)(as_torch(x))
    assert set(got) == set(feats)
    for k, want in feats.items():
        assert got[k].dtype == torch.float32 and want.dtype == jnp.float32
        check_bf16(got[k], want, want_fp32[k], atol=0.1,
                   share=0.35 if k == "res2" else END_TO_END, what=k)
        check_bf16(got_unfused[k], want, want_fp32[k], atol=0.15, share=2.0,
                   what=f"unfused {k}")
        torch.testing.assert_close(got_fp32[k], want_fp32[k], rtol=1e-3,
                                   atol=1e-4)


def test_mask2former_in_fast_mode(seg):
    """One encoder layer of the pixel decoder on random inputs (its two FFN
    Linears in bf16 between fp32 norms and an fp32 residual: LayerNorm
    outputs of O(1), an ulp of the bf16 FFN output up to 2^-7 before the
    norm: 0.02 elementwise), then the whole fast segmenter end to end:
    logits (~3) and mask logits (~10) before any threshold, 0.25
    elementwise. `mal_tpu`'s side is its bf16 pixel decoder and its
    predictor on its own fast Swin features, which is what its fast
    `Mask2Former` computes."""
    variables, x, fast, exact, feats = seg
    params = variables["params"]
    rng = np.random.RandomState(4)
    shapes = [(2, 3), (4, 6), (8, 12)]
    S = sum(h * w for h, w in shapes)
    src, pos = (rng.randn(2, S, 256).astype(np.float32) for _ in range(2))
    refs = rng.uniform(0.1, 0.9, (2, S, 3, 2)).astype(np.float32)
    want = JEncoderLayer(bf16_compute=True).apply(
        {"params": params["pixel_decoder"]["layer_0"]}, jnp.asarray(src),
        jnp.asarray(pos), jnp.asarray(refs), shapes)
    with torch.no_grad():
        got, want_fp32 = (
            m.sem_seg_head.pixel_decoder.transformer.encoder.layers[0](
                as_torch(src), as_torch(pos), as_torch(refs), shapes)
            for m in (fast, exact))
    check_bf16(got, want, want_fp32, atol=0.02, what="encoder layer")

    mask_features, multi_scale = JPixelDecoder(bf16_compute=True).apply(
        {"params": params["pixel_decoder"]}, feats)
    want = JDecoder(num_classes=NUM_CLASSES, num_queries=QUERIES).apply(
        {"params": params["predictor"]}, multi_scale, mask_features)
    with torch.no_grad():
        got, want_fp32 = [], []
        for model, out in ((fast, got), (exact, want_fp32)):
            head = model.sem_seg_head
            mf, ms = head.pixel_decoder(model.backbone(as_torch(x)))
            out.extend(head.predictor(ms, mf))
    for g, w, e, what in zip(got, want, want_fp32, ("logits", "masks")):
        check_bf16(g, w, e, atol=0.25, share=END_TO_END, what=what)


# --------------------------------------------------------------------------
# The synthesis with a bf16 payload
# --------------------------------------------------------------------------

def test_image_synthesis_with_a_bf16_payload():
    """Two moving boxes per item, shifted between the adjacent frames: the
    synthesis moves bf16 roundings of the frames and returns fp32. Moving
    and selecting pixels rounds nothing further, so the two packages agree
    exactly, and differ from the fp32 synthesis by the payload's rounding."""
    rng = np.random.RandomState(2)
    B, N, Hs, Ws = 2, 3, 24, 32
    frames = rng.uniform(0, 1, (2, B, Hs, Ws, 3)).astype(np.float32)
    masks = np.zeros((3, B, N, Hs, Ws), np.float32)
    for frame, shift in enumerate((0, -2, 3)):        # current, last, next
        masks[frame, :, 0, 4:10, 6 + shift:14 + shift] = 1.0
        masks[frame, :, 1, 14:20, 18 + shift:26 + shift] = 1.0
    fields = dict(classes=np.tile(np.int32([2, 2, 0]), (B, 1)),
                  scores=np.tile(np.float32([0.9, 0.8, 0.1]), (B, 1)),
                  valid=np.ones((B, N), bool))
    jinst = [JInstances(masks=jnp.asarray(m),
                        **{k: jnp.asarray(v) for k, v in fields.items()})
             for m in masks]
    tinst = [Instances(masks=torch.from_numpy(m.copy()),
                       **{k: torch.from_numpy(v.copy())
                          for k, v in fields.items()}) for m in masks]
    want = j_image_synthesis(*(jnp.asarray(f) for f in frames), *jinst, 0.5,
                             payload_dtype=jnp.bfloat16)
    exact = j_image_synthesis(*(jnp.asarray(f) for f in frames), *jinst, 0.5)
    got = image_synthesis(
        *(torch.from_numpy(f.copy()).permute(0, 3, 1, 2) for f in frames),
        *tinst, 0.5, payload_dtype=torch.bfloat16)
    assert bool(got[2].all()) and bool(np.asarray(want[2]).all())
    for g, w, e in zip(got[:2], want[:2], exact[:2]):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        g = g.permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(g, np.asarray(w))
        assert np.abs(np.asarray(w) - np.asarray(e)).max() > 1e-4
        assert np.abs(g - np.asarray(e)).max() <= 2 ** -8   # [0, 1) pixels
