"""The port's MaskFormer-v1 family (`mal_tpu_torch.segment.maskformer_v1`)
against `mal_tpu.segment.maskformer_v1`, on the CPU, with `mal_tpu`'s
parameters carried across (`convert/jax_params.py:load_jax_v1_module`,
`load_jax_maskformer_v1`).

The cases mirror tests/test_maskformer_v1.py: the FPN pixel decoder, the
transformer-encoder pixel decoder, the standard transformer decoder with
and without `return_aux` (with its input projection), `MaskFormerV1` end
to end at Swin-T on a 64x96 image, with `semantic_inference` on both
outputs, and `PerPixelBaselineHead` (both pixel decoders) with its loss.
Weights are numpy draws on the shapes of `mal_tpu`'s tree
(tests/test_torch_segment.py:_random_variables); inputs come from numpy
seeds. Tolerances are stated at each case. On the CPU the Swin's window
attention is K4's plain version; the kernel is held against it on the
card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.segment import maskformer_v1 as jv1
from mal_tpu.segment.inference import semantic_inference as j_semantic
from mal_tpu_torch.convert.jax_params import (load_jax_maskformer_v1,
                                              load_jax_v1_module)
from mal_tpu_torch.segment import maskformer_v1 as tv1
from mal_tpu_torch.segment.inference import semantic_inference

from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_segment import _random_variables

FEATS = ("res2", "res3", "res4", "res5")


def _feats(seed: int, B: int = 2, C0: int = 8) -> dict:
    """tests/test_maskformer_v1.py's pyramid: res2 at 32x48, channels
    doubling from C0."""
    rng = np.random.RandomState(seed)
    return {f: rng.randn(B, 32 >> i, 48 >> i, C0 << i).astype(np.float32)
            for i, f in enumerate(FEATS)}


def _j(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(got, want, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def _channels(feats: dict) -> dict:
    return {k: v.shape[-1] for k, v in feats.items()}


@pytest.mark.parametrize("transformer_enc", [False, True])
def test_pixel_decoders(transformer_enc):
    """The FPN (GN with eps 1e-5, nearest top-down) and the variant with a
    2-layer transformer encoder on res5: the mask features, the three
    levels and the transformer features, at 1e-4 relative and absolute
    (values of O(1) after GroupNorm / LayerNorm)."""
    feats = _feats(0)
    if transformer_enc:
        jmod = jv1.TransformerEncoderPixelDecoder(
            conv_dim=64, mask_dim=32, enc_layers=2, heads=4, ffn_dim=128)
        tmod = tv1.TransformerEncoderPixelDecoder(
            _channels(feats), 64, 32, enc_layers=2, heads=4, ffn_dim=128)
    else:
        jmod = jv1.FPNPixelDecoder(conv_dim=64, mask_dim=32)
        tmod = tv1.FPNPixelDecoder(_channels(feats), 64, 32)
    variables = _random_variables(jmod, _j(feats), seed=1)
    j_mask, j_tf, j_multi = jmod.apply(variables, _j(feats))
    load_jax_v1_module(tmod, variables)
    with torch.no_grad():
        t_mask, t_tf, t_multi = tmod(_t(feats))
    _close(t_mask, j_mask, 1e-4, "mask_features")
    assert len(t_multi) == len(j_multi) == 3
    for i, (g, w) in enumerate(zip(t_multi, j_multi)):
        _close(g, w, 1e-4, f"multi_scale[{i}]")
    if transformer_enc:
        _close(t_tf, j_tf, 1e-4, "transformer_features")
    else:
        assert t_tf is None and j_tf is None


@pytest.mark.parametrize("return_aux", [False, True])
def test_standard_transformer_decoder(return_aux):
    """3 DETR decoder layers over 24-channel features (so the 1x1 input
    projection to the 32-wide decoder runs): logits and mask logits, every
    layer's with `return_aux`, at 1e-4 relative and absolute."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 6, 24).astype(np.float32)
    mf = rng.randn(2, 16, 24, 16).astype(np.float32)
    kw = dict(num_classes=7, hidden_dim=32, num_queries=5, dec_layers=3,
              heads=4, mask_dim=16)
    jmod = jv1.StandardTransformerDecoder(**kw, return_aux=return_aux)
    variables = _random_variables(jmod, jnp.asarray(x), jnp.asarray(mf),
                                  seed=3)
    j_logits, j_masks = jmod.apply(variables, jnp.asarray(x),
                                   jnp.asarray(mf))
    tmod = tv1.StandardTransformerDecoder(24, **kw)
    load_jax_v1_module(tmod, variables)
    with torch.no_grad():
        logits, masks = tmod(torch.from_numpy(x), torch.from_numpy(mf),
                             return_aux)
    lead = (3,) if return_aux else ()
    assert logits.shape == lead + (2, 5, 8)
    assert masks.shape == lead + (2, 5, 16, 24)
    _close(logits, j_logits, 1e-4, "logits")
    _close(masks, j_masks, 1e-4, "masks")


def test_maskformer_v1_end_to_end():
    """Swin-T -> transformer-encoder pixel decoder -> standard decoder on a
    64x96 image, 7 classes, 5 queries, the whole tree carried across
    strictly: logits and mask logits at 1e-4 relative and absolute (as the
    Swin-T Mask2Former's end to end, tests/test_torch_segment.py), and the
    semantic maps of both outputs at 1e-5 absolute."""
    jmodel = jv1.MaskFormerV1(num_classes=7, swin_size="tiny", num_queries=5)
    images = np.random.RandomState(4).uniform(
        0, 1, (1, 64, 96, 3)).astype(np.float32)
    variables = _random_variables(jmodel, jnp.asarray(images), seed=5)
    j_logits, j_masks = jmodel.apply(variables, jnp.asarray(images))
    port = tv1.MaskFormerV1(num_classes=7, swin_size="tiny", num_queries=5,
                            device="cpu", init_weights=False)
    load_jax_maskformer_v1(port, variables)
    with torch.no_grad():
        logits, masks = port(torch.from_numpy(images))
    assert logits.shape == (1, 5, 8) and masks.shape == (1, 5, 16, 24)
    _close(logits, j_logits, 1e-4, "logits")
    _close(masks, j_masks, 1e-4, "masks")
    _close(semantic_inference(logits, masks), j_semantic(j_logits, j_masks),
           1e-5, "semantic")


@pytest.mark.parametrize("transformer_enc", [False, True])
def test_per_pixel_baseline_head(transformer_enc):
    """The head's logits, bilinearly upsampled x4 to 128x192, at 1e-4
    relative and absolute, and its loss on the port's logits against
    `mal_tpu`'s loss on the same logits and targets (ignore label -1,
    weight 2) at 1e-6 relative."""
    feats = _feats(6, B=1)
    jhead = jv1.PerPixelBaselineHead(num_classes=5,
                                     transformer_enc=transformer_enc)
    variables = _random_variables(jhead, _j(feats), seed=7)
    want = jhead.apply(variables, _j(feats))
    head = tv1.PerPixelBaselineHead(_channels(feats), num_classes=5,
                                    transformer_enc=transformer_enc)
    load_jax_v1_module(head, variables)
    with torch.no_grad():
        got = head(_t(feats))
    assert got.shape == (1, 128, 192, 5)
    _close(got, want, 1e-4, "logits")
    targets = np.random.RandomState(8).randint(-1, 5, (1, 128, 192))
    loss = tv1.PerPixelBaselineHead.loss(got, torch.from_numpy(targets),
                                         ignore_value=-1, loss_weight=2.0)
    j_loss = jv1.PerPixelBaselineHead.loss(
        jnp.asarray(got.numpy()), jnp.asarray(targets), ignore_value=-1,
        loss_weight=2.0)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
