"""The port's segmenter inference surface and train mode, on the CPU.

- `semantic_inference` and `semantic_tta` against `mal_tpu`'s at rtol 1e-5
  (TTA through a small deterministic model written in both frameworks, at
  three scales with flip, so that only the resizing, flipping, snapping to
  multiples of 32 and averaging are under test); `panoptic_inference`'s
  integer outputs equal to `mal_tpu`'s, its scores' inputs the same.
- Swin drop-path: the rate schedule of `mal_tpu/segment/swin.py:367`, the
  per-sample keep-masks and scaling, and its reproducibility.
- Train mode takes the kernels' plain versions by the `train` flag (the
  wrappers are replaced by functions that fail, and only the eval forward
  reaches them); the frozen segmenter stays frozen and the kernel wrappers
  still refuse a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.segment import inference as ji
from mal_tpu_torch.segment import inference as ti
from mal_tpu_torch.segment import msdeform, swin
from mal_tpu_torch.segment.mask2former import Mask2Former
from mal_tpu_torch.segment.swin import SwinTransformer, drop_path

from test_torch_common import one_torch_thread  # noqa: F401 (autouse)

B, Q, K = 2, 6, 4


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_semantic_inference():
    rng = np.random.RandomState(0)
    logits = rng.randn(B, Q, K + 1).astype(np.float32)
    masks = (3 * rng.randn(B, Q, 8, 12)).astype(np.float32)
    _close(ti.semantic_inference(torch.from_numpy(logits),
                                 torch.from_numpy(masks)),
           ji.semantic_inference(jnp.asarray(logits), jnp.asarray(masks)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_inference(seed):
    """Confident queries of thing and stuff classes, stuff classes repeated
    (merged into their first segment), background and low-score queries,
    overlapping masks."""
    rng = np.random.RandomState(seed)
    Qp = 12
    logits = rng.randn(B, Qp, K + 1).astype(np.float32)
    cls = rng.randint(0, K + 1, (B, Qp))
    logits[np.arange(B)[:, None], np.arange(Qp)[None], cls] += np.where(
        rng.uniform(size=(B, Qp)) < 0.8, 8.0, 1.0)
    masks = rng.randn(B, Qp, 10, 14).astype(np.float32)
    for b in range(B):                     # a box a query, some overlapping
        for q in range(Qp):
            y, x = rng.randint(0, 7), rng.randint(0, 10)
            masks[b, q] -= 3.0
            masks[b, q, y:y + rng.randint(2, 5), x:x + rng.randint(2, 6)] += 6.0
    thing = np.array([True, False, True, False])
    got = ti.panoptic_inference(torch.from_numpy(logits),
                                torch.from_numpy(masks),
                                torch.from_numpy(thing))
    want = ji.panoptic_inference(jnp.asarray(logits), jnp.asarray(masks),
                                 jnp.asarray(thing))
    for name in ti.PanopticSeg._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.valid.any() and (got.seg > 0).any()


def _toy_models(seed=3):
    """The same small model in both frameworks: class logits from the
    image's mean colour, mask logits from a 4x4 average pool of a colour
    projection."""
    rng = np.random.RandomState(seed)
    wc = rng.randn(3, Q * (K + 1)).astype(np.float32)
    wm = rng.randn(3, Q).astype(np.float32)

    def jax_fn(x):
        b, h, w, _ = x.shape
        logits = (x.mean(axis=(1, 2)) @ wc).reshape(b, Q, K + 1)
        m = (x @ wm).reshape(b, h // 4, 4, w // 4, 4, Q).mean(axis=(2, 4))
        return logits, jnp.moveaxis(m, -1, 1)

    def torch_fn(x):
        b, h, w, _ = x.shape
        logits = (x.mean(dim=(1, 2)) @ torch.from_numpy(wc)).reshape(
            b, Q, K + 1)
        m = (x @ torch.from_numpy(wm)).reshape(b, h // 4, 4, w // 4, 4,
                                               Q).mean(dim=(2, 4))
        return logits, m.permute(0, 3, 1, 2)

    return jax_fn, torch_fn


@pytest.mark.parametrize("hw,scales,flip", [((64, 96), (0.75, 1.0, 1.25),
                                             True),
                                            ((96, 160), (0.5, 1.5), False)])
def test_semantic_tta(hw, scales, flip):
    jax_fn, torch_fn = _toy_models()
    rng = np.random.RandomState(4)
    images = rng.uniform(0, 1, (B,) + hw + (3,)).astype(np.float32)
    got = ti.semantic_tta(torch_fn, torch.from_numpy(images), scales, flip)
    want = ji.semantic_tta(jax_fn, jnp.asarray(images), scales, flip)
    assert got.shape == (B, K) + hw
    _close(got, want)
    assert [ti.snap32(v) for v in (48, 72, 80, 120, 336, 560, 10)] == \
        [64, 64, 64, 128, 320, 576, 32]


def test_drop_path_schedule_and_scaling():
    for size in ("tiny", "small"):
        net = SwinTransformer(size, drop_path_rate=0.3)
        depths = swin.CONFIGS[size][1]
        rates = [b.drop_rate for layer in net.layers for b in layer.blocks]
        np.testing.assert_allclose(rates, np.linspace(0, 0.3, sum(depths)),
                                   rtol=0, atol=1e-12)
    y = torch.randn(4000, 3, 5, 7)
    assert drop_path(y, 0.0, None) is y
    out = drop_path(y, 0.25, torch.Generator().manual_seed(0))
    kept = (out != 0).flatten(1).any(dim=1)
    assert torch.equal(out[kept], y[kept] / 0.75)
    assert (out[~kept] == 0).all()
    share = kept.float().mean().item()
    assert abs(share - 0.75) < 4 * (0.75 * 0.25 / 4000) ** 0.5, share
    again = drop_path(y, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    frozen = Mask2Former(num_classes=K, swin_size="tiny", num_queries=Q,
                         device="cpu")
    trainable = Mask2Former(num_classes=K, swin_size="tiny", num_queries=Q,
                            device="cpu", bgr_input=False
                            ).requires_grad_(True)
    trainable.load_state_dict(frozen.state_dict())
    images = torch.rand((B, 64, 96, 3), generator=torch.Generator()
                        .manual_seed(1))
    return frozen, trainable, images


def _failing(name):
    def fail(*args, **kwargs):
        raise AssertionError(f"{name} reached")
    return fail


def test_train_mode_takes_the_plain_route(tiny, monkeypatch):
    frozen, trainable, images = tiny
    assert not frozen.training and not any(p.requires_grad
                                           for p in frozen.parameters())
    # the `train` argument alone picks the route: both models stay in
    # eval() mode, and only the trainable one's parameters need gradients
    assert not trainable.training and all(p.requires_grad
                                          for p in trainable.parameters())
    with torch.no_grad():
        eval_out = trainable(images)
    monkeypatch.setattr(swin, "window_attention", _failing("K4"))
    monkeypatch.setattr(msdeform, "ms_deform_attn_core", _failing("K5"))
    g = torch.Generator().manual_seed(5)
    logits, masks = trainable(images, return_aux=True, train=True,
                              generator=g)
    (logits.square().mean() + masks.square().mean()).backward()
    assert all(p.grad is not None for p in trainable.parameters())
    # the training forward's last layer is the eval forward's, drop-path
    # aside: here with a trainable model whose drop-path rate is 0.3, so
    # the two differ, and a second draw from the same seed repeats it
    again = trainable(images, train=True,
                      generator=torch.Generator().manual_seed(5))
    assert torch.equal(again[0], logits[-1]) and torch.equal(again[1],
                                                             masks[-1])
    assert not torch.allclose(again[1], eval_out[1])
    with torch.no_grad(), pytest.raises(AssertionError, match="K4"):
        trainable(images)


def test_eval_forward_refuses_a_gradient_and_tta_runs(tiny):
    """Outside `no_grad` the trainable model's eval forward reaches K4's
    wrapper with inputs that require a gradient: it refuses, as it did. The
    TTA of the port's model gives class probabilities at the input's size."""
    frozen, trainable, images = tiny
    with pytest.raises(RuntimeError, match="no backward"):
        trainable(images)
    with torch.no_grad():
        sem = ti.semantic_tta(frozen, images)
    assert sem.shape == (B, K, 64, 96) and torch.isfinite(sem).all()
    assert (sem >= 0).all() and (sem <= Q).all()
