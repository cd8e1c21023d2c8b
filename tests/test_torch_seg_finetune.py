"""Segmenter fine-tuning in the port against `mal_tpu`, on the CPU: the
training loss of a Swin-T Mask2Former (5 classes, 8 queries, 64x96, batch
2, 3 targets with one padded, 64 points, the colour-correct RGB input,
drop-path 0) and one AdamW step, from the same weights (random draws on
the flax tree's shapes carried by `load_jax_mask2former` into the
trainable model, built without a weight draw) and with `mal_tpu`'s random
points reproduced in JAX from its key and injected. One jitted `mal_tpu`
function gives the stacked decoder outputs, the loss terms, every gradient
and the parameters after `optax.adamw`.

Tolerances: the stacked logits and mask logits of the training forward at
1e-4; every loss term at rtol 1e-4; every parameter's gradient at a
relative L2 of 1.5e-2, the bound the port's step tests hold near ties to
(measured at most 7.6e-4 here); the parameters after the step within
2 lr + 1e-6 of `mal_tpu`'s (where a near-zero gradient's sign flips, Adam's
first step moves an element by +-lr) and within 1e-6 on 99.9 % of
elements (measured: all but 0.025 %). AdamW alone on equal gradients:
within 1e-6 of `optax.adamw` over three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mal_tpu.segment.criterion import CriterionConfig as JCriterionConfig
from mal_tpu.segment.mask2former import Mask2Former as JMask2Former
from mal_tpu.segment.mask2former import mask2former_train_loss as j_loss
from mal_tpu_torch.convert.jax_params import (load_jax_mask2former,
                                              mask2former_state_dict)
from mal_tpu_torch.segment.criterion import CriterionConfig
from mal_tpu_torch.segment.finetune import (make_optimizer,
                                            make_seg_finetune_step)
from mal_tpu_torch.segment.mask2former import (Mask2Former,
                                               mask2former_train_loss)

from test_torch_common import (compiled, jax_criterion_draws,  # noqa: F401
                               one_torch_thread)
from test_torch_segment import _random_variables

K, Q, B, T, H, W, P = 5, 8, 2, 3, 64, 96, 64
LR, WD = 1e-4, 0.05
KEY = jax.random.PRNGKey(11)
LAYERS = 10                       # the queries' prediction and 9 layers'


def _targets(seed=2):
    rng = np.random.RandomState(seed)
    images = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    labels = rng.randint(0, K, (B, T)).astype(np.int32)
    masks = np.zeros((B, T, H, W), np.float32)
    for b in range(B):
        for t in range(T):
            y, x = rng.randint(0, 40), rng.randint(0, 60)
            masks[b, t, y:y + rng.randint(8, 24), x:x + rng.randint(8, 36)] = 1
    valid = np.array([[True, True, True], [True, True, False]])
    return images, labels, masks, valid


@pytest.fixture(scope="module")
def case():
    jmodel = JMask2Former(num_classes=K, swin_size="tiny", num_queries=Q,
                          bgr_input=False, drop_path_rate=0.0)
    images, labels, masks, valid = _targets()
    variables = _random_variables(jmodel, jnp.asarray(images), seed=4)
    ccfg = JCriterionConfig(num_classes=K, num_points=P)
    tx = optax.adamw(LR, weight_decay=WD)

    def fn(v, im, lab, m, val):
        _, kd = jax.random.split(KEY)
        aux = jmodel.apply(v, im, return_aux=True, train=True,
                           rngs={"droppath": kd})
        (total, losses), grads = jax.value_and_grad(
            lambda p: j_loss(jmodel, p, im, lab, m, val, KEY,
                             criterion_cfg=ccfg), has_aux=True)(v)
        updates, _ = tx.update(grads, tx.init(v), v)
        return aux, total, losses, grads, optax.apply_updates(v, updates)

    args = (variables, jnp.asarray(images), jnp.asarray(labels),
            jnp.asarray(masks), jnp.asarray(valid))
    out = jax.tree.map(np.asarray, compiled(fn, *args)(*args))
    return variables, (images, labels, masks, valid), out


def _port(variables):
    model = Mask2Former(num_classes=K, swin_size="tiny", num_queries=Q,
                        device="cpu", init_weights=False, bgr_input=False,
                        drop_path_rate=0.0).requires_grad_(True)
    load_jax_mask2former(model, variables)
    return model


def _draws():
    return jax_criterion_draws(jax.random.split(KEY)[0], LAYERS, B, T, P)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_train_forward_and_loss(case):
    variables, data, (aux, total, losses, grads, _) = case
    model = _port(variables)
    assert all(p.requires_grad for p in model.parameters())
    t = [torch.from_numpy(np.array(a)) for a in data]
    logits, masks = model(t[0], return_aux=True, train=True)
    assert logits.shape == (LAYERS, B, Q, K + 1)
    assert masks.shape == (LAYERS, B, Q, H // 4, W // 4)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), aux[0], **tol)
    np.testing.assert_allclose(masks.detach().numpy(), aux[1], **tol)

    got_total, got = mask2former_train_loss(
        model, *t, criterion_cfg=CriterionConfig(num_classes=K, num_points=P),
        draws=_draws())
    assert set(got) == set(losses) and len(got) == 3 * LAYERS
    for k, v in losses.items():
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got_total.item(), total, rtol=1e-4)

    got_total.backward()
    want = mask2former_state_dict(grads["params"], "tiny")
    worst = 0.0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        w = want[name]
        if not np.any(w):
            np.testing.assert_array_equal(p.grad.numpy(), w, err_msg=name)
            continue
        worst = max(worst, _rel_l2(p.grad.numpy(), w))
    assert worst <= 1.5e-2, worst


def test_one_finetune_step(case):
    """`make_seg_finetune_step` with `make_optimizer`: the four metrics and
    every parameter after the update."""
    variables, data, (_, total, losses, _, updated) = case
    model = _port(variables)
    step = make_seg_finetune_step(
        model, make_optimizer(model, LR, WD),
        CriterionConfig(num_classes=K, num_points=P))
    metrics = step(*[torch.from_numpy(np.array(a)) for a in data],
                   draws=_draws())
    assert set(metrics) == {"loss", "loss_ce", "loss_mask", "loss_dice",
                            "match_copy_ms", "match_solve_ms"}
    np.testing.assert_allclose(float(metrics["loss"]), total, rtol=1e-4)
    for k in ("loss_ce", "loss_mask", "loss_dice"):
        np.testing.assert_allclose(float(metrics[k]), losses[k], rtol=1e-4)
    assert metrics["match_copy_ms"] >= 0 and metrics["match_solve_ms"] > 0
    want = mask2former_state_dict(updated["params"], "tiny")
    before = mask2former_state_dict(variables["params"], "tiny")
    off, n = 0, 0
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name])
        assert d.max() <= 2 * LR + 1e-6, (name, d.max())
        assert not np.array_equal(want[name], before[name]), name
        off += int((d > 1e-6).sum())
        n += d.size
    assert off <= 1e-3 * n, off / n


def test_adamw_matches_optax():
    """`make_optimizer` against `optax.adamw(lr, weight_decay=wd)` on the
    same gradients, three steps, decay on every leaf."""
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    module = torch.nn.Module()
    module.ps = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    opt = make_optimizer(module, 1e-2, 0.05)
    tx = optax.adamw(1e-2, weight_decay=0.05)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for _ in range(3):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        for p, g in zip(module.ps, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
    for p, w in zip(module.ps, jp, strict=True):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6)
