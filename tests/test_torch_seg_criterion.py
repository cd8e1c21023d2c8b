"""The port's Mask2Former set criterion against `mal_tpu`'s, on the CPU:
B 2, Q 8, T 3 (one image with a padded target), 64 points, 3 decoder
layers, with `mal_tpu`'s random points reproduced in JAX from its keys and
injected into the port.

Tolerances: point sampling at 1e-6; the matched queries equal; every loss
term at rtol 1e-5; the gradients of the weighted total with respect to the
logits and the mask logits at a relative L2 of 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.segment import criterion as jc
from mal_tpu_torch.segment import criterion as tc

from test_torch_common import (compiled, jax_criterion_draws,  # noqa: F401
                               one_torch_thread)

L, B, Q, T, K, P = 3, 2, 8, 3, 5, 64
CFG = dict(num_classes=K, num_points=P)
KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    logits = (2.0 * rng.randn(L, B, Q, K + 1)).astype(np.float32)
    masks = (3.0 * rng.randn(L, B, Q, 16, 24)).astype(np.float32)
    labels = rng.randint(0, K, (B, T)).astype(np.int32)
    tgt = np.zeros((B, T, 32, 48), np.float32)
    for b in range(B):
        for t in range(T):
            y, x = rng.randint(0, 24), rng.randint(0, 36)
            tgt[b, t, y:y + rng.randint(4, 9), x:x + rng.randint(6, 13)] = 1
    valid = np.array([[True, True, True], [True, True, False]])
    return logits, masks, labels, tgt, valid


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_point_sample():
    rng = np.random.RandomState(1)
    masks = rng.randn(4, 7, 9).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, (4, 50, 2)).astype(np.float32)
    got = tc.point_sample(torch.from_numpy(masks), torch.from_numpy(coords))
    want = jc.point_sample(jnp.asarray(masks), jnp.asarray(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_matching_equals_mal_tpu(inputs):
    """Each layer's assignment from the same points and costs: `mal_tpu`'s
    device solve per image against the port's one host solve for all."""
    logits, masks, labels, tgt, valid = inputs
    draws = jax_criterion_draws(KEY, L, B, T, P)
    cfg = jc.CriterionConfig(**CFG)
    got = tc.match_predictions(
        torch.from_numpy(logits), torch.from_numpy(masks),
        torch.from_numpy(labels), torch.from_numpy(tgt),
        torch.from_numpy(valid), [d["match"] for d in draws],
        tc.CriterionConfig(**CFG))
    for l in range(L):
        c = jnp.asarray(draws[l]["match"].numpy())
        pred_pts = jc.point_sample(
            jnp.asarray(masks[l]).reshape(B * Q, 16, 24),
            jnp.repeat(c, Q, axis=0)).reshape(B, Q, -1)
        tgt_pts = jc.point_sample(jnp.asarray(tgt).reshape(B * T, 32, 48),
                                  jnp.repeat(c, T, axis=0)).reshape(B, T, -1)
        cost = jax.vmap(jc.match_cost_matrix, in_axes=(0, 0, 0, 0, None))(
            jnp.asarray(logits[l]), pred_pts, jnp.asarray(labels), tgt_pts,
            cfg)
        want = jax.vmap(jc.match_one)(cost, jnp.asarray(valid))
        np.testing.assert_array_equal(got[l].numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def jax_deep(inputs):
    """`mal_tpu`'s deep-supervised losses and the gradient of their
    weighted total, one jitted function."""
    logits, masks, labels, tgt, valid = inputs
    cfg = jc.CriterionConfig(**CFG)
    weights = jc.weight_dict(cfg, L - 1)

    def loss(lg, mk):
        losses = jc.set_criterion_deep(KEY, lg, mk, jnp.asarray(labels),
                                       jnp.asarray(tgt), jnp.asarray(valid),
                                       cfg)
        return jc.weighted_total(losses, weights), losses

    fn = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    args = (jnp.asarray(logits), jnp.asarray(masks))
    (total, losses), grads = compiled(fn, *args)(*args)
    return (float(total), {k: float(v) for k, v in losses.items()},
            [np.asarray(g) for g in grads])


def test_set_criterion_deep_and_gradients(inputs, jax_deep):
    logits, masks, labels, tgt, valid = inputs
    want_total, want_losses, want_grads = jax_deep
    lg = torch.from_numpy(logits).requires_grad_()
    mk = torch.from_numpy(masks).requires_grad_()
    cfg = tc.CriterionConfig(**CFG)
    timings = {}
    losses = tc.set_criterion_deep(
        lg, mk, torch.from_numpy(labels), torch.from_numpy(tgt),
        torch.from_numpy(valid), cfg,
        draws=jax_criterion_draws(KEY, L, B, T, P), timings=timings)
    assert set(losses) == set(want_losses) and len(losses) == 3 * L
    for k, v in want_losses.items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
    total = tc.weighted_total(losses, tc.weight_dict(cfg, L - 1))
    np.testing.assert_allclose(float(total), want_total, rtol=1e-5)
    total.backward()
    for got, want in zip((lg.grad, mk.grad), want_grads, strict=True):
        assert np.abs(want).max() > 0
        assert _rel_l2(got.numpy(), want) <= 1e-4
    assert set(timings) == {"match_copy_ms", "match_solve_ms"}
    assert timings["match_copy_ms"] >= 0 and timings["match_solve_ms"] > 0


def test_one_layer_and_generator_draws(inputs, jax_deep):
    """`set_criterion` is the last layer's unsuffixed terms; draws from a
    generator are reproducible and move the losses only a little."""
    logits, masks, labels, tgt, valid = inputs
    _, want_losses, _ = jax_deep
    cfg = tc.CriterionConfig(**CFG)
    args = (torch.from_numpy(labels), torch.from_numpy(tgt),
            torch.from_numpy(valid), cfg)
    draws = jax_criterion_draws(KEY, L, B, T, P)
    one = tc.set_criterion(torch.from_numpy(logits[-1]),
                           torch.from_numpy(masks[-1]), *args,
                           draws=draws[-1])
    for k, v in one.items():
        np.testing.assert_allclose(float(v), want_losses[k], rtol=1e-5)
    runs = [tc.set_criterion_deep(torch.from_numpy(logits),
                                  torch.from_numpy(masks), *args,
                                  generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert runs[0].keys() == runs[1].keys() == want_losses.keys()
    for k in want_losses:
        assert torch.equal(runs[0][k], runs[1][k]), k
        assert np.isfinite(float(runs[0][k])), k
