"""The port's temporal hint against `mal_tpu`'s, on the CPU: the exact
assignment, instance matching, the midpoint synthesis (values and
gradients), and one training step with `temporal` and one with
`main_temporal`.

The instances are hand-made boxes that move between the current frame and
the two adjacent frames (`_scene`): an odd bbox delta (a .5 midpoint, which
both packages round half to even), an instance touching row 0 (the
reference's row-0 quirk), an instance below the score threshold, an
unmatched class and an item whose motion is negative. The steps inject a
deterministic segmenter that hands out the scene's current / last / next
instances in call order, in the style of tests/test_integration.py, so
that matching and synthesis do real work in both packages.
"""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from mal_tpu.models import MALModel as JaxMALModel
from mal_tpu.segment.instances import Instances as JInstances
from mal_tpu.segment.matcher import hungarian_match as j_hungarian
from mal_tpu.segment.matcher import match_instances as j_match
from mal_tpu.temporal import _bbox_bounds as j_bbox
from mal_tpu.temporal import image_synthesis as j_synthesis
from mal_tpu.train.state import make_optimizer as jax_make_optimizer
from mal_tpu.train.step import make_train_step as jax_make_train_step
from mal_tpu_torch.convert.jax_params import load_jax_variables
from mal_tpu_torch.segment.instances import Instances
from mal_tpu_torch.segment.matcher import hungarian_match, match_instances
from mal_tpu_torch.temporal import _bbox_bounds, image_synthesis
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import make_train_step

from test_torch_common import (CFG, nchw, np_batch, run_jitted, to_jax,
                               to_numpy, to_torch, torch_cfg)
from test_torch_common import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_step import (DISTIL_KEYS, DISTIL_RTOL, _draws,
                                   _jax_grads, jax_initial_state)

B, N, H, W = CFG.batch_size, 4, CFG.height, CFG.width


# --------------------------------------------------------------------------
# The exact assignment
# --------------------------------------------------------------------------

_j_hungarian = jax.jit(j_hungarian)


@pytest.mark.parametrize("n,ties", [(2, False), (5, False), (16, False),
                                    (8, True), (16, True)])
def test_hungarian_matches_mal_tpu_and_scipy(n, ties):
    """The optimum scipy finds, and on exact ties (integer costs from a
    small range) the very assignment `mal_tpu` picks."""
    rng = np.random.RandomState(n + 100 * ties)
    costs = (rng.randint(0, 3, (4, n, n)) if ties
             else rng.uniform(0, 10, (4, n, n))).astype(np.float32)
    batched = hungarian_match(costs)     # all four solved side by side
    for cost, got in zip(costs, batched):
        np.testing.assert_array_equal(got, hungarian_match(cost))
        np.testing.assert_array_equal(got, np.asarray(_j_hungarian(cost)))
        ri, ci = linear_sum_assignment(cost)
        np.testing.assert_allclose(cost[got, np.arange(n)].sum(),
                                   cost[ri, ci].sum(), rtol=1e-6)


def test_hungarian_with_big_invalid_costs():
    """Padded slots cost 1e6, as `_pair_cost` sets them."""
    rng = np.random.RandomState(5)
    cost = np.full((16, 16), 1e6, np.float32)
    cost[:5, :5] = rng.uniform(0, 2, (5, 5))
    np.testing.assert_array_equal(hungarian_match(cost),
                                  np.asarray(_j_hungarian(cost)))


# --------------------------------------------------------------------------
# Hand-made instances
# --------------------------------------------------------------------------

def _box(masks, b, n, rows, cols):
    masks[b, n, rows[0]:rows[1], cols[0]:cols[1]] = 1.0


def _instances(boxes):
    """numpy (masks, classes, scores, valid) from {(b, n): (class, score,
    rows, cols)}."""
    masks = np.zeros((B, N, H, W), np.float32)
    classes = np.full((B, N), -1, np.int32)
    scores = np.zeros((B, N), np.float32)
    valid = np.zeros((B, N), bool)
    for (b, n), (c, s, rows, cols) in boxes.items():
        _box(masks, b, n, rows, cols)
        classes[b, n], scores[b, n], valid[b, n] = c, s, True
    return masks, classes, scores, valid


def _scene():
    """(current, last, next) instance sets of a 2-item batch at 64x96."""
    cur = _instances({
        (0, 0): (2, 0.95, (20, 35), (30, 50)),   # car
        (0, 1): (0, 0.97, (0, 12), (60, 70)),    # person on row 0
        (0, 2): (1, 0.30, (40, 50), (5, 15)),    # below the threshold
        (1, 0): (3, 0.99, (30, 45), (60, 80)),
    })
    last = _instances({
        (0, 0): (0, 0.9, (0, 9), (58, 68)),
        (0, 1): (2, 0.9, (20, 35), (25, 45)),
        (0, 2): (5, 0.9, (50, 60), (80, 90)),    # a class nobody has
        (1, 0): (3, 0.9, (30, 45), (66, 86)),
    })
    nxt = _instances({
        (0, 0): (2, 0.9, (22, 37), (35, 56)),    # right delta 11: odd
        (0, 1): (0, 0.9, (0, 14), (62, 72)),     # low delta 5: odd
        (1, 0): (3, 0.9, (30, 45), (52, 74)),    # moves left
        (1, 1): (3, 0.9, (2, 10), (2, 10)),      # a distractor
    })
    return cur, last, nxt


def _port(inst):
    return Instances(*map(torch.from_numpy, inst))


def _jax(inst):
    return JInstances(*map(jnp.asarray, inst))


def test_bbox_bounds_keep_the_row_0_quirk():
    cur, last, nxt = _scene()
    for masks in (cur[0], last[0], nxt[0]):
        got = _bbox_bounds(torch.from_numpy(masks) > 0.5)
        want = jax.vmap(j_bbox)(jnp.asarray(masks > 0.5))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_match_instances():
    cur, last, nxt = _scene()
    cur_t = _port(cur).threshold(0.9)
    got = match_instances(_port(last), _port(nxt), cur_t)
    want = j_match(_jax(last), _jax(nxt), _jax(cur).threshold(0.9))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].sum() == 3   # car, person, item 1's object


def _warped(seed):
    return np.random.RandomState(seed).uniform(0, 1, (B, H, W, 3)).astype(
        np.float32)


def test_image_synthesis_values_and_gradients():
    """Synthesized frames and the gradient of a weighted sum of them with
    respect to the warped frames, against `mal_tpu`'s."""
    cur, last, nxt = _scene()
    wl, wn = _warped(1), _warped(2)
    gl, gn = _warped(3), _warped(4)      # weights of the sum

    def j_fn(a, b):
        sl, sn, has = j_synthesis(a, b, _jax(cur), _jax(last), _jax(nxt),
                                  score_thresh=0.9)
        return jnp.sum(sl * gl) + jnp.sum(sn * gn), (sl, sn, has)

    (_, (jsl, jsn, jhas)), jgrads = jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(wl), jnp.asarray(wn))

    tl = torch.from_numpy(nchw(wl)).requires_grad_()
    tn = torch.from_numpy(nchw(wn)).requires_grad_()
    sl, sn, has = image_synthesis(tl, tn, _port(cur), _port(last), _port(nxt),
                                  score_thresh=0.9)
    ((sl * torch.from_numpy(nchw(gl))).sum()
     + (sn * torch.from_numpy(nchw(gn))).sum()).backward()

    np.testing.assert_array_equal(has.numpy(), np.asarray(jhas))
    assert has.all()
    # where shifted instances overlap, pixel sums round in another order
    for g, w in ((sl, jsl), (sn, jsn), (tl.grad, jgrads[0]),
                 (tn.grad, jgrads[1])):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-6, atol=1e-6)
    # the synthesis moved pixels: it is not the identity
    assert not np.allclose(np.asarray(jsl), wl)


def test_image_synthesis_without_instances_is_identity():
    """No instance anywhere: no matched pair, and the warped frames come
    back unchanged (`temporal.py:168-170`)."""
    empty = Instances.empty(B, N, H, W)
    wl, wn = (torch.from_numpy(nchw(_warped(s))) for s in (5, 6))
    sl, sn, has = image_synthesis(wl, wn, empty, empty, empty)
    assert not has.any()
    assert torch.equal(sl, wl) and torch.equal(sn, wn)


# --------------------------------------------------------------------------
# One training step with the temporal hint
# --------------------------------------------------------------------------

def _segmenters():
    """(mal_tpu seg_fn, port seg_fn): the scene's current, last and next
    instances in call order, as the step calls the segmenter (current
    frame first, then each pair of warped frames)."""
    roles = _scene()
    j_order = itertools.cycle(roles)
    t_order = itertools.cycle(roles)

    def j_seg(seg_variables, images):
        assert images.shape == (B, H, W, 3)
        return _jax(next(j_order))

    def t_seg(images):
        assert tuple(images.shape) == (B, H, W, 3)
        return _port(next(t_order))

    return j_seg, t_seg


@pytest.fixture(scope="module")
def start():
    """`mal_tpu`'s and the port's initial states from the same weights."""
    batch = np_batch(CFG, seed=0, batch_size=B)
    jmodel = JaxMALModel(CFG)
    jstate = jax_initial_state(CFG, jmodel, batch)
    # the port's weights are all loaded next: no draw
    tstate = create_train_state(torch_cfg(CFG), device="cpu",
                                init_weights=False)
    load_jax_variables(tstate.model, to_numpy(jstate.params),
                       to_numpy(jstate.batch_stats))
    return jmodel, jstate, tstate, batch


@pytest.fixture(scope="module", params=["temporal", "main_temporal"])
def stepped(request, start):
    """One step in both packages with the hint on the teacher
    (`temporal`) or on the student (`main_temporal`), and the port's
    metrics of the same step without the hint."""
    jmodel, jstate, tstate0, batch = start
    cfg = CFG.replace(**{request.param: True, "ins_threshold": 0.9})
    j_seg, t_seg = _segmenters()
    jstep = jax_make_train_step(cfg, jmodel, jax_make_optimizer(cfg),
                                seg_fn=j_seg)
    key = jax.random.PRNGKey(1)
    jstate, jm = run_jitted(jstep, jstate, to_jax(batch), key, jnp.zeros(()))
    draws = _draws(key, B, H, W)
    out = {}
    for name, c, seg in (("port", cfg, t_seg), ("plain", CFG, None)):
        tstate = copy.deepcopy(tstate0)
        step = make_train_step(torch_cfg(c), device="cpu", seg_fn=seg)
        tstate, tm = step(tstate, to_torch(batch), 0.0, draws=draws)
        out[name] = (tstate, {k: v.numpy().copy() for k, v in tm.items()})
    jax_out = {"metrics": to_numpy(jm), "mu": to_numpy(jstate.opt_state[1][0].mu),
               "balancer": to_numpy(jstate.balancer)}
    return jax_out, out


def test_temporal_step_loss(stepped):
    # tolerances of tests/test_torch_train_step.py (near-tie flips)
    jax_out, out = stepped
    jm, tm = jax_out["metrics"], out["port"][1]
    for k in ("loss", "ori_loss", "mono_reproj", "multi_reproj",
              "consistency_loss", "distil_loss", "w_ori", "w_distil"):
        rtol = DISTIL_RTOL if k in DISTIL_KEYS else 1e-4
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)
    # both items had a matched pair, and the synthesized frames changed
    # the loss
    assert tm["syn_items"] == B
    assert out["plain"][1]["syn_items"] == 0
    assert abs(tm["loss"] - out["plain"][1]["loss"]) > 1e-4 * abs(tm["loss"])


def test_temporal_step_gradients(stepped):
    # per sub-network, as test_torch_train_step.test_every_gradient: every
    # entry within 3e-2 of the largest, 3e-2 in relative L2
    jax_out, out = stepped
    want = _jax_grads([jax_out], 0)
    got = {n: p.grad.numpy() for n, p in out["port"][0].model.named_parameters()}
    assert set(want) == set(got)
    for net in {name.split(".")[0] for name in want}:
        names = [n for n in want if n.split(".")[0] == net]
        scale = max(np.abs(want[n]).max() for n in names)
        err2 = sum(((got[n] - want[n]) ** 2).sum() for n in names)
        norm2 = sum((want[n] ** 2).sum() for n in names)
        assert np.sqrt(err2 / norm2) <= 3e-2, (net, np.sqrt(err2 / norm2))
        for n in names:
            assert np.abs(got[n] - want[n]).max() <= 3e-2 * scale, n


def test_temporal_step_balancer(stepped):
    jax_out, out = stepped
    jl, tl = jax_out["balancer"], out["port"][0].balancer
    for field in ("w", "running_sum", "prev_total", "prev_mean"):
        np.testing.assert_allclose(getattr(tl, field).numpy(),
                                   getattr(jl, field), rtol=DISTIL_RTOL,
                                   err_msg=field)
    assert float(tl.count) == float(jl.count)
