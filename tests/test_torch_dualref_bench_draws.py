"""DualRefine's step as the benchmark drives it (`gpubench`'s cell
`dualrefine_fp32.kitti_triplets`), on the CPU at 64x96, batch 2: the one
automask draw a step against the dict of draws, a step of
`make_train_step` on the harness's batch and draws, the model's spans and
counters, and a span in a `torch.profiler` trace. Marked `gpu` (skipped
where no CUDA device is present): the sync counter against the
synchronising operations that `torch.cuda.set_sync_debug_mode` reports,
and the Gauss-Newton kernel's launches.
On a machine with a card:

    python -m pytest --noconftest tests/test_torch_dualref_bench_draws.py -q -s
"""

import collections
import json
import warnings

import pytest
import torch

from gpubench import traffic
from mal_tpu_torch.config import Config
from mal_tpu_torch.dualref.step import make_dualref_loss_fn, noise_keys
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import make_train_step
from mal_tpu_torch.utils import profiling

CFG = Config(method="dualrefine", height=64, width=96, batch_size=2)
MIX = {"pool": 1, "frames": "uniform", "aug_noise": 0.02,
       "intrinsics": [0.58, 1.92, 0.5, 0.5]}
PORT = {"method": "dualrefine", "height": 64, "width": 96, "batch_size": 2}
# a training step at the defaults: the solve's 6 evaluations, the phantom
# unroll's 1 and its recompute in the backward
DEQ_EVALUATIONS = 8
# the spans of one step and their parents on the step's thread (the
# recompute's Gauss-Newton span opens in the backward: on the CPU autograd
# runs it on the step's thread)
NESTING = {("mal.dualref.trunk", "mal.step"): 2,
           ("mal.dualref.solve", "mal.step"): 1,
           ("mal.dualref.gauss_newton", "mal.dualref.solve"): 6,
           ("mal.dualref.phantom", "mal.step"): 1,
           ("mal.dualref.gauss_newton", "mal.dualref.phantom"): 1,
           ("mal.losses", "mal.step"): 1,
           ("mal.backward", "mal.step"): 1,
           ("mal.dualref.gauss_newton", "mal.backward"): 1,
           ("mal.optimizer", "mal.step"): 1,
           ("mal.step", None): 1}


def expected_syncs(cfg: Config) -> int:
    """The synchronising points of a training step at `cfg`'s defaults, as
    the program counts them: the intrinsics scaled once; each photometric
    warp's grid scale copied to the device (two frames for each of the
    supervised states at scales 0 and 2, the one at scale 3, and the pose
    loss's pair); each Gauss-Newton step's pixel offsets and its SE(3)
    exponential's last row (one step an evaluation); each Anderson mixing's
    solve, which checks its factorisation on the host; and the solve's and
    the phantom tap's indexing by an argmin."""
    warps = 2 * (2 * (cfg.deq_n_losses + 1) + 1) + 2
    gauss_newton = 2 * DEQ_EVALUATIONS * cfg.num_pose_iter
    mixings = cfg.deq_iters - 2
    return 1 + warps + gauss_newton + mixings + 2


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def inputs(device: torch.device, seed: int = 5):
    """The harness's batch and draws of pool entry 0 at this size."""
    return traffic.shard_inputs(MIX, PORT, seed, 0, 0, device)


def fresh_state(device: torch.device):
    state = create_train_state(CFG, device, init_weights=False)
    traffic.fill_weights([("model", state.model)], 3, device)
    return state


@pytest.fixture(scope="module")
def recorded_step():
    """One step of `make_train_step` on the harness's inputs, recorded:
    (state before, state after, metrics, records)."""
    cpu = torch.device("cpu")
    state = fresh_state(cpu)
    before = {k: p.detach().clone()
              for k, p in state.model.named_parameters()}
    batch, draws = inputs(cpu)
    step = make_train_step(CFG, cpu)
    with profiling.recording() as records:
        state, metrics = step(state, batch, 0.0, draws=draws)
    return before, state, metrics, records


def test_one_draw_equals_the_dict_that_holds_it_everywhere():
    """A (B, 1, H, W) `noise` gives the loss and gradients of the dict
    whose every key holds that tensor, to the bit."""
    cpu = torch.device("cpu")
    model = fresh_state(cpu).model
    batch, draws = inputs(cpu)
    noise = draws["automask_noise"]
    loss_fn = make_dualref_loss_fn(CFG, model)
    got = {}
    for kind, given in (("dict", {k: noise for k in noise_keys(CFG)}),
                        ("tensor", noise)):
        model.zero_grad(set_to_none=True)
        total, aux = loss_fn(batch, noise=given)
        total.backward()
        got[kind] = (total.detach(), aux["metrics"],
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    (l_d, m_d, g_d), (l_t, m_t, g_t) = got["dict"], got["tensor"]
    assert torch.equal(l_d, l_t) and torch.isfinite(l_t)
    assert m_d.keys() == m_t.keys()
    for k in m_d:
        assert torch.equal(m_d[k], m_t[k]), k
    assert g_d.keys() == g_t.keys() and len(g_t) > 100
    for n in g_d:
        assert torch.equal(g_d[n], g_t[n]), n
    # the draw is read: another draw moves the loss's automasks
    model.zero_grad(set_to_none=True)
    other, _ = loss_fn(batch, noise=-1e5 * noise)
    assert not torch.equal(other.detach(), l_t)


def test_train_step_steps_on_the_harness_inputs(recorded_step):
    before, state, metrics, _ = recorded_step
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    moved = [k for k, p in state.model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert any(k.startswith("cnet_") for k in moved)
    assert any(k.startswith("update_block.") for k in moved)
    # every parameter has Adam's state, those the loss does not reach
    # (the other camera sides' pose nets) with a zero gradient, unmoved
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert all("exp_avg" in state.optimizer.state[p] for p in params)
    for k, p in state.model.named_parameters():
        if k.startswith("pnets.1."):
            assert torch.equal(p.detach(), before[k]), k
    assert bool(state.bins.updated)
    assert float(state.bins.mean_depth) != 1.0


def test_spans_nest_and_count_the_evaluations_and_syncs(recorded_step):
    records = recorded_step[3]
    spans = records.spans
    got = collections.Counter(
        (n, None if p is None else spans[p][0]) for n, _, _, p, _ in spans)
    assert got == collections.Counter(NESTING)
    (step,) = [s for s in spans if s[0] == profiling.STEP]
    for name, start, end, _, index in spans:
        assert index == 0, name
        assert step[1] <= start <= end <= step[2], name
    assert records.counts == {"deq_evaluations": DEQ_EVALUATIONS,
                              "host_syncs": expected_syncs(CFG)}


def test_span_shows_in_a_profiler_trace_only_while_it_is_on():
    from torch.profiler import ProfilerActivity, profile

    assert profiling.span("mal.dualref.solve") is profiling.span("other")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mal.dualref.solve"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "mal.dualref.solve" in names
    with profiling.span("mal.dualref.phantom"):
        torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert "mal.dualref.phantom" not in {e.key for e in prof.key_averages()}
    # recording and profiling at once: both see the span
    with profiling.recording() as records, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mal.dualref.gauss_newton"):
            torch.ones(8)
    assert [s[0] for s in records.spans] == ["mal.dualref.gauss_newton"]
    assert "mal.dualref.gauss_newton" in {e.key for e in prof.key_averages()}


@pytest.mark.gpu
def test_sync_counter_equals_the_synchronising_operations():
    """One tiny DualRefine step on the card after a warm-up step:
    `host_syncs` equals the synchronising operations that the sync debug
    mode reports; prints where they happen."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    state = fresh_state(cuda)
    batch, draws = inputs(cuda)
    step = make_train_step(CFG, cuda)
    state, _ = step(state, batch, 0.0, draws=draws)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                profiling.recording() as records:
            warnings.simplefilter("always")
            state, _ = step(state, batch, 0.0, draws=draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    sites: dict = {}
    for w in syncs:
        key = f"{w.filename}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    print("\nsynchronising operations:", json.dumps(sites, indent=1))
    assert records.counts["deq_evaluations"] == DEQ_EVALUATIONS
    assert (len(syncs) == records.counts["host_syncs"]
            == expected_syncs(CFG))
    # every Gauss-Newton step through the kernel, the recompute's backward
    # through its backward kernel, and neither synchronises
    assert (records.counts["gauss_newton_kernel"]
            == DEQ_EVALUATIONS * CFG.num_pose_iter)
    assert records.counts["gauss_newton_kernel_bwd"] == 1
