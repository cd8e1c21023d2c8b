"""Data parallelism over processes (`mal_tpu_torch.parallel`) on the CPU.

Two processes, gloo, a `file://` rendezvous under the test's temporary
directory (no port to collide on), spawned once for the file. Each takes
its half of a global batch of 4 at tests/test_torch_common.py's size and
its half of the step's random draws, and steps once in each case:
ManyDepth's default, `pareto`, DynamicDepth (`selec_reproj`, `zero_img`
and the feature-metric loss on) and DualRefine in float64 (as
tests/test_torch_dualref_step.py runs it); then both ranks take the whole
batch as one depth row (1 data x 2 depth, `num_depth_shards=2`), each
running K1's plain version on 8 of the 16 planes, in ManyDepth's default
case ("depth"), held against the one-process ManyDepth step. Each is held
against the port's own one-process step on the whole batch with the same
draws and the same starting state (rank 1 starts from other weights, which the broadcast from
rank 0 replaces), which tests/test_torch_*_step.py hold against `mal_tpu`;
no `mal_tpu` program is built here.

Bounds, those of `mal_tpu`'s own mesh test (tests/test_parallel.py:50-74):
the loss 2e-4 relative, the depth bins and the balancer 1e-5 relative,
every all-reduced gradient and every parameter after the step 5e-5
absolute, and the BatchNorm running statistics 5e-5 absolute as well,
with one exception: in float32 the pose nets' gradients (`pose_encoder`,
`pose`) are held at 1e-2 in relative L2 per sub-network. They flip on a
near tie: a 1e-6 relative change of one input frame moves the
one-process step's pose gradients by the same 7e-3 / 2e-3 (held below),
while every other gradient agrees to ~1e-6 relative (the float64
DualRefine case to ~1e-13). The two ranks end bit for bit equal.

Then the pieces: the global BatchNorm against `BatchNorm2d` on the
concatenated batch, the reductions of `parallel/mesh.py` (also with both
ranks holding the whole batch as replicas, as a depth row's ranks do: the
duplicated sums cancel in every ratio), the refusal of a batch that does
not divide, what a depth axis still refuses, the step in a one-process group against the
plain step, and `cli train` over two processes, where rank 0 alone
validates and writes the checkpoint.

The worker imports neither JAX nor `mal_tpu`.
"""

import contextlib
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mal_tpu_torch.config import Config
from mal_tpu_torch.dualref.step import noise_keys
from mal_tpu_torch.models.resnet import BatchNorm2d
from mal_tpu_torch.parallel import distributed, mesh
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import check_parallel, make_train_step

WORLD = 2
GLOBAL_B = 4
BASE = dict(height=64, width=96, num_depth_bins=16,
            batch_size=GLOBAL_B // WORLD)
CASES = {
    "manydepth": dict(),
    "pareto": dict(pareto=True, loss_blc=False),
    "dynamicdepth": dict(method="dynamicdepth", cv_min=True, cv_set_1=True,
                         cv_pool_th=0.15, loss_blc=False, use_ensemble=False,
                         selec_reproj=True, zero_img=True, feat_loss=True),
    "dualrefine": dict(method="dualrefine", deq_iters=4, corr_radius=2,
                       corr_levels=2),
    # one depth row of both ranks: each takes the whole batch
    "depth": dict(num_depth_shards=WORLD, batch_size=GLOBAL_B),
}
# the one-process step a case is held against, where it is another case's
REFERENCE = {"depth": "manydepth"}
TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 900


def _cfg(case: str) -> Config:
    return Config(**{**BASE, **CASES[case]})


def _global_inputs(case: str):
    """The global batch (numpy-seeded, KITTI-shaped, NHWC) and the step's
    draws, as torch tensors; float64 for DualRefine."""
    cfg = _cfg(case)
    rng = np.random.RandomState(0)
    B, H, W = GLOBAL_B, cfg.height, cfg.width
    color, color_aug = {}, {}
    for f in cfg.frames_to_load:
        c = rng.uniform(0, 1, (B, H, W, 3))
        color[str(f)] = c
        color_aug[str(f)] = np.clip(c + 0.02 * rng.randn(B, H, W, 3), 0, 1)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    K = np.broadcast_to(K, (B, 4, 4)).copy()
    batch = {"color": color, "color_aug": color_aug, "K": K,
             "inv_K": np.linalg.inv(K)}
    if cfg.method == "dynamicdepth":
        doj = np.zeros((B, H, W))
        doj[:, 20:40, 30:60] = 1.0
        doj[1, 5:15, 70:90] = 1.0
        batch.update({"doj_mask": doj, "doj_mask-1": np.roll(doj, -4, 2),
                      "doj_mask+1": np.roll(doj, 4, 2)})
    if cfg.method == "dualrefine":
        draws = {"automask_noise": {k: rng.randn(B, 1, H, W)
                                    for k in noise_keys(cfg)}}
    else:
        draws = {"matching_aug": rng.uniform(0, 1, (B,)),
                 "automask_noise": rng.randn(B, 1, H, W)}
    dtype = torch.float64 if cfg.method == "dualrefine" else torch.float32

    def t(x):
        if isinstance(x, dict):
            return {k: t(v) for k, v in x.items()}
        return torch.from_numpy(np.asarray(x)).to(dtype)

    return t(batch), t(draws)


def _state(case: str, seed: int = 0):
    cfg = _cfg(case)
    state = create_train_state(cfg, "cpu",
                               generator=torch.Generator().manual_seed(seed))
    if cfg.method == "dualrefine":
        state.model.double()
    return state


def _snapshot(state, metrics) -> dict:
    return {"metrics": {k: v.detach().clone() for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in
                      state.model.named_parameters() if p.grad is not None},
            "state": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "bins": {k: v.clone() for k, v in vars(state.bins).items()},
            "balancer": {k: v.clone() for k, v in
                         vars(state.balancer).items()}}


def run_case(case: str, rank: int | None = None, world: int = WORLD,
             nudge: float = 0.0) -> dict:
    """One step of `case` on rank `rank`'s shard in the current process
    group of `world`, or (rank None) on the whole batch in one process;
    `nudge` scales the current augmented frame by 1 + nudge."""
    batch, draws = _global_inputs(case)
    batch["color_aug"]["0"] = batch["color_aug"]["0"] * (1.0 + nudge)
    # rank 1 starts elsewhere: the broadcast gives it rank 0's state
    state = _state(case, seed=1 if rank == 1 else 0)
    if rank is not None:
        mesh.broadcast_state(state)
        # the ranks of a depth row take the same shard
        g = distributed.grid(_cfg(case).num_depth_shards, world, rank)
        batch = mesh.shard_batch(batch, g.data_index, g.n_data)
        draws = mesh.shard_batch(draws, g.data_index, g.n_data)
    state, metrics = make_train_step(_cfg(case), "cpu")(
        state, batch, 0.0, draws=draws)
    return _snapshot(state, metrics)


def _unit_inputs():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(GLOBAL_B, 6, 5, 7).astype(np.float32) * 2
                         + 1)
    g = torch.from_numpy(rng.randn(GLOBAL_B, 6, 5, 7).astype(np.float32))
    values = torch.from_numpy(rng.uniform(0, 1, (GLOBAL_B, 1, 8, 9))
                              .astype(np.float32))
    # the masks' counts differ from rank to rank
    mask = torch.from_numpy((rng.uniform(0, 1, (GLOBAL_B, 1, 8, 9))
                             > np.linspace(0.2, 0.8, GLOBAL_B)[:, None, None,
                                                               None])
                            .astype(np.float32))
    return x, g, values, mask


def run_units(rank: int | None = None, replicas: int = 1) -> dict:
    """The global BatchNorm (output, input gradient, parameter gradients,
    running statistics) and the reductions of `parallel/mesh.py`, on
    rank `rank`'s shard inside a data axis, or on the whole batch; with
    `replicas` = WORLD every rank holds the whole batch, a replica of the
    one shard, as the ranks of a depth row do."""
    x, g, values, mask = _unit_inputs()
    world = 1 if rank is None else WORLD
    if rank is not None and replicas == 1:
        x, g, values, mask = (mesh.shard_batch(a, rank, WORLD)
                              for a in (x, g, values, mask))
    torch.manual_seed(0)
    bn = BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        bn.running_var.fill_(2.0)
    x = x.clone().requires_grad_()
    with mesh.data_axis(world, replicas):
        y = bn(x)
        (y * g).sum().backward()
        mesh.all_reduce_grads(bn.parameters())
        out = {"y": y.detach(), "x_grad": x.grad,
               "w_grad": bn.weight.grad, "b_grad": bn.bias.grad,
               "running_mean": bn.running_mean.clone(),
               "running_var": bn.running_var.clone(),
               "masked_mean": mesh.masked_mean(values, mask),
               "batch_mean": mesh.batch_mean(values),
               "global_mean": mesh.global_mean(values),
               "global_norm": mesh.global_norm(values),
               "element_0": mesh.from_rank0(values[0].sum())}
    return out


def _rank_main(rank: int, init_file: str, out_dir: str) -> None:
    """A worker: join the group and write each case's results."""
    torch.set_num_threads(1)
    distributed.initialize(f"file://{init_file}", WORLD, rank)
    try:
        results = {"units": run_units(rank),
                   "replicated_units": run_units(rank, replicas=WORLD)}
        for case in CASES:
            results[case] = run_case(case, rank)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def _spawn(code: str, cwd: str, n: int = WORLD) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(TESTS), TESTS, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, "-c", code.format(rank=r)],
                             cwd=cwd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def _wait(procs) -> None:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_cli.py says why."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results (spawned first, so that they run while this
    process computes the one-process references) and the references."""
    tmp = tmp_path_factory.mktemp("dp")
    procs = _spawn("from test_torch_parallel import _rank_main; "
                   f"_rank_main({{rank}}, {str(tmp / 'rendezvous')!r}, "
                   f"{str(tmp)!r})", str(tmp))
    try:
        ref = {"units": run_units(),
               "nudged": run_case("manydepth", nudge=1e-6)}
        for case in CASES:
            if case not in REFERENCE:
                ref[case] = run_case(case)
    finally:
        _wait(procs)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]
    for r in range(WORLD):      # ~1 GB each on disk
        os.remove(tmp / f"rank{r}.pt")
    return ref, ranks


def _close(got, want, atol=0.0, rtol=0.0, what=""):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=what)


POSE_NETS = ("pose_encoder", "pose")


def _rel_l2(got: dict, want: dict, net: str) -> float:
    """The relative L2 distance of sub-network `net`'s gradients."""
    names = [k for k in want if k.split(".")[0] == net]
    err = sum(float((got[k].double() - want[k].double()).square().sum())
              for k in names)
    norm = sum(float(want[k].double().square().sum()) for k in names)
    return (err / norm) ** 0.5


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_end_bit_identical(runs, case):
    _, ranks = runs
    a, b = ranks[0][case], ranks[1][case]
    for part in ("metrics", "grads", "state", "bins", "balancer"):
        assert a[part].keys() == b[part].keys(), part
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


@pytest.mark.parametrize("case", list(CASES))
def test_step_equals_the_whole_batch_step(runs, case):
    ref, ranks = runs
    got, want = ranks[0][case], ref[REFERENCE.get(case, case)]
    m, w = got["metrics"], want["metrics"]
    assert m.keys() == w.keys()
    _close(m["loss"], w["loss"], rtol=2e-4, what="loss")
    for k in m:
        _close(m[k], w[k], rtol=2e-4, atol=1e-7, what=k)
    for k in ("min_depth", "max_depth", "mean_depth", "median_depth"):
        _close(got["bins"][k], want["bins"][k], rtol=1e-5, what=k)
    assert bool(got["bins"]["updated"]) == bool(want["bins"]["updated"])
    for k, v in want["balancer"].items():
        _close(got["balancer"][k], v, rtol=1e-5, atol=1e-8, what=k)
    assert got["grads"].keys() == want["grads"].keys()
    flips = () if _cfg(case).method == "dualrefine" else POSE_NETS
    for k, v in want["grads"].items():
        if k.split(".")[0] not in flips:
            _close(got["grads"][k], v, atol=5e-5, what=k)
    for net in flips:
        assert _rel_l2(got["grads"], want["grads"], net) <= 1e-2, net
    for k, v in want["state"].items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got["state"][k], v), k
        else:
            _close(got["state"][k], v, atol=5e-5, what=k)
    # the step moved the weights and the statistics
    assert any(not torch.equal(g, v) for g, v in
               zip(got["state"].values(), _state(case).model.state_dict()
                   .values()))


def test_pose_gradients_flip_under_a_tiny_change(runs):
    """Why the pose nets have their own bound: scaling one input frame by
    1 + 1e-6 moves the one-process step's pose gradients by as much as the
    two-process step differs from it (7e-3 / 2e-3), and the others by
    ~1e-5 at most."""
    ref, _ = runs
    want, nudged = ref["manydepth"]["grads"], ref["nudged"]["grads"]
    for net in POSE_NETS:
        assert _rel_l2(nudged, want, net) > 1e-3, net
    others = {k.split(".")[0] for k in want} - set(POSE_NETS)
    for net in others:
        assert _rel_l2(nudged, want, net) < 1e-4, net


def test_the_broadcast_replaced_rank_1s_weights(runs):
    """Rank 1 started from seed 1; after the step its weights are rank 0's,
    and those of seed 1 were far from them."""
    _, ranks = runs
    other = _state("manydepth", seed=1).model.state_dict()
    got = ranks[1]["manydepth"]["state"]
    far = [k for k, v in other.items() if v.is_floating_point()
           and (v - got[k]).abs().max() > 1e-2]
    assert len(far) > 100


@pytest.mark.parametrize("key", ["y", "x_grad", "w_grad", "b_grad",
                                 "running_mean", "running_var"])
def test_global_batch_norm(runs, key):
    """Each rank's output and input gradient are its rows of the
    concatenated batch's; the parameter gradients (all-reduced) and the
    running statistics (flax's biased variance) are the whole batch's."""
    ref, ranks = runs
    want = ref["units"][key]
    if key in ("y", "x_grad"):
        got = torch.cat([r["units"][key] for r in ranks])
    else:
        got = ranks[0]["units"][key]
        assert torch.equal(got, ranks[1]["units"][key])
    _close(got, want, rtol=1e-5, atol=1e-6, what=key)


@pytest.mark.parametrize("key", ["masked_mean", "batch_mean"])
def test_shares_sum_to_the_global_value(runs, key):
    """A masked mean whose mask count differs between the ranks, and a
    batch mean: the ranks' shares sum to the whole batch's value."""
    ref, ranks = runs
    mask = _unit_inputs()[3]
    half = GLOBAL_B // WORLD
    assert mask[:half].sum() != mask[half:].sum()
    _close(sum(r["units"][key] for r in ranks), ref["units"][key],
           rtol=1e-6, what=key)


@pytest.mark.parametrize("key", ["global_mean", "global_norm", "element_0"])
def test_global_values_on_every_rank(runs, key):
    ref, ranks = runs
    for r in ranks:
        _close(r["units"][key], ref["units"][key], rtol=1e-6, what=key)


@pytest.mark.parametrize("key", ["y", "running_mean", "running_var",
                                 "masked_mean", "batch_mean", "global_mean",
                                 "global_norm", "element_0"])
def test_replicated_shards_cancel_in_every_ratio(runs, key):
    """Both ranks hold the whole batch (a depth row's replicas), and the
    world-wide reductions count it twice: the BatchNorm output and running
    statistics, the global mean, norm and element 0 are still the whole
    batch's on each rank, and the shares of a masked or batch mean still
    sum to it, at the data axis's bounds."""
    ref, ranks = runs
    want = ref["units"][key]
    if key in ("masked_mean", "batch_mean"):
        got = [sum(r["replicated_units"][key] for r in ranks)]
    else:
        got = [r["replicated_units"][key] for r in ranks]
    for g in got:
        _close(g, want, rtol=1e-5, atol=1e-6, what=key)


def test_a_batch_that_does_not_divide_is_refused():
    batch = {"color": {"0": torch.zeros(5, 2)}, "K": torch.zeros(5, 4, 4)}
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(batch, 0, 2)
    half = mesh.shard_batch(batch, 1, 5)
    assert half["color"]["0"].shape == (1, 2)


@pytest.mark.parametrize("shards", [2, 3])
def test_data_shards_in_one_process_name_the_launch(shards):
    cfg = _cfg("manydepth").replace(num_data_shards=shards)
    with pytest.raises(NotImplementedError, match="--coordinator"):
        make_train_step(cfg, "cpu")
    with pytest.raises(ValueError, match="number of processes"):
        check_parallel(cfg, 4)
    for n in (shards, 0, 1):
        check_parallel(cfg.replace(num_data_shards=n), shards)


def test_loader_shards_take_the_same_number_of_batches():
    """Every rank's shard of a split that does not divide takes as many
    batches (each step all-reduces, so one more on a rank would hang), and
    the shards are disjoint."""
    from mal_tpu_torch.data.mono_dataset import DataLoader

    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return {"i": np.array(i)}

    seen = []
    for rank in range(2):
        loader = DataLoader(Items(), 1, shuffle=True, shard=(rank, 2))
        batches = [int(b["i"][0]) for b in loader.epoch(0)]
        assert len(batches) == len(loader) == 2
        seen += batches
    assert len(set(seen)) == 4


@pytest.mark.parametrize("layout", ["one_process", "world", "batch"])
def test_depth_shards_stay_refused(layout):
    """What a depth axis still refuses, each naming the launch: one
    process (make_train_step there), a world that num_depth_shards does
    not divide, and a global batch that the data shards do not divide; a
    world it divides is taken, for every method."""
    cfg = _cfg("manydepth").replace(num_depth_shards=2)
    if layout == "one_process":
        with pytest.raises(NotImplementedError, match="--coordinator"):
            make_train_step(cfg, "cpu")
    elif layout == "world":
        with pytest.raises(ValueError, match="--num_hosts 3"):
            check_parallel(cfg, 3)
    else:
        with pytest.raises(ValueError, match="global batch of 6.*--num_hosts"):
            check_parallel(cfg, 8, global_batch=6)
        check_parallel(cfg, 8, global_batch=8)
    for method in ("manydepth", "dynamicdepth", "dualrefine"):
        check_parallel(cfg.replace(method=method), 4)


def test_one_process_group_step_equals_the_plain_step(tmp_path):
    """At world 1 the step is the plain step, exactly."""
    want = run_case("manydepth")
    distributed.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0)
    try:
        assert distributed.is_distributed() and distributed.world() == 1
        got = run_case("manydepth", rank=0, world=1)
    finally:
        distributed.shutdown()
    for part in ("metrics", "grads", "state", "bins", "balancer"):
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


def test_rank_devices_and_seeds(monkeypatch):
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.rank_device(None, 3) == torch.device("cuda", 1)
    assert distributed.rank_device("cuda", 2) == torch.device("cuda", 0)
    assert distributed.rank_seed(7, 0) == 7
    assert len({distributed.rank_seed(7, r) for r in range(4)}) == 4
    # 2 data x 3 depth: rank r at data r // 3, depth r % 3
    assert [tuple(distributed.grid(3, 6, r)) for r in (0, 2, 3, 5)] == [
        (2, 3, 0, 0), (2, 3, 0, 2), (2, 3, 1, 0), (2, 3, 1, 2)]
    assert tuple(distributed.grid(2, 1, 0)) == (1, 1, 0, 0)
    assert distributed.coordinator_url("10.0.0.1:29500") == \
        "tcp://10.0.0.1:29500"
    with pytest.raises(ValueError, match="host:port"):
        distributed.coordinator_url("10.0.0.1")


def _free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_train_over_two_processes(tmp_path):
    """`cli train --coordinator --num_hosts 2 --host_id i`, once per
    process, on the CLI tests' fake tree and size: 8 training lines, so 2
    steps a rank (validation, and with it the checkpoint, comes at step
    1), on the CPU with gloo. Rank 0 alone logs (and opens its
    `metrics.jsonl`), validates and writes the checkpoint; both ranks take
    their 2 steps."""
    from mal_tpu_torch.data.synthetic import write_fake_kitti

    paths = write_fake_kitti(str(tmp_path), n_train=8, n_test=2,
                             size=(200, 60))
    data = os.path.relpath(paths["data_path"], tmp_path)
    argv = ["train", "--data_path", data, "--gt",
            os.path.relpath(paths["gt"], tmp_path), "--device", "cpu",
            "--coordinator", f"127.0.0.1:{_free_port()}", "--num_hosts", "2",
            "--set", "height=64", "width=96", "batch_size=2",
            "num_depth_bins=16", "compute_dtype='float32'",
            "cv_mxu_precision='highest'", "validate_every=1",
            "validate_from=0", "save_until=0", "log_every=1", "num_epochs=1",
            "ckpt_dir='ck{rank}'", "native_loader=False"]
    code = ("import torch; torch.set_num_threads(1); "
            "from mal_tpu_torch.cli import main; "
            f"t = main({argv!r} + ['--host_id', '{{rank}}']); "
            "print('STEPS', t.step, t.state.step, "
            "sorted(s for s, m in t.logger.history))")
    procs = _spawn(code, str(tmp_path))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    try:
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        steps = [next(line for line in log.splitlines()
                      if line.startswith("STEPS")) for log in logs]
        assert steps[0] == "STEPS 2 2 [0, 1, 1]"   # logged, validated at 1
        assert steps[1] == "STEPS 2 2 []"          # neither
        assert os.path.isfile(tmp_path / "ck0" / "mal_s1" / "step_00000002"
                              / "state.pt")
        assert not os.path.exists(tmp_path / "ck1" / "mal_s1")
        # only rank 0 opens a sink: one metrics.jsonl (and wandb run) a job
        assert os.path.isfile(tmp_path / "ck0" / "metrics.jsonl")
        assert not os.path.exists(tmp_path / "ck1" / "metrics.jsonl")
    finally:
        # a checkpoint with Adam's moments is ~0.5 GB
        for d in ("ck0", "ck1"):
            shutil.rmtree(tmp_path / d, ignore_errors=True)
