"""A training cell: the port's training step
(`mal_tpu_torch.train.step.make_train_step`) on batches that already sit
on the card, one process per card.

Set-up builds one state from the seed's weights and hands that same state
to the window. Its warm-up steps are the compared steps: they go through
the window's own step and feed, on distinct pool entries, and their
readings (`compare.py`) are taken between them. The window then runs a
fixed number of steps back to back, cycling through the pool, with no
synchronize of its own: a CUDA event at every step boundary gives the step
periods, the host clock the window. Processes agree on that number before
the window from the last warm-up step's time, so the harness adds no
collective inside it. A traced run profiles the last steps of its window
and leaves the others unprofiled.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import sys
import time

import torch

from gpubench import compare, kernels, trace, traffic

SEG_SPAN = "gpubench.segmenter"


@dataclasses.dataclass
class Run:
    """What a process measured, for the result line and the readers."""
    steps: int = 0
    window_s: float = 0.0
    periods_ms: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    peak_bytes: int = 0
    readings: dict = dataclasses.field(default_factory=dict)
    failed: int = 0          # window steps whose loss is not finite
    unprofiled_steps: int = 0
    unprofiled_s: float = 0.0
    trace: trace.Trace | None = None       # the device alone
    host_trace: trace.Trace | None = None  # with the host's operations
    launches: dict = dataclasses.field(default_factory=dict)
    # the launches' inputs each `kernels/<name>.py` with a `capture` kept
    captured: dict = dataclasses.field(default_factory=dict)


def log(what: str, t0: float) -> float:
    """Say on standard error how long a part of set-up took."""
    now = time.perf_counter()
    print(f"gpubench: {what} {now - t0:.3f} s", file=sys.stderr, flush=True)
    return now


def port_config(config: dict):
    """The port's `Config` from a configuration file's `port_config`."""
    from mal_tpu_torch.config import Config

    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in config["port_config"].items()})


def counted_wrappers() -> dict:
    """The port's kernel wrappers, whose `.launches` count their launches."""
    from mal_tpu_torch.ops.cuda import (cost_volume_kernel, deform_sample,
                                        swin_block, window_attention)

    fns = (cost_volume_kernel.plane_sweep_diffs,
           cost_volume_kernel.plane_sweep_diffs_occ,
           swin_block.swin_attn_fused, swin_block.swin_mlp_fused,
           window_attention.window_attention,
           deform_sample.ms_deform_attn_core)
    return {f.__name__: f for f in fns}


def build_kernels() -> None:
    """Every kernel of the port, built in parallel into its cache inside
    the checkout (`build/mal_tpu_torch_kernels/`), or loaded from it."""
    from mal_tpu_torch.ops.cuda import build

    build.build_libraries(sorted(p.stem for p in build.SOURCE_DIR.glob("*.cu")))


def build_system(config: dict, seed: int, device: torch.device,
                 t: float = 0.0):
    """(state, train_step, segmenter, weight names) of the port with the
    seed's weights."""
    from mal_tpu_torch.segment.mask2former import Mask2Former, make_seg_fn
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    cfg = port_config(config)
    with torch.device(device):
        state = create_train_state(cfg, device, init_weights=False)
        t = log("depth model built", t)
        modules = [("model", state.model)]
        seg, seg_fn = None, None
        if config.get("segmenter"):
            seg = Mask2Former(device=device, init_weights=False,
                              **config["segmenter"])
            modules.append(("segmenter", seg))
            inner = make_seg_fn(seg, cfg.max_instances)

            def seg_fn(images):
                with torch.profiler.record_function(SEG_SPAN):
                    return inner(images)
            t = log("segmenter built", t)
    names = traffic.fill_weights(modules, seed, device)
    step = make_train_step(cfg, device, seg_fn=seg_fn)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log("weights drawn", t)
    return state, step, seg, names


class Sync:
    """The device's synchronize, and the collectives between processes
    (none in one process)."""

    def __init__(self, device: torch.device, world: int):
        self.device, self.world = device, world

    def __call__(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def max(self, value: float) -> float:
        if self.world == 1:
            return value
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def rank_gap(optimizer, sync: Sync) -> float:
    """The largest |parameter - rank 0's| over every rank's parameters."""
    if sync.world == 1:
        return 0.0
    import torch.distributed as dist

    mine = torch.cat([p.detach().reshape(-1) for g in optimizer.param_groups
                      for p in g["params"]])
    rank0 = mine.clone()
    dist.broadcast(rank0, 0)
    gap = (mine - rank0).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        rank: int, world: int, t_start: float, fault=None) -> Run:
    """One process's part of a run of a training cell: set-up with the
    compared steps, the window, and the traced steps (`traced`). `fault`
    (tests only) breaks the step underneath: see `faults.py`."""
    wl = cell.workload
    sync = Sync(device, world)
    t = log("imports and process group", t_start)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        build_kernels()
        t = log("kernels built or loaded", t)
    state, step, seg, names = build_system(cell.config, seed, device, t)
    if fault is not None:
        step = fault(step)
    t = time.perf_counter()
    pool = [traffic.shard_inputs(cell.traffic, cell.config["port_config"],
                                 seed, j, rank, device)
            for j in range(cell.traffic["pool"])]
    sync()
    t = log("pool of batches", t)
    out = Run()

    def one(i: int):
        batch, draws = pool[i % len(pool)]
        return step(state, batch, 0.0, draws=draws)[1]

    # set-up: the compared steps, which also warm up every shape
    start = compare.snapshot(state.optimizer)
    seg_out = compare.SegmenterFeatures(seg)
    cost_out = compare.FirstOutput(state.model, "consistency_mask")
    losses = []
    for i in range(wl["compared_steps"]):
        t0 = time.perf_counter()
        metrics = one(i)
        sync()
        step_s = time.perf_counter() - t0
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = compare.grad_norms(state.optimizer)
            seg_first = seg_out.detach()
            cost_first = cost_out.detach()
        t = log(f"compared step {i + 1}", t)
    out.readings = {
        "loss": losses, "grad": grads, "names": compare.leaf_names(
            state.model, state.optimizer),
        "change": compare.change_norms(state.optimizer, start),
        "state": compare.state_values(state.bins, state.balancer),
        "seg": seg_first, "confidence": cost_first, "weights": names}
    if world > 1:
        out.readings["rank_gap"] = rank_gap(state.optimizer, sync)
    del start
    steps = max(wl["min_steps"], math.ceil(seconds / sync.max(step_s)))
    profiled = wl["profiled_steps"] if traced else 0
    steps = max(steps, 2 * profiled + 1)
    first = wl["compared_steps"]
    kept = []

    def steps_from(i0: int, n: int) -> None:
        for i in range(i0, i0 + n):
            kept.append(one(i))

    sync()
    out.setup_s = time.perf_counter() - t_start
    if not traced:
        marks = [_Mark(device) for _ in range(steps + 1)]
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(steps):
            kept.append(one(first + i))
            marks[i + 1].record()
        sync()
        out.window_s = time.perf_counter() - t0
        out.periods_ms = [a.ms_to(b) for a, b in zip(marks, marks[1:])]
        q = max(1, steps // 4)
        print("gpubench: window step ms, median by quarter: " + ", ".join(
            f"{statistics.median(out.periods_ms[i:i + q]):.2f}"
            for i in range(0, min(steps, q * 4), q)), file=sys.stderr,
            flush=True)
    else:
        unprofiled = steps - 2 * profiled
        t0 = time.perf_counter()
        steps_from(first, unprofiled)
        sync()
        out.unprofiled_s = time.perf_counter() - t0
        out.unprofiled_steps = unprofiled
        counters = counted_wrappers() if device.type == "cuda" else {}
        before = {k: f.launches for k, f in counters.items()}
        hooks = kernels.capture(state.model, out.captured)
        try:
            out.trace = trace.profile_steps(
                lambda n: steps_from(first + unprofiled, n), profiled, sync,
                time.perf_counter, host=False)
        finally:
            for hook in hooks:
                hook.remove()
        out.host_trace = trace.profile_steps(
            lambda n: steps_from(first + unprofiled + profiled, n), profiled,
            sync, time.perf_counter, host=True)
        out.launches = {k: (f.launches - before[k]) / (2 * profiled)
                        for k, f in counters.items()}
    out.steps = steps
    if device.type == "cuda":
        out.peak_bytes = torch.cuda.max_memory_allocated(device)
    out.failed = int((~torch.stack([m["loss"].reshape(()) for m in kept])
                      .isfinite()).sum())
    del kept, pool, state, step, seg
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


class _Mark:
    """A step boundary: a CUDA event recorded on the stream, or on the CPU
    (the tests' runs, where a step is done when it returns) the host
    clock."""

    def __init__(self, device: torch.device):
        self.event = (torch.cuda.Event(enable_timing=True)
                      if device.type == "cuda" else None)
        self.t = 0.0

    def record(self) -> None:
        if self.event is not None:
            self.event.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, later: "_Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return (later.t - self.t) * 1e3


def p90(values: list[float]) -> float:
    """The 90th percentile (inclusive quantiles)."""
    return statistics.quantiles(values, n=10, method="inclusive")[-1]
