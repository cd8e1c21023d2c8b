"""The device's idle time in a traced sub-window, split by the program's
spans (`mal_tpu_torch.utils.profiling`), and what the span recorder costs.

A run of a training cell's system, built as the harness builds it
(`train_cell.build_system`, the cell's pool of batches, its compared steps
as warm-up), then, per seed:

- `syncs`: one step under `torch.cuda.set_sync_debug_mode("warn")` with
  the recorder on: the synchronising operations it reports, by site,
  against the program's `host_syncs` counter;
- `cost`: windows of `--window` steps with the recorder off, on, on, off:
  frames a second (host clock, a synchronize at the window's end) and the
  90th percentile of the step periods (CUDA events at the boundaries);
- `split`: `--profiled` steps under a profiler that records the device
  alone, with the recorder on: each idle interval of the device, on the
  trace's clock (`baseTimeNanoseconds` + `ts`), goes to the innermost span
  open at that moment (`idle_by_span`), `outside` where none is.

    python -m gpubench.tools.idle_split --workload <cell> --seeds 1,2,3 \\
        [--window 60] [--profiled 3]

prints a JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import tempfile
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

from gpubench import spec, trace, train_cell, traffic
from mal_tpu_torch.utils import profiling

# the spans whose idle the split reports, with the spans counted in each
LAYERS = {"depth_model": ("mal.depth_model",), "losses": ("mal.losses",),
          "segmenter": ("mal.segmenter",),
          "matching": ("mal.matching", "mal.matching.wait",
                       "mal.matching.solve"),
          "backward": ("mal.backward",), "optimizer": ("mal.optimizer",)}
# idle inside these but outside every child span: the glue between layers
GLUE = ("mal.synthesis", "mal.step")
OUTSIDE = "outside"


def idle_intervals(busy: list, start: float, end: float) -> list:
    """The complement of the sorted, disjoint `busy` intervals inside
    [start, end]."""
    out, at = [], start
    for a, b in busy:
        if b <= at:
            continue
        if a >= end:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < end:
        out.append((at, end))
    return out


def innermost_segments(spans: list, start: float, end: float) -> list:
    """[start, end] cut at every span boundary into (a, b, name): the
    innermost span open over [a, b] (the latest started; spans of one
    thread nest), or `OUTSIDE`. `spans` as `Records.spans`, times in ns;
    spans still open count as open to `end`."""
    closed = [(s, end if e is None else e, n) for n, s, e, _, _ in spans]
    cuts = sorted({start, end} | {t for s, e, _ in closed for t in (s, e)
                                  if start < t < end})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        open_ = [(s, i, n) for i, (s, e, n) in enumerate(closed)
                 if s <= mid < e]
        out.append((a, b, max(open_)[2] if open_ else OUTSIDE))
    return out


def idle_by_span(tr: trace.Trace, base_ns: int, spans: list, start_ns: int,
                 end_ns: int) -> dict:
    """Seconds of device idle in [start_ns, end_ns] by the innermost
    program span open at the time (`OUTSIDE` where none is): the idle
    intervals are the complement of the device's busy intervals
    (`trace.merged_intervals`), placed on the spans' clock by the trace's
    `base_ns`. The pieces partition the idle time."""
    busy = [(base_ns + a * 1e3, base_ns + b * 1e3)
            for a, b in trace.merged_intervals(tr)]
    idle = idle_intervals(busy, start_ns, end_ns)
    out: dict[str, float] = {}
    segments = innermost_segments(spans, start_ns, end_ns)
    j = 0
    for a, b in idle:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s, e, name = segments[k]
            overlap = min(b, e) - max(a, s)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap * 1e-9
            k += 1
    return out


def split_metrics(idle: dict, spans: list, counts: dict, steps: int) -> dict:
    """The per-step numbers of a split: `idle_ms.<layer>` for each of
    `LAYERS`, the glue's and `outside`'s idle, `matching_host_ms` (the
    length of `mal.matching.solve`, the host's own work while the device
    has nothing queued) and `host_syncs_per_step`."""
    per = 1e3 / steps
    out = {f"idle_ms.{layer}": sum(idle.get(n, 0.0) for n in names) * per
           for layer, names in LAYERS.items()}
    out["idle_ms.glue"] = sum(idle.get(n, 0.0) for n in GLUE) * per
    out["idle_ms.outside"] = idle.get(OUTSIDE, 0.0) * per
    out["matching_host_ms"] = sum(
        e - s for n, s, e, _, _ in spans
        if n == "mal.matching.solve" and e is not None) * 1e-6 / steps
    out["host_syncs_per_step"] = counts.get("host_syncs", 0) / steps
    return out


def sync_sites(one_step) -> dict:
    """Run `one_step()` under the sync debug mode with the recorder on:
    the synchronising operations by site and the `host_syncs` count."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                profiling.recording() as records:
            warnings.simplefilter("always")
            one_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites: dict[str, int] = {}
    for w in caught:
        if "synchronizing" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return {"reported": sum(sites.values()),
            "host_syncs": records.counts.get("host_syncs", 0),
            "sites": sites}


def window(run_steps, steps: int, on: bool, device, frames: int) -> dict:
    """`steps` steps back to back, the recorder `on` or off: frames a
    second by the host clock and the step periods' p90 by CUDA events."""
    marks = [train_cell._Mark(device) for _ in range(steps + 1)]
    with profiling.recording() if on else contextlib.nullcontext():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(steps):
            run_steps(1)
            marks[i + 1].record()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    periods = [a.ms_to(b) for a, b in zip(marks, marks[1:])]
    return {"on": on, "frames_per_s": frames * steps / seconds,
            "step_ms_p90": train_cell.p90(periods),
            "step_ms_median": statistics.median(periods)}


def split(run_steps, steps: int) -> dict:
    """`steps` steps under a profiler of the device alone with the
    recorder on: the split of the idle, its sum against the window's idle
    as `device_idle_pct` measures it, and the device idle share."""
    torch.cuda.synchronize()
    with profiling.recording() as records, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start_ns = time.time_ns()
        run_steps(steps)
        torch.cuda.synchronize()
        end_ns = time.time_ns()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            base = json.load(f).get("baseTimeNanoseconds", 0)
        tr = trace.read_chrome_trace(path, window_s, steps)
    finally:
        os.unlink(path)
    idle = idle_by_span(tr, base, records.spans, start_ns, end_ns)
    busy = trace.busy_s(tr)
    out = split_metrics(idle, records.spans, records.counts, steps)
    out.update(idle_s=sum(idle.values()), window_idle_s=window_s - busy,
               device_idle_pct=100.0 * (1.0 - busy / window_s),
               window_s=window_s, steps=steps,
               idle_s_by_span={k: v for k, v in sorted(idle.items())})
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--window", type=int, default=60,
                   help="steps a window of the recorder's cost (0: none)")
    p.add_argument("--profiled", type=int, default=0,
                   help="steps of the split (default: the cell's traced "
                        "steps)")
    p.add_argument("--out", default=None, help="append the lines here too")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("idle_split measures a CUDA device and found none")
    cell = spec.load_cell(args.workload)
    if cell.chips != 1:
        sys.exit(f"{cell.name} runs on {cell.chips} cards: one only here")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    train_cell.build_kernels()
    profiled = args.profiled or cell.workload["profiled_steps"]
    frames = cell.config["port_config"].get("batch_size", 12)
    for seed in (int(s) for s in args.seeds.split(",")):
        state, step, seg, _ = train_cell.build_system(cell.config, seed,
                                                      device)
        pool = [traffic.shard_inputs(cell.traffic, cell.config["port_config"],
                                     seed, j, 0, device)
                for j in range(cell.traffic["pool"])]
        done = [0]

        def run_steps(n: int) -> None:
            for _ in range(n):
                batch, draws = pool[done[0] % len(pool)]
                step(state, batch, 0.0, draws=draws)
                done[0] += 1

        run_steps(cell.workload["compared_steps"])
        line = {"workload": cell.name, "seed": seed,
                "device": torch.cuda.get_device_name(device),
                "syncs": sync_sites(lambda: run_steps(1))}
        if args.window:
            line["cost"] = [window(run_steps, args.window, on, device, frames)
                            for on in (False, True, True, False)]
        line["split"] = split(run_steps, profiled)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del state, step, seg, pool
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
