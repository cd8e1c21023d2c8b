"""Run one cell of `BENCHMARK.json` and print its result line.

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root, on a machine with the cards the cell asks for.
A cell on several cards runs one process a card: this process is rank 0,
and starts the others as `python -m gpubench.run ... --rank r`, which
join it over TCP on a free local port. With `--trace 0` the line holds
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics and
the profiled window's breakdown. Its last key, `compared`, and the last
lines on standard error give each number that decided `correct` beside
its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import datetime  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the caches of the kernels' compilers: fixed directories inside the checkout
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "gpubench" / "triton",
          "CUDA_CACHE_PATH": ROOT / "build" / "gpubench" / "cuda"}
FORBIDDEN = ("jax", "jaxlib", "flax", "mal_tpu")
WORKER_WAIT_S = 120
COLLECTIVE_TIMEOUT_S = 600


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (`mal_tpu_torch` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    """The `read(ctx)` of `metrics/<name>.py`, end-to-end or per-layer: it
    returns the metric's value, or None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"gpubench.metrics.{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_workers(args, world: int, port: int) -> list:
    cmd = [sys.executable, "-m", "gpubench.run", "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace), "--port", str(port)]
    return [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT,
                             stdout=sys.stderr.fileno())
            for r in range(1, world)]


def join_group(rank: int, world: int, port: int):
    import torch
    import torch.distributed as dist

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return device


def summary(run) -> dict:
    """What rank 0 needs of another process's run."""
    from gpubench import trace

    out = {"peak_bytes": run.peak_bytes, "failed": run.failed,
           "forbidden": forbidden_modules()}
    if run.trace is not None:
        out.update(busy_s=trace.busy_s(run.trace),
                   window_s=run.trace.window_s)
    return out


def main(argv=None) -> int:
    args = parse(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    from gpubench import spec

    cell = spec.load_cell(args.workload)
    if cell.chips > 1:
        # one intra-op thread a process, as torchrun (which `accelerate
        # launch --multi_gpu` runs) sets it: four processes' thread pools
        # would otherwise contend for the host's cores
        os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    world = cell.chips
    workers = []
    try:
        if world > 1 and args.rank == 0:
            args.port = free_port()
            workers = start_workers(args, world, args.port)
        device = (join_group(args.rank, world, args.port) if world > 1
                  else torch.device("cuda", 0))
        return report(measure(cell, args, device, args.rank, world, workers))
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()


def measure(cell, args, device, rank: int, world: int, workers: list,
            fault=None) -> dict | None:
    """Run the cell in this process (rank `rank` of `world`); on rank 0,
    judge and return the result line's object. `fault` (tests only) breaks
    the step underneath (`faults.py`)."""
    from gpubench import train_cell

    run = train_cell.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, rank, world, T_START, fault=fault)
    sync = train_cell.Sync(device, world)
    others = sync.gather(summary(run))
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return None
    for w in workers:
        if w.wait(timeout=WORKER_WAIT_S):
            raise RuntimeError(f"a worker process exited with {w.returncode}")
    result = judge(cell, args, run, others, device)
    result["forbidden"] = sorted({m for o in others for m in o["forbidden"]}
                                 | set(forbidden_modules()))
    return result


def report(result: dict | None) -> int:
    """Print the result line (rank 0), or refuse one: a run that loaded
    JAX or the JAX package prints no result."""
    if result is None:
        return 0
    found = result.pop("forbidden")
    result.pop("numbers")
    if found:
        print(f"gpubench: loaded {found}: the benchmark may load neither "
              f"JAX nor the JAX package", file=sys.stderr)
        return 4
    for name, (value, limit) in result["compared"].items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def judge(cell, args, run, others: list, device) -> dict:
    """The result line: the cell's metrics (its end-to-end metrics, or
    traced its per-layer ones), then the reference's readings against the
    program's (`compare.py`)."""
    import torch

    from gpubench import compare, trace, train_cell
    from gpubench.reference import runner

    wl = cell.workload
    per = cell.config["port_config"].get("batch_size", 12)
    global_batch = per * cell.chips
    peak = max(o["peak_bytes"] for o in others)
    ctx = Context(cell, run, others, global_batch)
    metrics, breakdown = {}, None
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if args.trace:
        breakdown = trace.breakdown(run.trace, run.host_trace)
    t0 = time.perf_counter()
    ref = runner.readings(cell, args.seed, device)
    train_cell.log("reference", t0)
    numbers = compare.numbers(run.readings, ref, wl.get("leaf_groups"))
    ok, table = compare.judge(numbers, wl["limits"])
    nonfinite = max(o["failed"] for o in others)   # global steps: alike
    same_weights = run.readings["weights"] == ref["weights"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    if args.trace:
        dev["busy_s"] = sum(o["busy_s"] for o in others) / len(others)
        dev["window_s"] = sum(o["window_s"] for o in others) / len(others)
    result = {"correct": ok and nonfinite == 0 and same_weights,
              "attempted": run.steps,
              "failed": nonfinite,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {**table, "nonfinite_steps": [nonfinite, 0],
                          "same_weights": [int(same_weights), 1]}
    result["numbers"] = numbers     # all of them, for the readings tool
    return result


@dataclasses.dataclass
class Context:
    """What a metric's reader reads: the cell, rank 0's run (its window,
    step periods and set-up, its traces, the program's launch counters,
    the kernels' launch inputs that `kernels/` kept), every process's peak bytes, busy and window seconds, and
    the global batch."""
    cell: object
    run: object
    others: list
    global_batch: int


if __name__ == "__main__":
    sys.exit(main())
