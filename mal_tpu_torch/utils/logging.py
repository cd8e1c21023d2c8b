"""Metric sinks: console, JSONL, and wandb when it is installed (the port's
copy of `mal_tpu.utils.logging`).

The reference logs scalars to wandb every 50 steps
(`manydepth/trainer.py:472-492`); `MetricLogger`
(`mal_tpu_torch.train.trainer`) takes any `sink(metrics, step)`, and these
are the standard ones.
"""

from __future__ import annotations

import json
import os
from typing import Callable


def console_sink(metrics: dict, step: int) -> None:
    parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
    print(f"[step {step}] {parts}", flush=True)


def jsonl_sink(path: str) -> Callable[[dict, int], None]:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    f = open(path, "a", buffering=1)

    def sink(metrics: dict, step: int) -> None:
        f.write(json.dumps({"step": step, **metrics}) + "\n")

    return sink


def wandb_sink(project: str = "plug_many", name: str | None = None,
               config: dict | None = None) -> Callable[[dict, int], None]:
    """wandb adapter (project name as the reference's,
    `manydepth/trainer.py:110`). Raises ImportError when wandb is absent."""
    import wandb

    wandb.init(project=project, name=name, config=config or {})

    def sink(metrics: dict, step: int) -> None:
        wandb.log(metrics, step=step)

    return sink


def multi_sink(*sinks: Callable) -> Callable[[dict, int], None]:
    def sink(metrics: dict, step: int) -> None:
        for s in sinks:
            s(metrics, step)

    return sink
