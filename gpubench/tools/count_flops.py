"""The model FLOPs a frame of a configuration, for its file's
`model_flops_per_frame`: `torch.utils.flop_counter.FlopCounterMode` over
one training step of the plain reference at the configuration's batch
(convolutions, matrix products and attention, forward and backward; the
frozen segmenter's forward only; no elementwise work), divided by the
batch.

    python -m gpubench.tools.count_flops --workload <cell> [--seed n]

(the cell names the configuration; its traffic mix only fills the batch,
whose values move no count).
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import spec, traffic
from gpubench.reference import runner


def count(cell, seed: int, device: torch.device) -> float:
    config = cell.config
    batch_size = config["port_config"].get("batch_size", 12)
    cfg, state, _, seg_fn, _ = runner.build(config, seed, device, batch_size)
    step = runner.make_train_step(config, cfg, device, seg_fn=seg_fn)
    batch, draws = traffic.shard_inputs(cell.traffic, config["port_config"],
                                        seed, 0, 0, device)
    with FlopCounterMode(display=False) as mode:
        step(state, batch, 0.0, draws=draws)
    return mode.get_total_flops() / batch_size


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = spec.load_cell(args.workload)
    flops = count(cell, args.seed, torch.device(args.device))
    print(json.dumps({"config": cell.config["name"],
                      "model_flops_per_frame": flops}))


if __name__ == "__main__":
    main()
