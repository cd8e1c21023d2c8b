"""The readings that set `dualrefine_fp32.kitti_triplets`' limits: for
each seed, the sound reference's first steps (one run a seed, shared)
against each variant's, by the cell's comparison (`compare.numbers`).
Variants: `control` and `half_batch` as `readings.py` makes them from the
reference alone; `program`, the port's own compared steps through the
harness's set-up (`train_cell.run`, a window of one step); and
`program.<fault>` with a fault of `dualrefine_faults.py` planted under the
step (`unchanged`, `half_batch`, `gn_skipped`, `solve_cut`).

    python -m gpubench.tools.dualrefine_readings --seeds 1,2,3 \\
        [--variants program,control,program.gn_skipped]

One JSON line a seed and variant, as `readings.py` prints them.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

import torch

from gpubench import compare, dualrefine_faults, spec, train_cell
from gpubench.reference import runner
from gpubench.tools.readings import variant_readings

CELL = "dualrefine_fp32.kitti_triplets"


def program_readings(cell, seed: int, device, fault=None) -> dict:
    """The program's readings of its compared steps, with `fault` planted
    under the step, from the harness's set-up and a window of one step."""
    short = dataclasses.replace(cell, workload={**cell.workload,
                                                "min_steps": 1})
    run = train_cell.run(short, seed, 0.0, False, device, 0, 1,
                         time.perf_counter(), fault=fault)
    return run.readings


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program,control")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = spec.load_cell(CELL)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    groups = cell.workload.get("leaf_groups")
    for seed in (int(s) for s in args.seeds.split(",")):
        ref = runner.readings(cell, seed, device)
        for variant in args.variants.split(","):
            kind, _, fault = variant.partition(".")
            if kind == "program":
                got = program_readings(
                    cell, seed, device,
                    dualrefine_faults.FAULTS[fault] if fault else None)
            else:
                got = variant_readings(cell, seed, variant, device)
            print(json.dumps({"workload": CELL, "seed": seed,
                              "variant": variant,
                              "numbers": compare.numbers(got, ref, groups),
                              "excluded_leaves": len(compare.excluded(ref)),
                              "loss": got["loss"], "ref_loss": ref["loss"]}),
                  flush=True)
            del got
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
