"""The readings that set a cell's limits, from its plain reference alone:
for each seed, the sound reference's first steps against each variant's,
by the cell's comparison (`compare.numbers`). Variants:

- `control`: the reference in the precision below the configuration's
  (its file's `control`, `control.py`);
- `half_batch`: half of the global batch left out, the mean over the rest;
- `no_exchange`: rank 0's shard alone, as a process whose exchange with
  the others is left out would step (cells on several cards);

and the program's own compared steps, through the harness's set-up with a
window of one step, against the reference (`run.measure`, one process):

- `program`: sound, the lower readings;
- `program.<fault>`: with a fault of `faults.py` planted under the step
  (`program.k2_zeroed`, `program.k5_negated`), or a witness in a kernel's
  place (`program.k6_twin`: K6's plain twin).

A state left unchanged reads 1 on `change_gap` by the comparison's
measure and needs no run.

    python -m gpubench.tools.readings --workload <cell> --seeds 1,2,3 \\
        [--variants control,half_batch,no_exchange,program,program.k2_zeroed]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json

import torch

from gpubench import compare, faults, run, spec
from gpubench.reference import runner


def variant_readings(cell, seed: int, variant: str, device) -> dict:
    per = cell.config["port_config"].get("batch_size", 12)
    kwargs = {"control": {"products": cell.config["control"]},
              "half_batch": {"items": slice(0, per * cell.chips // 2)},
              "no_exchange": {"items": slice(0, per)}}[variant]
    return runner.readings(cell, seed, device, **kwargs)


def program_numbers(cell, seed: int, variant: str, device) -> dict:
    """The program's numbers, compared or not, sound (`program`), with a
    fault (`program.<fault>`) or with a witness in a kernel's place
    (`program.<witness>`), from a run with a window of one step."""
    if cell.chips != 1:
        raise ValueError(f"{variant}: the program's readings of a cell on "
                         f"{cell.chips} cards come from its own runs")
    fault = variant.partition(".")[2]
    short = dataclasses.replace(cell, workload={**cell.workload,
                                                "min_steps": 1})
    args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
    result = run.measure(short, args, device, 0, 1, [],
                         fault=faults.VARIANTS[fault] if fault else None)
    return result["numbers"]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="control,half_batch")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    variants = args.variants.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        ref = None
        for variant in variants:
            if variant.startswith("program"):
                print(json.dumps({"workload": cell.name, "seed": seed,
                                  "variant": variant, "numbers":
                                  program_numbers(cell, seed, variant,
                                                  device)}), flush=True)
                continue
            if ref is None:
                ref = runner.readings(cell, seed, device)
            got = variant_readings(cell, seed, variant, device)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "variant": variant,
                              "numbers": compare.numbers(
                                  got, ref, cell.workload.get("leaf_groups")),
                              "excluded_leaves": len(compare.excluded(ref)),
                              "loss": got["loss"], "ref_loss": ref["loss"]}),
                  flush=True)
            del got
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
