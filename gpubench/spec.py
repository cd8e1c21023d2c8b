"""The cell's data, found by the names in `BENCHMARK.json`: the workload
file `workloads/<cell>.json` (what decides `correct`: the compared steps
and their limits; the window's least steps and the traced steps), its
configuration `configs/<config>.json`, its traffic mix
`mixes/<traffic>.json` (`traffic.py`), and the metrics the cell reports,
each read by `metrics/<metric>.py`."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    workload: dict        # workloads/<cell>.json
    config: dict          # configs/<config>.json
    traffic: dict         # mixes/<traffic>.json
    end_to_end: list      # BENCHMARK.json's end-to-end metrics of the cell
    per_layer: list       # ... and its per-layer metrics


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT, entry: dict | None = None
              ) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`; raises KeyError for a cell
    the file does not list. `entry` (config, traffic, chips) stands for the
    file's entry of a cell that it does not list yet (the tests')."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if entry is None:
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    config = json.loads(
        (HERE / "configs" / f"{entry['config']}.json").read_text())
    mix = json.loads((HERE / "mixes" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    return Cell(name, entry["chips"], workload, config, mix, e2e, per_layer)
