"""A cell cut to a size the CPU tests can run, whatever its method: 64x96
frames, 2 items, 16 depth planes, a Swin-T segmenter of 8 queries (its
blocks unfused: the fused blocks are kernels), a pool of 3 batches; and
whatever more the method's reference package cuts in its
`tiny_cut(config) -> config`, where it has one.

Besides the cells of `BENCHMARK.json`, the tests drive the four-card
data-parallel cell, whose files are here but which `BENCHMARK.json` does
not list yet (PERF.md, Open questions): `PENDING` stands for its entry."""

from __future__ import annotations

import argparse
import dataclasses

from gpubench import spec
from gpubench.reference import runner


PENDING = {"mal_distil_fp32.dp4": {"config": "mal_distil_fp32",
                                   "traffic": "dp4", "chips": 4}}


def full_cell(name: str) -> spec.Cell:
    """The cell at its own size."""
    return spec.load_cell(name, entry=PENDING.get(name))


def tiny_cell(name: str, chips: int = 1) -> spec.Cell:
    cell = full_cell(name)
    config = dict(cell.config)
    pc = dict(config["port_config"], height=64, width=96, batch_size=2,
              num_depth_bins=16)
    if config.get("segmenter"):
        pc["max_instances"] = 4
        config["segmenter"] = dict(config["segmenter"], swin_size="tiny",
                                   num_queries=8, fused_swin=False)
    config["port_config"] = pc
    config["model_flops_per_frame"] = None   # counted at the full size only
    cut = getattr(runner.method_package(config), "tiny_cut", None)
    if cut is not None:
        config = cut(config)
    wl = dict(cell.workload, min_steps=2, profiled_steps=1)
    if chips == 1:
        wl["limits"] = {k: v for k, v in wl["limits"].items()
                        if k != "rank_gap"}
    return dataclasses.replace(cell, config=config, workload=wl, chips=chips,
                               traffic=dict(cell.traffic, pool=3))


def args(seed: int, trace: int = 0) -> argparse.Namespace:
    return argparse.Namespace(seed=seed, seconds=0.01, trace=trace)
