"""The reference's readings of a training cell's first steps: the frozen
copy's training step, in one process, from the seed's weights on the
global batch of the same pool entries and draws the program stepped on.

The configuration's `port_config` names the depth method ("manydepth"
where it names none). ManyDepth's reference is the modules beside this
one; any other method's is the package `gpubench/reference/<method>/`,
found by that name, with `build(config, seed, device, batch)` and
`make_train_step(cfg, device, seg_fn=None)` as below.

`items` keeps part of each batch (a fault: half of the batch left out,
the mean over the rest; or one process's shard alone: the exchange
between processes left out). `products` runs it under the control's
rounding (`gpubench/control.py`)."""

from __future__ import annotations

import contextlib
import importlib
from pathlib import Path

import torch

from gpubench import compare, traffic

HERE = Path(__file__).resolve().parent


def method_package(config: dict):
    """The reference package of the configuration's method, or None for
    ManyDepth, whose reference this module builds itself."""
    method = config["port_config"].get("method", "manydepth")
    if method == "manydepth":
        return None
    if not (HERE / method / "__init__.py").is_file():
        raise FileNotFoundError(
            f"method {method!r} has no reference: gpubench/reference/"
            f"{method}/ is missing")
    return importlib.import_module(f"gpubench.reference.{method}")


def make_config(port_config: dict, **changes):
    """The reference's `Config` from a configuration file's `port_config`."""
    from gpubench.reference.config import Config

    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in {**port_config, **changes}.items()}
    return Config(**fields)


def build(config: dict, seed: int, device: torch.device, batch: int):
    """(cfg, state, segmenter, seg_fn, names) of the reference at `batch`
    items, with the seed's weights."""
    package = method_package(config)
    if package is not None:
        return package.build(config, seed, device, batch)
    from gpubench.reference.segment.mask2former import (Mask2Former,
                                                         make_seg_fn)
    from gpubench.reference.train.state import create_train_state

    cfg = make_config(config["port_config"], batch_size=batch)
    with torch.device(device):
        state = create_train_state(cfg, device)
        modules = [("model", state.model)]
        seg, seg_fn = None, None
        if config.get("segmenter"):
            seg = Mask2Former(device=device, **config["segmenter"])
            modules.append(("segmenter", seg))
            seg_fn = make_seg_fn(seg, cfg.max_instances)
    names = traffic.fill_weights(modules, seed, device)
    return cfg, state, seg, seg_fn, names


def make_train_step(config: dict, cfg, device: torch.device, seg_fn=None):
    """The reference's training step for `cfg`, made by `build`."""
    package = method_package(config)
    if package is not None:
        return package.make_train_step(cfg, device, seg_fn=seg_fn)
    from gpubench.reference.train.step import make_train_step as make

    return make(cfg, device, seg_fn=seg_fn)


def take_items(tree, items: slice):
    """The items `items` of every tensor of a batch or its draws."""
    if isinstance(tree, dict):
        return {k: take_items(v, items) for k, v in tree.items()}
    return tree[items].contiguous()


def readings(cell, seed: int, device: torch.device,
             items: slice | None = None, products: str | None = None) -> dict:
    """The readings `compare.numbers` takes, of the cell's compared steps
    on pool entries 0, 1, ... of its global batch (every card's shard), in
    TF32-off fp32, or the configuration's bf16 fast mode, as its
    `port_config` states."""
    from gpubench.control import RoundedProducts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config, shards = cell.config, cell.chips
    per = config["port_config"].get("batch_size", 12)
    n = len(range(shards * per)[items or slice(None)])
    cfg, state, seg, seg_fn, names = build(config, seed, device, n)
    step = make_train_step(config, cfg, device, seg_fn=seg_fn)
    start = compare.snapshot(state.optimizer)
    out = {"loss": [], "names": compare.leaf_names(state.model,
                                                   state.optimizer)}
    mode = RoundedProducts(products) if products else contextlib.nullcontext()
    seg_out = compare.SegmenterFeatures(seg)
    cost_out = compare.FirstOutput(state.model, "consistency_mask")
    for i in range(cell.workload["compared_steps"]):
        batch, draws = traffic.global_inputs(cell.traffic,
                                             config["port_config"], seed, i,
                                             shards, device)
        if items is not None:
            batch, draws = take_items(batch, items), take_items(draws, items)
        with mode:
            state, metrics = step(state, batch, 0.0, draws=draws)
        out["loss"].append(float(metrics["loss"]))
        if i == 0:
            out["grad"] = compare.grad_norms(state.optimizer)
            out["seg"] = seg_out.detach()
            out["confidence"] = cost_out.detach()
    out["change"] = compare.change_norms(state.optimizer, start)
    out["state"] = compare.state_values(state.bins, state.balancer)
    out["weights"] = names
    return out
