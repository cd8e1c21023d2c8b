"""The process group of a data-parallel run.

Counterpart of `mal_tpu.parallel.distributed`. The reference launches
`accelerate launch --multi_gpu`, one DDP process per GPU over NCCL
(`manydepth/trainer.py:309-311`); `mal_tpu` runs one JAX process per host
over a global mesh. The port runs one process per card, launched once per
process:

    python -m mal_tpu_torch.cli train ... \\
        --coordinator host0:port --num_hosts N --host_id i

where, in the port, `--num_hosts` counts processes and `--host_id` is the
process's rank. Rank r uses `cuda:{r % device_count}` (NCCL), or the CPU
when asked (gloo).

With `num_depth_shards` = n_depth > 1 the N ranks form an n_data x n_depth
grid, laid out as `mal_tpu`'s `make_mesh_2d` lays out devices
(`mal_tpu/parallel/mesh.py:46`): rank r holds data shard r // n_depth and
depth share r % n_depth. The n_depth ranks of a depth row hold the same
batch shard and make the same draws, and split the cost volume's planes
among them (`depth_row`). Each process's loader reads the shard of its
data index (`shard=(data_index, n_data)`), so the global batch is n_data x
`batch_size`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


def initialize(init_method: str, world: int, rank: int,
               backend: str | None = None,
               device: torch.device | None = None) -> None:
    """Join the process group: `init_method` as torch takes it
    (`tcp://host:port`, `file://path`), NCCL for a CUDA `device` and gloo
    for the CPU unless `backend` says otherwise."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a world of {world}")
    cuda = device is not None and device.type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)


def coordinator_url(coordinator: str) -> str:
    """The CLI's `--coordinator host:port` as a TCP init method."""
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--coordinator must be host:port, got "
                         f"{coordinator!r}")
    return f"tcp://{coordinator}"


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank_device(device: str | torch.device | None, rank_: int) -> torch.device:
    """The device of process `rank_`: `cuda:{rank_ % device_count}` unless
    the caller names the CPU (or a device of its own)."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mal_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda", rank_ % torch.cuda.device_count())
    return torch.device(device)


def rank_seed(seed: int, data_index: int) -> int:
    """The seed of the random draws of data shard `data_index` (the rank
    itself without a depth axis): `seed` itself on shard 0 (so that a
    one-process run is unchanged), else one drawn from (seed, shard). The
    ranks of a depth row share it, so they draw alike."""
    if data_index == 0:
        return seed
    return int(np.random.SeedSequence([seed, data_index]).generate_state(1)[0])


class Grid(NamedTuple):
    """A rank's place in the n_data x n_depth grid of a run."""
    n_data: int
    n_depth: int
    data_index: int
    depth_index: int


def grid(num_depth_shards: int, world_: int | None = None,
         rank_: int | None = None) -> Grid:
    """The grid of `world_` ranks (default: the process group's) with
    `num_depth_shards` ranks a depth row, and rank `rank_`'s place in it:
    data index r // n_depth, depth index r % n_depth. One process has no
    depth axis (`train/step.py:check_parallel` refuses one there)."""
    world_ = world() if world_ is None else world_
    rank_ = rank() if rank_ is None else rank_
    n_depth = num_depth_shards if world_ > 1 else 1
    return Grid(world_ // n_depth, n_depth, rank_ // n_depth, rank_ % n_depth)


# the depth rows' groups of this run's process group, by n_depth
_ROWS: dict[int, list] = {}


def depth_row(n_depth: int) -> tuple:
    """(group, depth index, n_depth) of this rank's depth row: the
    `torch.distributed` group of the n_depth ranks that share its data
    shard. The first call of a run builds the group of every row, in row
    order, as `new_group` needs every rank to build every group: each rank
    makes that call at the same point (`train/step.py:data_parallel`)."""
    if n_depth not in _ROWS:
        _ROWS[n_depth] = [
            dist.new_group(list(range(i * n_depth, (i + 1) * n_depth)))
            for i in range(world() // n_depth)]
    g = grid(n_depth)
    return _ROWS[n_depth][g.data_index], g.depth_index, n_depth


def shutdown() -> None:
    _ROWS.clear()
    if is_distributed():
        dist.destroy_process_group()
