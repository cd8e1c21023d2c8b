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
when asked (gloo). Each process's loader reads its own shard of the
training split (`shard=(rank, world)`), so the global batch is
N x `batch_size`.
"""

from __future__ import annotations

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


def rank_seed(seed: int, rank_: int) -> int:
    """The seed of rank `rank_`'s random draws: `seed` itself on rank 0
    (so that a one-process run is unchanged), else one drawn from
    (seed, rank)."""
    if rank_ == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank_]).generate_state(1)[0])


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()
