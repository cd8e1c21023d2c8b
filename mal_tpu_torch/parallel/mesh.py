"""Data-parallel reductions: a step on each process's shard that equals the
one-process step on the global batch.

Counterpart of `mal_tpu.parallel.mesh`. `mal_tpu` jits the step on the
global batch sharded over a mesh (`mal_tpu/parallel/mesh.py:98-122`), so
every reduction over the batch is global: the gradients, the masked loss
means, the train-mode BatchNorm moments, the depth bins, the balancer's
statistics and the logged metrics. The port reproduces that by hand with
`torch.distributed` (not `DistributedDataParallel`, whose one all-reduce
per backward does not fit the pareto step's three gradient pulls):

- each rank computes its **additive share** of the global loss (a masked
  mean is the local masked sum over the global mask count; a batch mean is
  the local mean over the world), so the shares sum to the global loss;
- the gradients are **summed** across ranks, in one flat bucket per type,
  once per backward (`all_reduce_grads`);
- the statistics the step reads (BatchNorm moments, bins, balancer,
  Anderson residuals) are reduced where they are taken, so every rank
  computes the same values and keeps the same state.

The reductions are active inside `data_axis(world)`, which each training
step enters; outside it (evaluation, one process) every function here is
the plain single-process operation, unchanged.

The depth axis (`num_depth_shards` = n_depth > 1, `distributed.grid`):
the n_depth ranks of a depth row hold the same batch shard, so the
reductions above, taken over the whole world, count every data shard
n_depth times. They stay right because each is a ratio whose numerator
and denominator both carry the factor: a masked mean's share is the local
sum over the world's mask count (n_depth x the global count), a batch
mean's the local mean over the world, the BatchNorm moments are sums over
the world's element count, and the gradients are the sum of every rank's
share. `global_norm`, a square root of a sum, divides the factor out
(`replicas`), and a factor of the global batch size counts the shards
once (`data_shards`). Inside `depth_axis` the ManyDepth cost volume
splits its planes over the row (`ops/cuda/cost_volume_kernel.py`).
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# the data axis's size while a training step runs (a process-wide global,
# not a thread-local: the CUDA autograd engine runs backward, and the
# rematerialised forwards in it, on threads of its own)
_WORLD = 1
# how many ranks hold each data shard (the depth rows' width)
_REPLICAS = 1
# (group, depth index, n_depth) of this rank's depth row inside `depth_axis`
_DEPTH = None


@contextlib.contextmanager
def data_axis(world: int, replicas: int = 1) -> Iterator[None]:
    """Make the reductions below global over `world` processes (the
    default process group's) while the block runs, `replicas` of which
    hold each data shard."""
    global _WORLD, _REPLICAS
    prev, _WORLD, _REPLICAS = (_WORLD, _REPLICAS), world, replicas
    try:
        yield
    finally:
        _WORLD, _REPLICAS = prev


def data_world() -> int:
    return _WORLD


def data_shards() -> int:
    """How many distinct shards make the global batch: the data axis's
    ranks over the replicas of each."""
    return _WORLD // _REPLICAS


@contextlib.contextmanager
def depth_axis(group, index: int, n_depth: int) -> Iterator[None]:
    """Split the cost volume's planes over the depth row `group` while the
    block runs: this rank computes share `index` of `n_depth`
    (`distributed.depth_row` gives the three)."""
    global _DEPTH
    prev, _DEPTH = _DEPTH, (group, index, n_depth)
    try:
        yield
    finally:
        _DEPTH = prev


def depth_share() -> tuple | None:
    """(group, depth index, n_depth) inside `depth_axis`, else None."""
    return _DEPTH


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks, whose backward is the sum over ranks of the
    incoming gradients: the gradient of the global loss, the sum of every
    rank's share, with respect to this rank's input."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: Tensor) -> Tensor:
    """The sum of `x` over the ranks (x itself outside a data axis);
    differentiable where `x` requires a gradient."""
    if _WORLD == 1:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x)
    y = x.clone()
    dist.all_reduce(y)
    return y


def batch_mean(x: Tensor) -> Tensor:
    """This rank's share of the mean of `x` over the global batch, whose
    shards have one size: the local mean over the world."""
    m = x.mean()
    return m if _WORLD == 1 else m / _WORLD


def masked_mean(values: Tensor, mask: Tensor, eps: float = 1e-7) -> Tensor:
    """This rank's share of sum(values x mask) / (sum(mask) + eps) over the
    global batch: the local masked sum over the global mask count."""
    return (values * mask).sum() / (global_sum(mask.sum()) + eps)


def global_mean(x: Tensor) -> Tensor:
    """The mean of `x` over the global batch, the same on every rank
    (equal shards)."""
    if _WORLD == 1:
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * _WORLD)


def global_norm(x: Tensor) -> Tensor:
    """The L2 norm of `x` over the global batch, the same on every rank
    (each data shard's squares counted once, whatever the replicas)."""
    if _WORLD == 1:
        return torch.linalg.vector_norm(x)
    return (global_sum(x.square().sum()) / _REPLICAS).sqrt()


def from_rank0(x: Tensor) -> Tensor:
    """Rank 0's value of `x` on every rank (global batch element 0 lives
    on rank 0); detached."""
    if _WORLD == 1:
        return x
    y = x.detach().clone()
    dist.broadcast(y, 0)
    return y


def global_moments(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-channel mean and biased variance of `x` (N, C, ...) over the
    global batch, as E[x] and E[x^2] - E[x]^2 (flax's BatchNorm, which
    `mal_tpu` reduces across the mesh), differentiable: the gradient flows
    through the global moments to every rank's input."""
    dims = [0] + list(range(2, x.dim()))
    n = x.numel() // x.shape[1] * _WORLD
    sums = global_sum(torch.cat([x.sum(dims), x.square().sum(dims)]))
    mean, mean2 = sums.chunk(2)
    mean, mean2 = mean / n, mean2 / n
    return mean, (mean2 - mean.square()).clamp(min=0.0)


def _buckets(tensors: Iterable[Tensor]) -> dict:
    out: dict = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return out


def all_reduce_(tensors: Iterable[Tensor]) -> None:
    """Sum each tensor over the ranks in place: one flat all-reduce per
    type and device."""
    if _WORLD == 1:
        return
    for ts in _buckets(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """The gradient all-reduce of a backward: every `.grad` summed over
    the ranks, so that it is the gradient of the global loss."""
    all_reduce_([p.grad for p in params if p.grad is not None])


def sum_metrics(metrics: dict, keep: Iterable[str] = ()) -> dict:
    """The logged metrics of the global batch: each rank's share summed,
    in one all-reduce; the metrics in `keep` are already global (the
    same on every rank) and stay."""
    if _WORLD == 1:
        return metrics
    keys = [k for k in metrics if k not in keep]
    if not keys:
        return metrics
    ref = metrics[keys[0]]
    vals = torch.stack([metrics[k].detach().to(ref.device, torch.float64)
                        for k in keys])
    dist.all_reduce(vals)
    out = dict(metrics)
    for k, v in zip(keys, vals):
        out[k] = v.to(metrics[k].dtype)
    return out


def broadcast_(tensors: Iterable[Tensor], src: int = 0) -> None:
    """Rank `src`'s values of `tensors` on every rank, in place: one flat
    broadcast per type and device (bool as uint8)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for (dtype, _), ts in _buckets(tensors).items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([t.detach().reshape(-1).to(wire) for t in ts])
        dist.broadcast(flat, src)
        with torch.no_grad():
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t).to(dtype))


def broadcast_state(state, src: int = 0) -> None:
    """Rank `src`'s initial training state on every rank: the parameters,
    the buffers (BatchNorm statistics), the depth bins and the balancer."""
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    for holder in (state.bins, state.balancer):
        tensors += [v for v in vars(holder).values()
                    if isinstance(v, Tensor)]
    broadcast_(tensors, src)


def shard_batch(batch, rank: int, world: int):
    """Rank `rank`'s slice of a global batch (nested dicts of tensors or
    arrays, batch first). A global batch that does not divide by the world
    size raises, as `mal_tpu`'s `shard_batch` does: no rank wraps or pads."""
    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        B = x.shape[0]
        if B % world:
            raise ValueError(f"a global batch of {B} does not divide over "
                             f"{world} processes")
        b = B // world
        return x[rank * b:(rank + 1) * b]

    return cut(batch)
