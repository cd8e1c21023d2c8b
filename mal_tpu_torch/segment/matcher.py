"""Instance matching across frames (exact linear-sum assignment).

Counterpart of `mal_tpu.segment.matcher`: cost = class mismatch + dice loss
between the instance masks of the current frame and of each warped adjacent
frame (`manydepth/matcher.py:63-255`), solved exactly.

The cost matrices are built on the tensors' device. The assignment runs on
the host, in numpy float32: `match_instances` copies the (B, 2, N, N) costs
to the CPU once and the assignment back, which synchronises with the device
three times per call (each a `host_syncs` count). The solve
is `mal_tpu`'s Jonker-Volgenant shortest-augmenting-path algorithm step for
step, in the same float32 arithmetic, so that on exact cost ties it picks the
assignment `mal_tpu` picks (scipy's may differ).
"""

from __future__ import annotations

import numpy as np
import torch

from mal_tpu_torch.segment.instances import Instances
from mal_tpu_torch.utils import profiling

Tensor = torch.Tensor

_BIG = 1e6


def hungarian_match(cost: np.ndarray) -> np.ndarray:
    """Exact assignment for square (..., N, N) cost matrices.

    Returns `row_of_col` (..., N): for each column j, the assigned row. The
    dual-potential form of `mal_tpu.segment.matcher.hungarian_match`, with a
    virtual row and column 0 (1-indexed classic formulation), run on all
    matrices at once: each one's arithmetic is the single-matrix algorithm's,
    and a matrix whose search has ended is left alone until the others end.
    """
    lead, n = cost.shape[:-2], cost.shape[-1]
    cost = cost.reshape(-1, n, n)
    P = cost.shape[0]
    ar = np.arange(P)
    C = np.zeros((P, n + 1, n + 1), np.float32)
    C[:, 1:, 1:] = cost
    u = np.zeros((P, n + 1), np.float32)
    v = np.zeros((P, n + 1), np.float32)
    p = np.zeros((P, n + 1), np.int64)
    inf = np.float32(np.inf)
    for i in range(1, n + 1):
        p[:, 0] = i
        minv = np.full((P, n + 1), inf)
        used = np.zeros((P, n + 1), bool)
        way = np.zeros((P, n + 1), np.int64)
        j0 = np.zeros(P, np.int64)
        active = np.ones(P, bool)
        while active.any():
            used[ar[active], j0[active]] = True
            i0 = p[ar, j0]
            cur = C[ar, i0] - u[ar, i0][:, None] - v
            better = (cur < minv) & ~used & active[:, None]
            minv = np.where(better, cur, minv)
            way = np.where(better, j0[:, None], way)
            masked = np.where(used, inf, minv)
            masked[:, 0] = inf
            j1 = masked.argmin(axis=1)
            delta = masked[ar, j1]
            # used columns' rows gain delta, the others' slack shrinks
            step = np.where(used & active[:, None], delta[:, None],
                            np.float32(0.0))
            np.add.at(u, (ar[:, None], p), step)
            v = v - step
            minv = np.where(used | ~active[:, None], minv,
                            minv - delta[:, None])
            j0 = np.where(active, j1, j0)
            active &= p[ar, j1] != 0
        while (j0 != 0).any():  # augment along the paths to column 0
            on = j0 != 0
            j1 = way[ar, j0]
            p[ar[on], j0[on]] = p[ar[on], j1[on]]
            j0 = np.where(on, j1, j0)
    return (p[:, 1:] - 1).reshape(*lead, n)


def dice_cost(masks_a: Tensor, masks_b: Tensor) -> Tensor:
    """Pairwise dice loss between flattened masks, batched:
    (B, Na, HW) x (B, Nb, HW) -> (B, Na, Nb), 1 - (2ab + 1) / (|a| + |b| + 1)
    (mask2former's `batch_dice_loss`)."""
    num = 2.0 * torch.einsum("bnc,bmc->bnm", masks_a, masks_b)
    den = masks_a.sum(-1)[:, :, None] + masks_b.sum(-1)[:, None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


def _pair_cost(inst: Instances, cur: Instances) -> Tensor:
    """Cost (B, N, N) between one frame's instances and the current frame's."""
    B, N = inst.classes.shape
    class_cost = (inst.classes[:, :, None]
                  != cur.classes[:, None, :]).to(torch.float32)
    cost = class_cost + dice_cost(inst.masks.reshape(B, N, -1),
                                  cur.masks.reshape(B, N, -1))
    invalid = ~(inst.valid[:, :, None] & cur.valid[:, None, :])
    return torch.where(invalid, torch.full_like(cost, _BIG), cost)


def match_instances(inst_last: Instances, inst_next: Instances,
                    inst_cur: Instances):
    """Triplet matching (`matcher.py:89-173`) for a whole batch.

    For each current-frame slot j returns (last_idx, next_idx, pair_valid),
    each (B, N) on the instances' device: the instance indices matched to j
    in both adjacent frames, valid only when both assignments pair real
    instances.
    """
    with profiling.span("mal.matching"):
        costs = torch.stack([_pair_cost(inst_last, inst_cur),
                             _pair_cost(inst_next, inst_cur)], dim=1)
        with profiling.span("mal.matching.wait"):
            host = costs.cpu().numpy()               # waits for the device
        profiling.count("host_syncs")
        with profiling.span("mal.matching.solve"):
            rows = hungarian_match(host)             # (B, 2, N)
            # cost of each column's assigned pair: host[b, k, rows[b, k, j], j]
            picked = np.take_along_axis(host, rows[:, :, None, :],
                                        axis=2)[:, :, 0]
            ok = (picked < _BIG / 2).all(axis=1)
            dev = inst_cur.masks.device
            # two copies to the device from pageable memory, each of which
            # synchronises with it
            rows = torch.from_numpy(rows).to(dev)
            ok = torch.from_numpy(ok).to(dev)
            profiling.count("host_syncs", 2)
        return rows[:, 0], rows[:, 1], ok
