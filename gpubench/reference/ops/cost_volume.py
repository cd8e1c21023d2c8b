"""Plane-sweep cost volume: depth bins, projection terms, confidence and
argmin disparity.

Counterpart of `mal_tpu.ops.cost_volume`. The volume itself is
`ops/kernels.py:plane_sweep_cost_volume_kernel`, K1's plain version in one
process (the port's split of the planes over a depth row is not copied).

The volume is a constant with respect to the parameters (the reference
computes it under `torch.no_grad()`, `resnet_encoder.py:292-305`).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def compute_depth_bins(min_depth, max_depth, num_bins: int,
                       binning: str = "linear") -> Tensor:
    """Depth hypothesis planes (D,). Reference: `resnet_encoder.py:121-148`.

    `min_depth` / `max_depth` are 0-d tensors (the tracker's state) or floats.
    """
    min_depth = torch.as_tensor(min_depth, dtype=torch.float32).reshape(())
    max_depth = torch.as_tensor(max_depth, dtype=torch.float32,
                                device=min_depth.device).reshape(())
    if binning == "linear":
        return _linspace(min_depth, max_depth, num_bins)
    if binning == "inverse":
        inv = _linspace(1.0 / max_depth, 1.0 / min_depth, num_bins)
        return 1.0 / inv.flip(0)
    if binning == "log":
        i = torch.arange(num_bins, dtype=torch.float32, device=min_depth.device)
        return torch.exp(torch.log(min_depth)
                         + torch.log(max_depth / min_depth) * i / num_bins)
    raise NotImplementedError(binning)


def _linspace(start: Tensor, stop: Tensor, num: int) -> Tensor:
    """`jnp.linspace(start, stop, num)` for 0-d tensor endpoints in the same
    arithmetic (start * (1 - s) + stop * s with s = i / (num - 1), then
    `stop` appended), so the planes stay on the device and agree with
    `mal_tpu` to the last bit."""
    if num == 1:
        return start.reshape(1)
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=start.device) / div
    out = start * (1 - s) + stop * s
    return torch.cat([out, stop.reshape(1)])


def plane_sweep_terms(rel_poses: Tensor, K: Tensor, inv_K: Tensor):
    """Per-(batch, frame) projection: M = (K T)[:3,:3] inv_K[:3,:3] (B, F, 3, 3)
    and t = (K T)[:3, 3] (B, F, 3), as `plane_sweep_cost_volume_pallas` forms them."""
    P = (K[:, None] @ rel_poses)[:, :, :3, :]
    M = P[:, :, :, :3] @ inv_K[:, None, :3, :3]
    return M, P[:, :, :, 3]


def fill_missing(cost: Tensor) -> tuple[Tensor, Tensor]:
    """(cost, missing mask), each (B, D, h, w): an entry of cost 0 is
    missing and takes its pixel's largest cost over the D planes."""
    missing = (cost == 0).to(cost.dtype)
    cost = cost * (1.0 - missing) + cost.amax(dim=1, keepdim=True) * missing
    return cost, missing


def confidence_mask_from_cost(cost_volume: Tensor, missing_mask: Tensor) -> Tensor:
    """Pixels where every depth bin was observed (B, h, w). Reference: `resnet_encoder.py:255-262`."""
    observed = ((cost_volume * (1.0 - missing_mask)) > 0).sum(dim=1)
    return (observed == cost_volume.shape[1]).to(cost_volume.dtype)


def indices_to_disparity(cost_volume: Tensor, depth_bins: Tensor) -> Tensor:
    """Argmin-cost disparity (B, h, w), 0-cost entries ignored. Reference: `resnet_encoder.py:247-253,309-313`."""
    viz = torch.where(cost_volume == 0, torch.full_like(cost_volume, 100.0),
                      cost_volume)
    argmin = viz.argmin(dim=1)
    return 1.0 / depth_bins[argmin]
