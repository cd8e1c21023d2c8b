"""K1, the plane-sweep cost volume (`mal_tpu_torch/csrc/plane_sweep.cu`):
its operations and bytes for the inputs of one launch, copied frozen from
`chip_smoke.py:_k1_measure`, and the samples those inputs make it compute,
from K1's own projection and border masks (the plain version's
arithmetic, which the kernel reproduces to the bit). `capture` keeps
each launch's geometry from the inputs of the port's matching encoder."""

from __future__ import annotations

import torch

KERNEL_NAMES = ("plane_sweep_diffs_kernel",)
CHANNELS = 64      # the matching features: a ResNet's stage-1 width


def capture(model: torch.nn.Module, sink: list):
    """Keep the geometry that K1 is launched on in each forward of the
    port's matching encoder (poses, K, inv_K at the matching scale, the
    bins' ends); None for a model without one."""
    encoder = next((m for m in model.modules()
                    if type(m).__name__ == "ResnetEncoderMatching"), None)

    def keep(module, args):
        image, _, poses, K, inv_K, lo, hi = args
        sink.append({"shape": tuple(image.shape), "poses": poses.detach(),
                     "K": K.detach(), "inv_K": inv_K.detach(),
                     "min": lo.detach().clone(), "max": hi.detach().clone(),
                     "planes": module.num_depth_bins})

    return None if encoder is None else encoder.register_forward_pre_hook(keep)


def depth_bins(min_depth: torch.Tensor, max_depth: torch.Tensor,
               num_bins: int) -> torch.Tensor:
    """The port's linear depth planes (`ops/cost_volume.py:_linspace`)."""
    div = num_bins - 1
    s = torch.arange(div, dtype=torch.float32, device=min_depth.device) / div
    out = min_depth * (1 - s) + max_depth * s
    return torch.cat([out, max_depth.reshape(1)])


def active_samples(poses: torch.Tensor, K: torch.Tensor, inv_K: torch.Tensor,
                   bins: torch.Tensor, h: int, w: int) -> int:
    """Samples (frame, plane, pixel) inside K1's border masks, the work its
    data needs beyond the projection: poses (B, F, 4, 4), K / inv_K
    (B, 4, 4) at the feature scale, bins (D,)."""
    B, F = poses.shape[:2]
    P = (K[:, None] @ poses)[:, :, :3, :]
    M = (P[:, :, :, :3] @ inv_K[:, None, :3, :3]).reshape(B * F, 9, 1, 1, 1)
    t = P[:, :, :, 3].reshape(B * F, 3, 1, 1, 1)
    dev = poses.device
    u = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, 1, w)
    v = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, 1, h, 1)
    ax = M[:, 0] * u + M[:, 1] * v + M[:, 2]
    ay = M[:, 3] * u + M[:, 4] * v + M[:, 5]
    az = M[:, 6] * u + M[:, 7] * v + M[:, 8]
    inner = (u >= 2) & (u <= w - 3) & (v >= 2) & (v <= h - 3)
    total = 0
    for d in bins.to(torch.float32).reshape(-1, 1, 1, 1):
        zh = d * az + t[:, 2]
        x = (d * ax + t[:, 0]) / (zh + 1e-7)
        y = (d * ay + t[:, 1]) / (zh + 1e-7)
        edge = (x >= 2.0) & (x <= w - 2) & (y >= 2.0) & (y <= h - 2)
        total += int((edge & inner).sum())
    return total


def counts(frames: int, h: int, w: int, planes: int, active: int,
           channels: int = CHANNELS) -> tuple[float, float]:
    """(bytes, operations) of one launch: each input read once and the
    output written once; ~10 operations a sample for the projection and
    the masks, and for each sample inside the masks ~15 for the bilinear
    weights plus 9 a channel (4 products and 3 sums for the corners, the
    difference and the accumulation)."""
    feats = frames * h * w * channels
    out = frames * planes * h * w
    n_bytes = 4 * (2 * feats + 9 * frames + 3 * frames + planes + out)
    n_ops = 10 * out + active * (15 + 9 * channels)
    return float(n_bytes), float(n_ops)
