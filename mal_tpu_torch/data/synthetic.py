"""Synthetic KITTI-shaped batches (counterpart of `mal_tpu.data.synthetic`),
and DynamicDepth's dynamic-object masks."""

from __future__ import annotations

import torch

from mal_tpu_torch.config import Config


def synthetic_batch(cfg: Config, generator: torch.Generator,
                    device: str | torch.device) -> dict:
    """A random batch of `cfg.batch_size` in the canonical input format
    (see `MALModel`), drawn from `generator` (which must live on `device`)."""
    B, H, W = cfg.batch_size, cfg.height, cfg.width
    color, color_aug = {}, {}
    for f in cfg.frames_to_load:
        color[str(f)] = torch.rand((B, H, W, 3), generator=generator,
                                   device=device)
        noise = torch.randn((B, H, W, 3), generator=generator, device=device)
        color_aug[str(f)] = (color[str(f)] + 0.02 * noise).clamp(0.0, 1.0)

    # KITTI normalised intrinsics (`manydepth/datasets/kitti_dataset.py`)
    K = torch.eye(4, dtype=torch.float32, device=device)
    K[0, 0], K[1, 1] = 0.58 * W, 1.92 * H
    K[0, 2], K[1, 2] = 0.5 * W, 0.5 * H
    K = K.expand(B, 4, 4).contiguous()
    return {"color": color, "color_aug": color_aug, "K": K,
            "inv_K": torch.linalg.inv(K)}


def synthetic_doj_masks(cfg: Config, device: str | torch.device) -> dict:
    """The dynamic-object masks of `benchmarks/bench_methods.py:66-71`, each
    (B, H, W): `doj_mask` ones at rows 60-120 and columns 100-300, and the
    same rolled -8 and +8 columns for frames -1 and +1. At another size
    than 192x512 the box and the shift scale with the frame."""
    B, H, W = cfg.batch_size, cfg.height, cfg.width
    doj = torch.zeros((B, H, W), dtype=torch.float32, device=device)
    doj[:, 60 * H // 192:120 * H // 192, 100 * W // 512:300 * W // 512] = 1.0
    shift = max(1, 8 * W // 512)
    return {"doj_mask": doj, "doj_mask-1": doj.roll(-shift, dims=2),
            "doj_mask+1": doj.roll(shift, dims=2)}
