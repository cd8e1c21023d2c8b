"""Disparity images for validation (the port's copy of the numpy part of
`mal_tpu.utils.vis`: `colormap_plasma` and `dump_disp_images`)."""

from __future__ import annotations

import os

import numpy as np


def colormap_plasma(x: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """(H, W) -> (H, W, 3) uint8 plasma colormap (matplotlib-free)."""
    # 16-anchor plasma approximation, linearly interpolated
    anchors = np.array([
        [13, 8, 135], [62, 4, 156], [99, 0, 167], [132, 5, 167],
        [162, 23, 158], [187, 44, 141], [209, 66, 124], [227, 89, 107],
        [241, 113, 92], [250, 139, 77], [254, 167, 62], [252, 196, 49],
        [243, 227, 41], [240, 249, 33], [240, 249, 33], [240, 249, 33],
    ], np.float32)
    vmin = float(x.min()) if vmin is None else vmin
    vmax = float(x.max()) if vmax is None else vmax
    t = np.clip((x - vmin) / max(vmax - vmin, 1e-9), 0, 1) * (len(anchors) - 1)
    lo = np.floor(t).astype(np.int32)
    hi = np.minimum(lo + 1, len(anchors) - 1)
    frac = (t - lo)[..., None]
    rgb = anchors[lo] * (1 - frac) + anchors[hi] * frac
    return rgb.astype(np.uint8)


def dump_disp_images(disps, out_dir: str, step: int, n: int = 4,
                     to_wandb: bool = True) -> list[str]:
    """Write the first `n` disparity maps as plasma-coloured PNGs,
    `{out_dir}/step_{step}_disp_{i}.png`, each normalised to its 95th
    percentile (`mal_tpu/utils/vis.py:32`), and log them to wandb when a run
    is active. Returns the written paths."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, d in enumerate(disps[:n]):
        d = np.asarray(d, np.float32)
        if d.ndim == 3:  # (H, W, 1)
            d = d[..., 0]
        rgb = colormap_plasma(d, vmin=0.0, vmax=float(np.percentile(d, 95)))
        p = os.path.join(out_dir, f"step_{step}_disp_{i}.png")
        Image.fromarray(rgb).save(p)
        paths.append(p)
    if to_wandb and paths:
        try:
            import wandb
        except ImportError:
            return paths
        if wandb.run is not None:
            wandb.log({"val/disp": [wandb.Image(p) for p in paths]},
                      step=step)
    return paths
