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


KITTI_DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"


def write_fake_kitti(root: str, n_train: int = 36, n_test: int = 24,
                     seed: int = 0, size: tuple[int, int] = (1242, 375)) -> dict:
    """A fake KITTI raw tree under `root`, for driving the CLI without the
    dataset: one drive of `max(n_train, n_test) + 2` seeded JPEGs at `size`
    (W, H; KITTI's 1242x375 by default: smooth random colour fields plus
    noise), `root/splits/eigen_zhou/train_files.txt` with `n_train` lines,
    `root/splits/eigen/test_files.txt` with `n_test`, and
    `root/splits/eigen/gt_depths.npz` with seeded positive depths (2-70 m)
    at `size`. Run the CLI from `root`. Returns the paths."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    W, H = size
    data = os.path.join(root, "kitti")
    img_dir = os.path.join(data, KITTI_DRIVE, "image_02", "data")
    os.makedirs(img_dir, exist_ok=True)
    n_frames = max(n_train, n_test) + 2
    for i in range(n_frames):
        coarse = rng.randint(0, 256, (H // 8, W // 8, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((W, H),
                                                        Image.BILINEAR))
        img = np.clip(img + rng.randint(-8, 9, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(img_dir, f"{i:010d}.jpg"), quality=90)
    paths = {"data_path": data}
    for split, name, n in (("eigen_zhou", "train_files.txt", n_train),
                           ("eigen", "test_files.txt", n_test)):
        d = os.path.join(root, "splits", split)
        os.makedirs(d, exist_ok=True)
        paths[split] = os.path.join(d, name)
        with open(paths[split], "w") as f:
            f.writelines(f"{KITTI_DRIVE} {i} l\n" for i in range(1, n + 1))
    paths["gt"] = os.path.join(root, "splits", "eigen", "gt_depths.npz")
    np.savez_compressed(paths["gt"], data=rng.uniform(
        2.0, 70.0, (n_test, H, W)).astype(np.float32))
    return paths
