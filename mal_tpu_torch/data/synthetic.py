"""Synthetic KITTI-shaped batches (counterpart of `mal_tpu.data.synthetic`),
DynamicDepth's dynamic-object masks, and fake KITTI and COCO trees for
driving the CLI without the datasets."""

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


# COCO's 80 thing category ids (sparse in 1..90), as instances_*.json has them
COCO_THING_IDS = (tuple(range(1, 12)) + tuple(range(13, 26)) + (27, 28)
                  + tuple(range(31, 45)) + tuple(range(46, 66)) + (67, 70)
                  + tuple(range(72, 83)) + tuple(range(84, 91)))


def _rle_counts(mask) -> list[int]:
    """Uncompressed COCO RLE counts of a binary (H, W) mask: column-major
    runs, the first one of background (possibly 0)."""
    import numpy as np

    flat = mask.T.ravel().astype(np.int8)
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
    return ([0] + runs) if flat[0] else runs


def write_fake_coco(root: str, n_images: int = 6, n_categories: int = 80,
                    instances: tuple[int, int] = (2, 12), seed: int = 0,
                    size: tuple[int, int] = (640, 480)) -> dict:
    """A fake COCO instance tree for `finetune-seg`: `n_images` seeded JPEGs
    at `size` (W, H) under `root/images`, and `root/annotations.json` with
    the first `n_categories` of COCO's sparse thing ids and 2-12 (by
    default) instances an image, ellipses as uncompressed RLE and polygons
    of 5-8 vertices at non-integer coordinates, in turns, each painted into
    the image in a colour of its category. Returns the paths
    ({"images", "annotations"})."""
    import json
    import os

    import numpy as np
    from PIL import Image

    from mal_tpu_torch.segment.coco import polygon_to_mask

    rng = np.random.RandomState(seed)
    W, H = size
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    cats = COCO_THING_IDS[:n_categories]
    colours = rng.randint(0, 256, (len(cats), 3))
    ys, xs = np.mgrid[0:H, 0:W] + 0.5
    images, anns = [], []
    for i in range(n_images):
        coarse = rng.randint(0, 256, (H // 16, W // 16, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(coarse).resize((W, H),
                                                        Image.BILINEAR))
        img = img.astype(np.int64)
        for j in range(rng.randint(instances[0], instances[1] + 1)):
            c = rng.randint(len(cats))
            cx, cy = rng.uniform(0.1, 0.9) * W, rng.uniform(0.1, 0.9) * H
            rx, ry = rng.uniform(0.04, 0.25) * W, rng.uniform(0.04, 0.25) * H
            if j % 2 == 0:
                m = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1.0
                seg = {"counts": _rle_counts(m), "size": [H, W]}
            else:
                n = rng.randint(5, 9)
                ang = np.sort(rng.uniform(0, 2 * np.pi, n))
                rad = rng.uniform(0.5, 1.0, n)
                px = np.clip(cx + rx * rad * np.cos(ang), 0.3, W - 0.3)
                py = np.clip(cy + ry * rad * np.sin(ang), 0.3, H - 0.3)
                seg = [np.stack([px, py], 1).ravel().round(3).tolist()]
                m = polygon_to_mask(seg, H, W).astype(bool)
            img[m] = (img[m] + 2 * colours[c]) // 3
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(cats[c]), "segmentation": seg,
                         "iscrowd": 0})
        name = f"{i:012d}.jpg"
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(img_dir, name), quality=90)
        images.append({"id": i + 1, "file_name": name, "height": H,
                       "width": W})
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": int(c), "name": f"class_{c}"}
                                  for c in cats]}, f)
    return {"images": img_dir, "annotations": path}
