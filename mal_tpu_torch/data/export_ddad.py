"""DDAD exporter: dgp `SynchronizedSceneDataset` -> the npz layout
`mal_tpu_torch.data.ddad.DDADDataset` reads (a copy of
`mal_tpu.data.export_ddad`, which the port does not import).

The reference consumes DDAD directly through the TRI dgp library
(`manydepth/datasets/ddad_dataset.py:22-35`: CAMERA_01 with
lidar-generated depth and +-1 temporal context). dgp is a heavyweight
dependency we keep OUT of the train/eval path; run this once on a machine
with dgp installed:

    python -m mal_tpu_torch.data.export_ddad --json /path/to/ddad_train_val/ddad.json \
        --out /data/ddad_npz --split train --height 384 --width 640

Each sample becomes `<out>/<split>/<idx:06d>.npz` with keys:
  color_prev / color / color_next   (H, W, 3) uint8, antialias-resized
  K                                  (3, 3) float32, scaled to (W, H)
  depth_gt                           (gt_H, gt_W) float32 lidar depth (key
                                     frame only, full resolution)
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _resize_image(img: np.ndarray, width: int, height: int) -> np.ndarray:
    from PIL import Image

    pil = Image.fromarray(img)
    resample = getattr(Image, "LANCZOS", getattr(Image, "ANTIALIAS", 1))
    return np.asarray(pil.resize((width, height), resample))


def export_sample(context: list, width: int, height: int) -> dict:
    """One dgp sample-with-context -> the npz dict.

    context: [prev, cur, next] datum lists; each camera datum is a dict with
    'rgb' (PIL image), 'intrinsics' (3,3), and the key frame additionally
    'depth' (H, W) when generate_depth_from_datum='lidar'.
    """
    def cam(datums):
        for d in datums:
            if "rgb" in d:
                return d
        raise KeyError("no camera datum in sample")

    prev_d, cur_d, next_d = (cam(c) for c in context)
    rgb = np.asarray(cur_d["rgb"])
    src_h, src_w = rgb.shape[:2]

    K = np.asarray(cur_d["intrinsics"], np.float32).copy()
    K[0] *= width / src_w
    K[1] *= height / src_h

    out = {
        "color_prev": _resize_image(np.asarray(prev_d["rgb"]), width, height),
        "color": _resize_image(rgb, width, height),
        "color_next": _resize_image(np.asarray(next_d["rgb"]), width, height),
        "K": K,
    }
    if "depth" in cur_d and cur_d["depth"] is not None:
        out["depth_gt"] = np.asarray(cur_d["depth"], np.float32)
    return out


def export_split(json_path: str, out_dir: str, split: str,
                 width: int = 640, height: int = 384,
                 camera: str = "CAMERA_01") -> int:
    try:
        from dgp.datasets import SynchronizedSceneDataset
    except ImportError as e:  # pragma: no cover - dgp not in this image
        raise SystemExit(
            "the DDAD exporter needs the TRI dgp package "
            "(github.com/TRI-ML/dgp); install it where the raw DDAD data "
            "lives and re-run — training/eval only ever read the exported "
            f"npz files ({e})")

    ds = SynchronizedSceneDataset(
        json_path, split=split, datum_names=("lidar", camera),
        generate_depth_from_datum="lidar",
        forward_context=1, backward_context=1)

    dst = os.path.join(out_dir, split)
    os.makedirs(dst, exist_ok=True)
    for idx in range(len(ds)):
        sample = export_sample(ds[idx], width, height)
        np.savez_compressed(os.path.join(dst, f"{idx:06d}.npz"), **sample)
    return len(ds)


def main(argv=None):
    p = argparse.ArgumentParser("export_ddad")
    p.add_argument("--json", required=True, help="ddad.json path")
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="train", choices=["train", "val"])
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=640)
    args = p.parse_args(argv)
    n = export_split(args.json, args.out, args.split, args.width, args.height)
    print(f"exported {n} samples to {args.out}/{args.split}")


if __name__ == "__main__":
    main()
