"""COCO-format instance dataset for segmenter fine-tuning.

Counterpart of `mal_tpu.segment.coco`, which replaces the reference's
detectron2 registration and mapper chain (`mask2former/data/`:
`register_coco_instances`, `MaskFormerInstanceDatasetMapper`) with a
self-contained reader: a COCO json (`images` / `annotations` /
`categories`) plus an image directory, yielding RGB images in [0, 1] and
the padded static targets of `segment/criterion.py`.

Segmentations: uncompressed RLE dicts and polygon lists. `mal_tpu`
rasterises polygons with matplotlib's point-in-path test; the port has no
matplotlib and runs the even-odd test at the pixel centres in numpy, which
gives the same mask wherever no polygon edge passes through a pixel centre.
Compressed (pycocotools string) RLE raises, as in `mal_tpu`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mal_tpu_torch.segment.finetune import (category_index, coco_to_targets,
                                            rle_decode)


def polygon_to_mask(polygons, height: int, width: int) -> np.ndarray:
    """COCO polygon list [[x0, y0, x1, y1, ...], ...] -> (H, W) uint8: the
    union of the parts, each filled by the even-odd rule with the pixel
    centres as sample points (pycocotools' fill).

    A crossing of row centre y by edge (x0, y0)-(x1, y1), counted where
    exactly one end lies below y, toggles every pixel centre left of the
    crossing; a pixel is inside where it is toggled an odd number of times.
    """
    mask = np.zeros((height, width), bool)
    py = np.arange(height) + 0.5
    for poly in polygons:
        xy = np.asarray(poly, np.float64).reshape(-1, 2)
        x0, y0 = xy[:, 0], xy[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        edge, row = np.nonzero((y0[:, None] > py) != (y1[:, None] > py))
        t = (py[row] - y0[edge]) / (y1[edge] - y0[edge])
        xs = x0[edge] + t * (x1[edge] - x0[edge])
        # centres j + 0.5 < xs, i.e. j < ceil(xs - 0.5), are toggled
        first_out = np.clip(np.ceil(xs - 0.5), 0, width).astype(np.int64)
        counts = np.zeros((height, width + 1), np.int64)
        np.add.at(counts, (row, first_out), 1)
        toggles = np.cumsum(counts[:, ::-1], axis=1)[:, ::-1][:, 1:]
        mask |= toggles % 2 == 1
    return mask.astype(np.uint8)


def _decode_segmentation(seg, height: int, width: int) -> np.ndarray:
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, (str, bytes)):
            raise NotImplementedError(
                "compressed COCO RLE needs pycocotools (absent here); "
                "export uncompressed RLE or polygons")
        m = rle_decode(counts, seg["size"])
        assert m.shape == (height, width)
        return m
    return polygon_to_mask(seg, height, width)


class CocoInstanceDataset:
    """items: (image (H, W, 3) float32 in [0,1], labels, masks, valid)."""

    def __init__(self, json_path: str, image_root: str, height: int,
                 width: int, max_instances: int = 16):
        with open(json_path) as f:
            coco = json.load(f)
        self.height, self.width = height, width
        self.max_instances = max_instances
        self.cat_index = category_index(
            [c["id"] for c in coco["categories"]])
        self.num_classes = len(self.cat_index)
        self.image_root = image_root
        self.images = coco["images"]
        self.anns_by_image: dict[int, list] = {}
        for a in coco["annotations"]:
            self.anns_by_image.setdefault(int(a["image_id"]), []).append(a)

    def __len__(self):
        return len(self.images)

    def _resize_nn(self, arr: np.ndarray) -> np.ndarray:
        h, w = arr.shape[:2]
        ys = np.floor(np.arange(self.height) * (h / self.height)).astype(int)
        xs = np.floor(np.arange(self.width) * (w / self.width)).astype(int)
        return arr[ys][:, xs]

    def __getitem__(self, i: int):
        from PIL import Image

        info = self.images[i]
        img = Image.open(os.path.join(self.image_root,
                                      info["file_name"])).convert("RGB")
        ih, iw = int(info["height"]), int(info["width"])
        image = (np.asarray(
            img.resize((self.width, self.height), Image.LANCZOS),
            np.float32) / 255.0)

        anns = []
        for a in self.anns_by_image.get(int(info["id"]), []):
            m = _decode_segmentation(a["segmentation"], ih, iw)
            anns.append({"category_id": a["category_id"],
                         "segmentation": self._resize_nn(m)})
        return (image,) + coco_to_targets(
            anns, self.height, self.width, self.max_instances,
            cat_index=self.cat_index)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                device: str | torch.device = "cpu"):
        """(images, labels, masks, valid) tensors on `device`, the order
        shuffled by numpy's RandomState(`seed`) as in `mal_tpu`; a last
        partial batch is dropped."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(j)] for j in order[s:s + batch_size]]
            yield tuple(torch.from_numpy(np.stack([it[k] for it in items]))
                        .to(device) for k in range(4))
