"""Dynamic-object (doj) mask loading for DynamicDepth (the port's copy of
`mal_tpu.data.doj`).

The reference loads precomputed per-frame dynamic-object masks from hardcoded
.npy paths (`dynamicdepth/datasets/cityscapes_preprocessed_dataset.py:70-83`,
`kitti_dataset.py:96-117`); here the mask root is a parameter and the naming
scheme matches the reference's `<key>.npy` / `<key>-1.npy` / `<key>+1.npy`.

Use `attach_doj_masks(dataset, doj_root)` to wrap any `MonoDataset` so its
items carry `doj_mask`, `doj_mask-1`, `doj_mask+1` (each (H, W) float32,
nearest-resized to the training resolution like the reference's
`resize[0]`+to_tensor path).
"""

from __future__ import annotations

import os

import numpy as np


def _resize_mask_nn(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = np.floor(np.arange(h) * (mask.shape[0] / h)).astype(np.int32)
    xs = np.floor(np.arange(w) * (mask.shape[1] / w)).astype(np.int32)
    return mask[ys][:, xs]


def load_doj_masks(doj_root: str, key: str, height: int, width: int,
                   do_flip: bool = False) -> dict:
    """key e.g. 'ulm_000064_000012' (CS) or '<drive>_<frame>_<side>' (KITTI)."""
    out = {}
    for suffix, name in (("", "doj_mask"), ("-1", "doj_mask-1"),
                         ("+1", "doj_mask+1")):
        path = os.path.join(doj_root, f"{key}{suffix}.npy")
        if os.path.exists(path):
            m = np.load(path).astype(np.float32)
        else:
            m = np.zeros((height, width), np.float32)
        m = _resize_mask_nn(m, height, width)
        if do_flip:
            m = m[:, ::-1].copy()
        out[name] = m
    return out


class attach_doj_masks:
    """Dataset wrapper adding doj masks to every item."""

    def __init__(self, dataset, doj_root: str):
        self.dataset = dataset
        self.doj_root = doj_root

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int) -> dict:
        item = self.dataset[index]
        folder, frame_index, side = self.dataset.index_to_folder_and_frame_idx(index)
        if side is None:  # cityscapes naming: city_seq_frame
            key = str(frame_index)
        else:
            key = f"{str(folder).replace('/', '_')}_{frame_index}_{side}"
        item.update(load_doj_masks(self.doj_root, key,
                                   self.dataset.height, self.dataset.width))
        return item
