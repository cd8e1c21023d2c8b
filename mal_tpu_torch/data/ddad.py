"""DDAD dataset loader (384x640, lidar GT, depth cap 200 m), the port's
copy of `mal_tpu.data.ddad`.

The reference consumes DDAD through the TRI `dgp.SynchronizedSceneDataset`
(`manydepth/datasets/ddad_dataset.py`), a heavyweight external dependency.
Here the loader reads a pre-exported directory layout instead (one npz per
sample with the frame triplet + intrinsics + lidar depth), which the
`export_ddad.py`-style tooling of the dgp ecosystem can produce; this keeps
the training/eval path dependency-free. Protocol constants follow
`manydepth/trainer.py:137-142,663-834`: 384x640, eval depth cap 200 m.
"""

from __future__ import annotations

import os

import numpy as np

DDAD_SIZE = (640, 384)  # (W, H)
DDAD_MAX_DEPTH = 200.0


class DDADDataset:
    """Reads samples exported as `<data_path>/<split>/<idx>.npz` with keys
    color_prev/color/color_next (H, W, 3 uint8), K (3, 3), depth_gt (H, W)."""

    def __init__(self, data_path: str, height: int = 384, width: int = 640,
                 frame_idxs=(0, -1, 1), is_train: bool = False, seed: int = 0):
        import random

        self.data_path = data_path
        split = "train" if is_train else "val"
        self.split_dir = os.path.join(data_path, split)
        self.files = sorted(f for f in os.listdir(self.split_dir)
                            if f.endswith(".npz")) if os.path.isdir(
                                self.split_dir) else []
        self.height, self.width = height, width
        self.frame_idxs = list(frame_idxs)
        self.is_train = is_train
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> dict:
        data = np.load(os.path.join(self.split_dir, self.files[index]))
        keymap = {-1: "color_prev", 0: "color", 1: "color_next"}
        color = {}
        for f in self.frame_idxs:
            img = data[keymap[f]].astype(np.float32) / 255.0
            color[str(f)] = img
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = data["K"]
        out = {"color": color, "color_aug": color, "K": K,
               "inv_K": np.linalg.pinv(K).astype(np.float32)}
        if "depth_gt" in data:
            out["depth_gt"] = data["depth_gt"].astype(np.float32)
        return out
