"""Host-side monocular-video dataset (numpy / PIL), the port's copy of
`mal_tpu.data.mono_dataset`.

Reproduces `manydepth/datasets/mono_dataset.py:33-227` semantics in the
canonical mal_tpu batch format: full-resolution frame triplets, one shared
color jitter per item applied to every frame (so the pose network sees
consistent augmentation), horizontal-flip augmentation, missing frames as
all-zero dummies (the model detects them by image sum, `repdepth.py:216-219`),
and *normalized* intrinsics scaled to full resolution (per-scale K is derived
on device by `geometry.scale_intrinsics` — the TPU-first change vs. the
reference's host-side 4-scale pyramid).
"""

from __future__ import annotations

import os
import random
from typing import Sequence

import numpy as np
from PIL import Image, ImageEnhance

from mal_tpu_torch.segment.cache import load_cached_instances

try:  # Pillow >= 10
    _ANTIALIAS = Image.Resampling.LANCZOS
except AttributeError:  # pragma: no cover
    _ANTIALIAS = Image.ANTIALIAS


def pil_loader(path: str) -> Image.Image:
    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


class ColorJitter:
    """torchvision-equivalent ColorJitter (brightness/contrast/saturation
    (0.8, 1.2), hue (-0.1, 0.1)) with per-item sampled factors shared across
    frames (`mono_dataset.py:69-117,192-196`)."""

    def __init__(self, rng: random.Random):
        self.brightness = rng.uniform(0.8, 1.2)
        self.contrast = rng.uniform(0.8, 1.2)
        self.saturation = rng.uniform(0.8, 1.2)
        self.hue = rng.uniform(-0.1, 0.1)
        self.order = list(range(4))
        rng.shuffle(self.order)

    def __call__(self, img: Image.Image) -> Image.Image:
        for op in self.order:
            if op == 0:
                img = ImageEnhance.Brightness(img).enhance(self.brightness)
            elif op == 1:
                img = ImageEnhance.Contrast(img).enhance(self.contrast)
            elif op == 2:
                img = ImageEnhance.Color(img).enhance(self.saturation)
            else:
                img = self._shift_hue(img, self.hue)
        return img

    @staticmethod
    def _shift_hue(img: Image.Image, hue: float) -> Image.Image:
        if abs(hue) < 1e-6:
            return img
        h, s, v = img.convert("HSV").split()
        h = h.point(lambda x: (x + int(hue * 255)) % 256)
        return Image.merge("HSV", (h, s, v)).convert("RGB")


class MonoDataset:
    """Base class; subclasses implement `get_color` / `load_intrinsics` /
    `index_to_folder_and_frame_idx`."""

    def __init__(self, data_path: str, filenames: Sequence[str], height: int,
                 width: int, frame_idxs: Sequence[int], is_train: bool = False,
                 img_ext: str = ".jpg", seed: int = 0,
                 seg_cache_root: str | None = None):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_idxs = list(frame_idxs)
        self.is_train = is_train
        self.img_ext = img_ext
        self._rng = random.Random(seed)
        # precomputed current-frame segmenter instances for the temporal
        # hint (`segment/cache.py`)
        self.seg_cache_root = seg_cache_root

    def __len__(self) -> int:
        return len(self.filenames)

    # -- subclass hooks ----------------------------------------------------
    def get_color(self, folder, frame_index, side, do_flip) -> Image.Image:
        raise NotImplementedError

    def load_intrinsics(self, folder, frame_index) -> np.ndarray:
        """Normalized 4x4 K (pixel scaling applied here to full res)."""
        raise NotImplementedError

    def index_to_folder_and_frame_idx(self, index):
        raise NotImplementedError

    # -----------------------------------------------------------------------
    def __getitem__(self, index: int) -> dict:
        do_color_aug = self.is_train and self._rng.random() > 0.5
        do_flip = self.is_train and self._rng.random() > 0.5

        folder, frame_index, side = self.index_to_folder_and_frame_idx(index)

        raw: dict[int, Image.Image | None] = {}
        for i in self.frame_idxs:
            try:
                raw[i] = self.get_color(folder, frame_index + i, side, do_flip)
            except FileNotFoundError:
                if i == 0:
                    raise
                raw[i] = None  # start/end of sequence -> dummy zeros

        jitter = ColorJitter(self._rng) if do_color_aug else (lambda im: im)

        color = {}
        color_aug = {}
        for i, img in raw.items():
            if img is None:
                z = np.zeros((self.height, self.width, 3), np.float32)
                color[str(i)] = z
                color_aug[str(i)] = z
                continue
            img = img.resize((self.width, self.height), _ANTIALIAS)
            color[str(i)] = np.asarray(img, np.float32) / 255.0
            color_aug[str(i)] = np.asarray(jitter(img), np.float32) / 255.0

        K = self.load_intrinsics(folder, frame_index).astype(np.float32)
        K = K.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        item = {
            "color": color,
            "color_aug": color_aug,
            "K": K,
            "inv_K": np.linalg.pinv(K).astype(np.float32),
        }
        if self.seg_cache_root is not None:
            item.update(load_cached_instances(self.seg_cache_root, folder,
                                              frame_index, side, do_flip))
        return item


def collate(items: Sequence[dict]) -> dict:
    """Stack items into the batched canonical format.

    Nested frame dicts (color/color_aug) stack per frame; any other array
    entry (K, inv_K, doj masks, depth_gt, ...) stacks along a new batch dim.
    """
    out: dict = {}
    for key, val in items[0].items():
        if isinstance(val, dict):
            out[key] = {f: np.stack([it[key][f] for it in items])
                        for f in val}
        else:
            out[key] = np.stack([it[key] for it in items])
    return out


class DataLoader:
    """Minimal batching iterator: shuffling, drop_last, optional host shard.

    `shard (rank, world)` slices the example stream per host — the TPU-native
    replacement for Accelerate's prepared DataLoader (`trainer.py:303-311`).
    """

    def __init__(self, dataset: MonoDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = True,
                 seed: int = 0, shard: tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rank, self.world = shard

    def __len__(self) -> int:
        n = len(self.dataset) // self.world
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch_idx: int = 0):
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(idxs)
        # every shard the same length, so that data-parallel processes
        # take the same number of steps (each step all-reduces)
        even = len(idxs) - len(idxs) % self.world
        idxs = idxs[:even][self.rank::self.world]
        n_batches = len(idxs) // self.batch_size if self.drop_last else \
            (len(idxs) + self.batch_size - 1) // self.batch_size
        for b in range(n_batches):
            chunk = idxs[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in chunk])

    def __iter__(self):
        return self.epoch(0)
