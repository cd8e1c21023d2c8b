"""Production input pipeline: native threaded decode + background prefetch
(the port's copy of `mal_tpu.data.fast_loader`).

The reference trains through multi-worker prefetching torch DataLoaders
(`manydepth/trainer.py:270-316`, num_workers=12, pin_memory). The TPU-native
equivalent here:

- every image of a batch (all frames x all items) decodes + Lanczos-resizes
  through ONE `native/malio.cpp` thread-pool call into a single contiguous
  NHWC float32 buffer (`mal_tpu_torch.data.native.load_batch`),
- color augmentation is applied vectorized over the whole batch in numpy
  (same op family as the reference's shared-per-item torchvision ColorJitter:
  brightness/contrast/saturation factors in [0.8,1.2], hue in [-0.1,0.1],
  one draw per item shared across its frames, `mono_dataset.py:69-117`),
- batches are produced by a background thread into a bounded queue
  (prefetch depth 2), so host IO overlaps device compute; `__iter__` yields
  ready numpy batches that the trainer copies to the card.

Missing adjacent frames (sequence starts/ends) become all-zero dummies like
the reference (`mono_dataset.py:169-174`); the model detects them by image
sum. The exact-parity PIL path (`mono_dataset.DataLoader`) remains the
default for tests; `cli train` opts in via `Config.native_loader`.
"""

from __future__ import annotations

import queue
import threading
from typing import Sequence

import numpy as np

from mal_tpu_torch.data import native
from mal_tpu_torch.data.mono_dataset import MonoDataset
from mal_tpu_torch.segment.cache import load_cached_instances


def _apply_jitter_batch(imgs: np.ndarray, factors: np.ndarray) -> np.ndarray:
    """Vectorized ColorJitter. imgs: (N, H, W, 3) in [0,1];
    factors: (N, 4) = brightness, contrast, saturation, hue-shift."""
    b = factors[:, 0][:, None, None, None]
    c = factors[:, 1][:, None, None, None]
    s = factors[:, 2][:, None, None, None]
    h = factors[:, 3]

    out = imgs * b
    # contrast about the per-image grayscale mean (ImageEnhance.Contrast)
    gray = (0.299 * out[..., 0] + 0.587 * out[..., 1] + 0.114 * out[..., 2])
    mean = gray.mean(axis=(1, 2))[:, None, None, None]
    out = (out - mean) * c + mean
    # saturation: blend with grayscale (ImageEnhance.Color)
    g3 = gray[..., None]
    out = (out - g3) * s + g3
    # hue: rotate in YIQ (a cheap exact hue rotation for small angles)
    theta = (h * 2.0 * np.pi)[:, None, None]
    r, gch, bch = out[..., 0], out[..., 1], out[..., 2]
    y = 0.299 * r + 0.587 * gch + 0.114 * bch
    i = 0.596 * r - 0.274 * gch - 0.322 * bch
    q = 0.211 * r - 0.523 * gch + 0.312 * bch
    ci, si = np.cos(theta), np.sin(theta)
    i2 = ci * i - si * q
    q2 = si * i + ci * q
    rotated = np.stack([y + 0.956 * i2 + 0.621 * q2,
                        y - 0.272 * i2 - 0.647 * q2,
                        y - 1.106 * i2 + 1.703 * q2], axis=-1)
    # the YIQ round trip is not bit-exact; keep zero-hue items untouched
    no_hue = (np.abs(h) < 1e-6)[:, None, None, None]
    out = np.where(no_hue, out, rotated)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


class NativePrefetchLoader:
    """Batched threaded loader over a path-addressable `MonoDataset`.

    The dataset must expose `get_image_path(folder, frame_index, side)` and
    `load_intrinsics` / `index_to_folder_and_frame_idx` (KITTI family does).
    """

    def __init__(self, dataset: MonoDataset, batch_size: int,
                 frame_idxs: Sequence[int] | None = None,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 shard: tuple[int, int] = (0, 1), num_threads: int = 8,
                 prefetch: int = 2):
        if not hasattr(dataset, "get_image_path"):
            raise TypeError("dataset must expose get_image_path for the "
                            "native loader")
        self.ds = dataset
        self.batch_size = batch_size
        self.frame_idxs = list(frame_idxs or dataset.frame_idxs)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rank, self.world = shard
        self.num_threads = num_threads
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.ds) // self.world
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    # ------------------------------------------------------------------
    def _build_batch(self, idxs: np.ndarray, rng: np.random.RandomState):
        ds = self.ds
        H, W = ds.height, ds.width
        B = len(idxs)
        F = len(self.frame_idxs)
        is_train = ds.is_train

        flips = rng.rand(B) > 0.5 if is_train else np.zeros(B, bool)
        do_aug = rng.rand(B) > 0.5 if is_train else np.zeros(B, bool)
        factors = np.stack([rng.uniform(0.8, 1.2, B),
                            rng.uniform(0.8, 1.2, B),
                            rng.uniform(0.8, 1.2, B),
                            rng.uniform(-0.1, 0.1, B)], axis=1)
        factors[~do_aug] = np.array([1.0, 1.0, 1.0, 0.0])

        paths: list[str] = []
        path_flip: list[bool] = []
        missing: list[tuple[int, int]] = []  # (slot, ...)
        meta = []
        import os
        for bi, idx in enumerate(idxs):
            folder, frame_index, side = ds.index_to_folder_and_frame_idx(
                int(idx))
            meta.append((folder, frame_index, side))
            for fi, f in enumerate(self.frame_idxs):
                p = ds.get_image_path(folder, frame_index + f, side)
                if not os.path.exists(p):
                    if f == 0:
                        raise FileNotFoundError(p)
                    missing.append(bi * F + fi)
                    p = ds.get_image_path(folder, frame_index, side)  # dummy
                paths.append(p)
                path_flip.append(bool(flips[bi]))

        imgs = native.load_batch(paths, W, H, path_flip,
                                 num_threads=self.num_threads)
        imgs = imgs.reshape(B, F, H, W, 3)
        if missing:
            flat = imgs.reshape(B * F, H, W, 3)
            for slot in missing:
                flat[slot] = 0.0
            imgs = flat.reshape(B, F, H, W, 3)

        if not is_train or not do_aug.any():
            aug = imgs
        else:
            # jitter only the augmented items (p=0.5), identity for the rest
            flat = imgs.reshape(B * F, H, W, 3)
            sel = np.repeat(do_aug, F)
            aug = flat.copy()
            aug[sel] = _apply_jitter_batch(
                flat[sel], np.repeat(factors[do_aug], F, axis=0))
            aug = aug.reshape(B, F, H, W, 3)
        # zero dummies stay zero in the aug stream (`mono_dataset.py:113-117`)
        if missing:
            flat = aug.reshape(B * F, H, W, 3)
            for slot in missing:
                flat[slot] = 0.0
            aug = flat.reshape(B, F, H, W, 3)

        Ks = []
        for folder, frame_index, _ in meta:
            K = ds.load_intrinsics(folder, frame_index).astype(np.float32)
            K = K.copy()
            K[0, :] *= W
            K[1, :] *= H
            Ks.append(K)
        K = np.stack(Ks)

        color = {str(f): np.ascontiguousarray(imgs[:, fi])
                 for fi, f in enumerate(self.frame_idxs)}
        color_aug = {str(f): np.ascontiguousarray(aug[:, fi])
                     for fi, f in enumerate(self.frame_idxs)}
        out = {"color": color, "color_aug": color_aug, "K": K,
               "inv_K": np.linalg.pinv(K).astype(np.float32)}

        if getattr(ds, "seg_cache_root", None) is not None:
            # precomputed temporal-hint instances, orientation-matched to
            # this batch's flip draws (`segment/cache.py`)
            per = [load_cached_instances(ds.seg_cache_root, folder,
                                         frame_index, side, bool(flips[bi]))
                   for bi, (folder, frame_index, side) in enumerate(meta)]
            for k in per[0]:
                out[k] = np.stack([p[k] for p in per])
        return out

    # ------------------------------------------------------------------
    def epoch(self, epoch_idx: int = 0):
        idxs = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(idxs)
        # every shard the same length, so that data-parallel processes
        # take the same number of steps (each step all-reduces)
        even = len(idxs) - len(idxs) % self.world
        idxs = idxs[:even][self.rank::self.world]
        n_batches = len(idxs) // self.batch_size if self.drop_last else \
            (len(idxs) + self.batch_size - 1) // self.batch_size

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            rng = np.random.RandomState(
                (self.seed * 1000003 + epoch_idx) % (2 ** 31))
            for b in range(n_batches):
                if stop.is_set():
                    return
                chunk = idxs[b * self.batch_size:(b + 1) * self.batch_size]
                try:
                    q.put(self._build_batch(chunk, rng))
                except Exception as e:  # surface in the consumer
                    q.put(e)
                    return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def __iter__(self):
        return self.epoch(0)
