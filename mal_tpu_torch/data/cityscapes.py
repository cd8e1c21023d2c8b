"""CityScapes loaders (the port's copy of `mal_tpu.data.cityscapes`).

`CityscapesPreprocessedDataset`: 3-wide concatenated triplets with ego-car
removed, per-sequence `*_cam.txt` intrinsics
(`manydepth/datasets/cityscapes_preprocessed_dataset.py:13-75`).
`CityscapesEvalDataset`: raw leftImg8bit frames, sequence frames at ±2,
75%-height crop, per-frame camera json
(`manydepth/datasets/cityscapes_evaldataset.py:15-108`).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from mal_tpu_torch.data.mono_dataset import MonoDataset, pil_loader


class CityscapesPreprocessedDataset(MonoDataset):
    RAW_WIDTH = 1024
    RAW_HEIGHT = 384

    def index_to_folder_and_frame_idx(self, index):
        city, frame_name = self.filenames[index].split()
        return city, frame_name, None

    def load_intrinsics(self, city, frame_name):
        camera_file = os.path.join(self.data_path, city, f"{frame_name}_cam.txt")
        camera = np.loadtxt(camera_file, delimiter=",")
        fx, fy, u0, v0 = camera[0], camera[4], camera[2], camera[5]
        K = np.array([[fx, 0, u0, 0], [0, fy, v0, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        K[0, :] /= self.RAW_WIDTH
        K[1, :] /= self.RAW_HEIGHT
        return K

    def __getitem__(self, index: int) -> dict:
        # triplet image: frames [-1, 0, 1] concatenated horizontally
        import random

        do_color_aug = self.is_train and self._rng.random() > 0.5
        do_flip = self.is_train and self._rng.random() > 0.5
        city, frame_name, _ = self.index_to_folder_and_frame_idx(index)

        triplet = np.asarray(pil_loader(
            os.path.join(self.data_path, city, f"{frame_name}.jpg")))
        w = triplet.shape[1] // 3
        frames = {-1: triplet[:, :w], 0: triplet[:, w:2 * w], 1: triplet[:, 2 * w:]}

        from mal_tpu_torch.data.mono_dataset import ColorJitter, _ANTIALIAS
        jitter = ColorJitter(self._rng) if do_color_aug else (lambda im: im)

        color, color_aug = {}, {}
        for i in self.frame_idxs:
            img = Image.fromarray(frames[i])
            if do_flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            img = img.resize((self.width, self.height), _ANTIALIAS)
            color[str(i)] = np.asarray(img, np.float32) / 255.0
            color_aug[str(i)] = np.asarray(jitter(img), np.float32) / 255.0

        K = self.load_intrinsics(city, frame_name)
        K = K.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        return {"color": color, "color_aug": color_aug, "K": K,
                "inv_K": np.linalg.pinv(K).astype(np.float32)}


class CityscapesEvalDataset(MonoDataset):
    RAW_HEIGHT = 1024
    RAW_WIDTH = 2048

    def index_to_folder_and_frame_idx(self, index):
        city, frame_name = self.filenames[index].split()
        return city, frame_name, None

    def load_intrinsics(self, city, frame_name):
        camera_file = os.path.join(self.data_path, "camera_trainvaltest",
                                   "camera", "test", city,
                                   frame_name + "_camera.json")
        with open(camera_file) as f:
            camera = json.load(f)
        intr = camera["intrinsic"]
        K = np.array([[intr["fx"], 0, intr["u0"], 0],
                      [0, intr["fy"], intr["v0"], 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
        K[0, :] /= self.RAW_WIDTH
        K[1, :] /= self.RAW_HEIGHT * 0.75
        return K

    def _offset_name(self, frame_name: str, offset: int) -> str:
        city, seq, num = frame_name.split("_")
        return f"{city}_{seq}_{str(int(num) + offset).zfill(6)}"

    def get_color(self, city, frame_index_or_name, side, do_flip):
        # frame ids map to sequence offsets of ±2 frames
        raise NotImplementedError("use __getitem__")

    def __getitem__(self, index: int) -> dict:
        city, frame_name, _ = self.index_to_folder_and_frame_idx(index)

        def load(name, is_sequence):
            folder = "leftImg8bit_sequence" if is_sequence else "leftImg8bit"
            path = os.path.join(self.data_path, folder, "test", city,
                                name + "_leftImg8bit.png")
            img = pil_loader(path)
            w, h = img.size
            img = img.crop((0, 0, w, h * 3 // 4))  # remove ego car
            from mal_tpu_torch.data.mono_dataset import _ANTIALIAS
            return img.resize((self.width, self.height), _ANTIALIAS)

        color = {"0": np.asarray(load(frame_name, False), np.float32) / 255.0}
        for i in self.frame_idxs:
            if i == 0:
                continue
            name = self._offset_name(frame_name, 2 * i)
            color[str(i)] = np.asarray(load(name, True), np.float32) / 255.0

        K = self.load_intrinsics(city, frame_name).copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        return {"color": color, "color_aug": color, "K": K,
                "inv_K": np.linalg.pinv(K).astype(np.float32)}
