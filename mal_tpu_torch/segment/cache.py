"""Precomputed segmenter-instance cache for the MAL temporal hint.

The port's copy of `mal_tpu.segment.cache`. The temporal hint segments the
current frame of every batch with the frozen Mask2Former, every epoch
(`manydepth/dyn_utils.py:125`), although those instances are a pure
function of the dataset image. `export_split_instances` (`python -m
mal_tpu_torch.cli export-seg`) writes them once; training with
`Config.seg_cache_root` set loads them with the batch and skips one of the
three segmenter forwards of a `temporal` step (the other two segment frames
warped by the live depth and pose, which cannot be cached).

The numpy half is `mal_tpu`'s, key for key and name for name, so a cache
written by either package loads in the other. Masks are binary and
bit-pack losslessly; classes and validity are integral; scores are stored
in fp32 as computed. Training flips frames with p=0.5 and a segmenter is
not flip-equivariant, so both orientations are written and the loader
takes the one that matches the item's flip draw.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mal_tpu_torch.device import resolve_device
from mal_tpu_torch.segment.instances import Instances

__all__ = ["cache_path", "save_frame_instances", "load_frame_instances",
           "load_cached_instances", "pack_masks", "unpack_masks",
           "export_split_instances", "instances_from_batch"]


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) binary float/bool -> (N, H, ceil(W/8)) uint8, lossless."""
    return np.packbits(np.asarray(masks) > 0.5, axis=-1)


def unpack_masks(packed: np.ndarray, width: int) -> np.ndarray:
    """Inverse of `pack_masks` -> (N, H, W) float32 binary."""
    bits = np.unpackbits(packed, axis=-1, count=width)
    return bits.astype(np.float32)


def cache_path(root: str, folder: str, frame_index: int, side,
               do_flip: bool) -> str:
    """One .npz per (frame, orientation); `folder` slashes flatten so the
    cache is a single directory."""
    key = folder.replace("/", "__").replace(os.sep, "__")
    side_s = side if side is not None else "x"
    flip_s = "_f" if do_flip else ""
    return os.path.join(root, f"{key}__{int(frame_index):010d}_{side_s}"
                              f"{flip_s}.npz")


def save_frame_instances(path: str, masks: np.ndarray, classes: np.ndarray,
                         scores: np.ndarray, valid: np.ndarray) -> None:
    np.savez_compressed(
        path,
        masks_bits=pack_masks(masks),
        width=np.int32(masks.shape[-1]),
        classes=np.asarray(classes, np.int32),
        scores=np.asarray(scores, np.float32),
        valid=np.asarray(valid, bool))


def load_frame_instances(path: str) -> dict:
    """-> dict of per-frame arrays in the batch key layout (`seg_*`)."""
    with np.load(path) as z:
        return {
            "seg_masks": unpack_masks(z["masks_bits"], int(z["width"])),
            "seg_classes": z["classes"],
            "seg_scores": z["scores"],
            "seg_valid": z["valid"],
        }


def load_cached_instances(root: str, folder: str, frame_index: int, side,
                          do_flip: bool) -> dict:
    """`load_frame_instances` of one item's frame in the orientation of its
    flip draw, raising on a cache miss with the command that fills it."""
    path = cache_path(root, folder, frame_index, side, do_flip)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"segmenter-instance cache miss: {path} — run `python -m "
            f"mal_tpu_torch.cli export-seg` for this split first (both "
            f"orientations are exported)")
    return load_frame_instances(path)


def instances_from_batch(batch: dict) -> Instances:
    """The collated `seg_*` tensors as `Instances`: the cached stand-in for
    `seg_fn(batch["color"]["0"])` in the train step."""
    return Instances(masks=batch["seg_masks"], classes=batch["seg_classes"],
                     scores=batch["seg_scores"], valid=batch["seg_valid"])


def export_split_instances(dataset, seg_fn, out_root: str,
                           batch_size: int = 12,
                           device: str | torch.device | None = None,
                           log_every: int = 50, print_fn=print) -> int:
    """Run the frozen segmenter `seg_fn(images (B, H, W, 3)) -> Instances`
    on `device` (default: the GPU, raising if there is none) over every
    sample's current frame in `dataset`, in both orientations, and write
    the per-frame cache under `out_root`. Returns the number of files
    written.

    `dataset` is a `MonoDataset`: `index_to_folder_and_frame_idx` names
    the frame and `get_color(..., do_flip)` plus the training resize give
    the image `__getitem__` gives. A split may repeat a frame: each
    (folder, frame, side) is segmented once. Files already on disk are
    skipped, so the export resumes where it stopped. Frames go through in
    chunks of `batch_size`; the last chunk is not padded (`mal_tpu` pads
    it to keep one compiled program).
    """
    # imported here: `data/mono_dataset.py` imports this module
    from mal_tpu_torch.data.mono_dataset import _ANTIALIAS

    device = resolve_device(device)
    os.makedirs(out_root, exist_ok=True)

    entries = []
    seen = set()
    for i in range(len(dataset)):
        key = tuple(dataset.index_to_folder_and_frame_idx(i))
        if key not in seen:
            seen.add(key)
            entries.append(key)

    todo = []
    for folder, frame_index, side in entries:
        for flip in (False, True):
            path = cache_path(out_root, folder, frame_index, side, flip)
            if not os.path.exists(path):
                todo.append((folder, frame_index, side, flip, path))

    written = 0
    with torch.inference_mode():
        for start in range(0, len(todo), batch_size):
            chunk = todo[start:start + batch_size]
            imgs = []
            for folder, frame_index, side, flip, _ in chunk:
                img = dataset.get_color(folder, frame_index, side, flip)
                img = img.resize((dataset.width, dataset.height), _ANTIALIAS)
                imgs.append(np.asarray(img, np.float32) / 255.0)
            inst = seg_fn(torch.from_numpy(np.stack(imgs)).to(device))
            masks, classes, scores, valid = (t.cpu().numpy() for t in inst)
            for j, (*_, path) in enumerate(chunk):
                save_frame_instances(path, masks[j], classes[j], scores[j],
                                     valid[j])
                written += 1
            if log_every and (start // batch_size) % log_every == 0:
                print_fn(f"export-seg: {min(start + batch_size, len(todo))}"
                         f"/{len(todo)} frames")
    return written
