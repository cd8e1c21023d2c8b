"""Segmentation dataset catalogs + training-target mappers (numpy).

A copy of `mal_tpu.segment.datasets`, held against it by
`tests/test_torch_seg_data.py`; the port imports nothing of `mal_tpu`.

Covers the reference's detectron2 registration + mapper layer for the
Mask2Former family (`mask2former/data/datasets/register_*.py` ~2,800 LoC;
`mask2former/data/dataset_mappers/mask_former_{semantic,panoptic}_dataset_
mapper.py`), re-designed for this stack:

- **Catalogs** are plain frozen records (`SegCatalog`) in a registry dict
  instead of detectron2's global `DatasetCatalog`/`MetadataCatalog` pair.
  Facts that are universal dataset contracts (class counts, ignore
  labels, the Cityscapes labelId->trainId table, thing/stuff splits the
  reference hardcodes) live here; the huge per-class name/color tables
  (e.g. the 847-entry ADE20K-full list, `register_ade20k_full.py:17-870`)
  are NOT duplicated as source — `catalog_from_panoptic_json` builds a
  catalog from the dataset distribution's own `categories.json`, which is
  where those tables came from in the first place.
- **Mappers** are pure numpy functions producing the SAME padded
  static-shape target contract as `segment/finetune.py:coco_to_targets`
  — (labels (T,), masks (T, H, W) f32, valid (T,)) — so every dataset
  family feeds the one set criterion (`segment/criterion.py`). The
  reference instead emits variable-length `Instances` per image
  (`mask_former_semantic_dataset_mapper.py:163-183`), which would retrace
  per unique segment count under `mal_tpu`'s jit.

Reference semantics preserved: unique-labels -> per-class binary masks
with the ignore label dropped (semantic), `segments_info` with
iscrowd skipped (panoptic, `mask_former_panoptic_dataset_mapper.py:
143-151`), panopticapi's rgb2id encoding, size-divisibility padding with
image value 128 / semantic pad = ignore_label / panoptic pad = 0 (VOID)
(`mask_former_semantic_dataset_mapper.py:131-146`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = [
    "SegCatalog", "CATALOGS", "catalog_from_panoptic_json", "rgb2id",
    "semantic_to_targets", "panoptic_to_targets", "pad_divisible",
    "cityscapes_labelid_to_trainid", "SemSegFolderDataset",
]


# ---------------------------------------------------------------------------
# Catalogs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SegCatalog:
    """Metadata for one registered segmentation dataset flavor."""
    name: str
    num_classes: int
    ignore_label: int
    # contiguous ids that are "things" (instances exist); empty for pure
    # semantic datasets. Stuff = everything else.
    thing_ids: tuple = ()
    # optional class names, contiguous-id order (may be empty: loaders
    # that need names pull them from the dataset's own metadata)
    class_names: tuple = ()
    # label-png value -> contiguous train id; None = identity (after
    # `label_shift`)
    label_map: dict | None = field(default=None, hash=False)
    # added to raw label values before the map (ADE20K pngs store
    # 0=ignore, 1..150 -> shift -1 with 0 mapped to ignore)
    label_shift: int = 0


# The Cityscapes 19-class training contract: labelIds (the *_labelIds.png
# values) -> train ids, everything else ignored. This is the standard
# cityscapesscripts table the reference relies on via detectron2.
_CS_TRAIN = {7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
             22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16,
             32: 17, 33: 18}
_CS_NAMES = ("road", "sidewalk", "building", "wall", "fence", "pole",
             "traffic light", "traffic sign", "vegetation", "terrain",
             "sky", "person", "rider", "car", "truck", "bus", "train",
             "motorcycle", "bicycle")


def cityscapes_labelid_to_trainid(label_png: np.ndarray,
                                  ignore_label: int = 255) -> np.ndarray:
    """Vectorized labelId -> trainId (unmapped ids -> ignore)."""
    lut = np.full((256,), ignore_label, np.int32)
    for k, v in _CS_TRAIN.items():
        lut[k] = v
    return lut[label_png.astype(np.int32)]


CATALOGS: dict[str, SegCatalog] = {
    # mirrors detectron2's builtin registration the reference depends on
    "cityscapes_sem_seg": SegCatalog(
        "cityscapes_sem_seg", 19, 255, class_names=_CS_NAMES,
        label_map=_CS_TRAIN),
    # Cityscapes panoptic: things = train ids 11..18 (person..bicycle)
    "cityscapes_panoptic": SegCatalog(
        "cityscapes_panoptic", 19, 255, thing_ids=tuple(range(11, 19)),
        class_names=_CS_NAMES, label_map=_CS_TRAIN),
    # ADE20K-150 (`register_ade20k_panoptic.py`): pngs store 0=ignore,
    # 1..150; contiguous ids 0..149, ignore 255
    "ade20k_sem_seg": SegCatalog(
        "ade20k_sem_seg", 150, 255, label_shift=-1),
    # ADE20K instance subset: 100 thing classes (`register_ade20k_
    # instance.py`); the id list ships with the dataset's JSON
    "ade20k_instance": SegCatalog("ade20k_instance", 100, 255),
    # Mapillary Vistas (`register_mapillary_vistas.py:501`): 65 evaluated
    # classes, ignore label 65 (NOT 255 — upstream calls this out)
    "mapillary_vistas_sem_seg": SegCatalog(
        "mapillary_vistas_sem_seg", 65, 65),
    # COCO-Stuff-10k (`register_coco_stuff_10k.py`): 171 classes
    "coco_stuff_10k_sem_seg": SegCatalog(
        "coco_stuff_10k_sem_seg", 171, 255),
    # COCO panoptic (`register_coco_panoptic_annos_semseg.py`): 133
    # contiguous classes, 80 things + 53 stuff; the thing/stuff id split
    # comes from the dataset's categories.json via
    # catalog_from_panoptic_json at load time
    "coco_panoptic": SegCatalog("coco_panoptic", 133, 255),
}


def catalog_from_panoptic_json(name: str, categories_json: str,
                               ignore_label: int = 255) -> SegCatalog:
    """Build a catalog from a panoptic `categories.json` (COCO/ADE/
    Mapillary distribution format: [{"id", "name", "isthing", ...}]).

    Replaces the reference's hardcoded per-dataset tables: category ids
    are mapped to contiguous train ids in file order, `isthing` decides
    the thing set — exactly what `register_ade20k_panoptic.py:360-390` /
    `register_mapillary_vistas_panoptic.py` derive from their inlined
    copies of the same data.
    """
    with open(categories_json) as f:
        cats = json.load(f)
    if isinstance(cats, dict):  # full panoptic json with a categories key
        cats = cats["categories"]
    label_map = {int(c["id"]): i for i, c in enumerate(cats)}
    things = tuple(i for i, c in enumerate(cats) if c.get("isthing", 0))
    names = tuple(str(c.get("name", i)) for i, c in enumerate(cats))
    return SegCatalog(name, len(cats), ignore_label, thing_ids=things,
                      class_names=names, label_map=label_map)


# ---------------------------------------------------------------------------
# Mappers
# ---------------------------------------------------------------------------


def rgb2id(color: np.ndarray) -> np.ndarray:
    """panopticapi id encoding: R + 256 G + 256^2 B. (H, W, 3) -> (H, W)."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def _apply_label_map(sem: np.ndarray, cat: SegCatalog) -> np.ndarray:
    sem = sem.astype(np.int32)
    if cat.label_shift:
        ig = sem == cat.ignore_label if cat.label_shift < 0 else None
        sem = sem + cat.label_shift
        # shifted-below-zero values (e.g. ADE's 0=unlabeled) become ignore
        sem = np.where(sem < 0, cat.ignore_label, sem)
        if ig is not None:
            sem = np.where(ig, cat.ignore_label, sem)
    if cat.label_map is not None:
        lut = np.full((max(cat.label_map) + 1,), cat.ignore_label, np.int32)
        for k, v in cat.label_map.items():
            lut[k] = v
        clipped = np.clip(sem, 0, lut.shape[0] - 1)
        sem = np.where((sem >= 0) & (sem < lut.shape[0]), lut[clipped],
                       cat.ignore_label)
    return sem


def semantic_to_targets(sem_seg: np.ndarray, catalog: SegCatalog,
                        max_segments: int):
    """Semantic label map -> padded per-class binary-mask targets.

    The reference's unique-labels loop (`mask_former_semantic_dataset_
    mapper.py:163-183`): one target per class present, ignore dropped.
    Returns (labels (T,) int32, masks (T, H, W) f32, valid (T,) bool) —
    the `segment/criterion.py` contract.
    """
    sem = _apply_label_map(np.asarray(sem_seg), catalog)
    T = max_segments
    H, W = sem.shape
    labels = np.zeros((T,), np.int32)
    masks = np.zeros((T, H, W), np.float32)
    valid = np.zeros((T,), bool)
    classes = [c for c in np.unique(sem)
               if c != catalog.ignore_label and 0 <= c < catalog.num_classes]
    for i, c in enumerate(classes[:T]):
        labels[i] = c
        masks[i] = (sem == c).astype(np.float32)
        valid[i] = True
    return labels, masks, valid


def panoptic_to_targets(pan_png: np.ndarray, segments_info: Sequence[dict],
                        catalog: SegCatalog, max_segments: int):
    """Panoptic id map (+ segments_info) -> padded targets.

    pan_png: (H, W, 3) color-encoded png (panopticapi) OR (H, W) raw ids.
    One target per non-crowd segment, category ids mapped contiguous
    (`mask_former_panoptic_dataset_mapper.py:143-158`).
    """
    ids = rgb2id(pan_png) if pan_png.ndim == 3 else pan_png.astype(np.uint32)
    T = max_segments
    H, W = ids.shape
    labels = np.zeros((T,), np.int32)
    masks = np.zeros((T, H, W), np.float32)
    valid = np.zeros((T,), bool)
    i = 0
    for seg in segments_info:
        if seg.get("iscrowd", 0) or i >= T:
            continue
        cid = int(seg["category_id"])
        if catalog.label_map is not None:
            if cid not in catalog.label_map:
                continue
            cid = catalog.label_map[cid]
        labels[i] = cid
        masks[i] = (ids == int(seg["id"])).astype(np.float32)
        valid[i] = True
        i += 1
    return labels, masks, valid


def pad_divisible(image: np.ndarray, sem_seg: np.ndarray | None,
                  divisibility: int, catalog: SegCatalog | None = None,
                  pan_seg: np.ndarray | None = None):
    """Bottom/right-pad to a size multiple: image with 128, semantic with
    the ignore label, panoptic with 0 = VOID (`mask_former_semantic_
    dataset_mapper.py:131-146`)."""
    if divisibility <= 0:
        return image, sem_seg, pan_seg
    H, W = image.shape[:2]
    ph = (-H) % divisibility
    pw = (-W) % divisibility
    if ph == 0 and pw == 0:
        return image, sem_seg, pan_seg
    image = np.pad(image, ((0, ph), (0, pw), (0, 0)), constant_values=128)
    if sem_seg is not None:
        ig = catalog.ignore_label if catalog is not None else 255
        sem_seg = np.pad(sem_seg, ((0, ph), (0, pw)), constant_values=ig)
    if pan_seg is not None:
        pad = [(0, ph), (0, pw)] + [(0, 0)] * (pan_seg.ndim - 2)
        pan_seg = np.pad(pan_seg, pad, constant_values=0)
    return image, sem_seg, pan_seg


# ---------------------------------------------------------------------------
# Folder loader (semantic pairs)
# ---------------------------------------------------------------------------


class SemSegFolderDataset:
    """(image, label-png) pairs from parallel directory trees — the
    loader role of `register_ade20k_full.py:load_sem_seg` / detectron2's
    `load_sem_seg`, without the global catalog side table.

    Matches files by shared relative stem: image_root/<stem><image_ext>
    <-> gt_root/<stem><gt_ext>. `__getitem__` returns the mapper-ready
    dict; `targets(idx, max_segments)` applies `semantic_to_targets` for
    the set criterion.
    """

    def __init__(self, image_root: str, gt_root: str, catalog: SegCatalog,
                 image_ext: str = ".jpg", gt_ext: str = ".png",
                 size_divisibility: int = 0):
        self.catalog = catalog
        self.size_divisibility = size_divisibility
        stems = []
        for dirpath, _, files in os.walk(gt_root):
            rel = os.path.relpath(dirpath, gt_root)
            for f in sorted(files):
                if f.endswith(gt_ext):
                    stem = os.path.join("" if rel == "." else rel,
                                        f[: -len(gt_ext)])
                    if os.path.exists(os.path.join(image_root,
                                                   stem + image_ext)):
                        stems.append(stem)
        self.image_root, self.gt_root = image_root, gt_root
        self.image_ext, self.gt_ext = image_ext, gt_ext
        self.stems = stems

    def __len__(self):
        return len(self.stems)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        stem = self.stems[idx]
        img = np.asarray(Image.open(
            os.path.join(self.image_root, stem + self.image_ext)).convert(
            "RGB"))
        sem = np.asarray(Image.open(
            os.path.join(self.gt_root, stem + self.gt_ext)))
        img, sem, _ = pad_divisible(img, sem, self.size_divisibility,
                                    self.catalog)
        return {"image": img, "sem_seg": sem, "stem": stem}

    def targets(self, idx: int, max_segments: int):
        item = self[idx]
        return item["image"], semantic_to_targets(
            item["sem_seg"], self.catalog, max_segments)
