"""The port's numpy copies for segmenter fine-tuning against `mal_tpu`'s,
on the CPU: COCO RLE decoding and target padding, the polygon raster, the
COCO dataset on a temporary tree, mask AP and the semantic / panoptic
dataset mappers. Each must equal its original bit for bit, except the
polygon raster, which replaces matplotlib's point-in-path test by the
even-odd rule at pixel centres: equal on polygons whose edges pass through
no pixel centre (random non-integer vertices)."""

import json
import os

import numpy as np
import pytest
import torch

from mal_tpu.segment import coco as j_coco
from mal_tpu.segment import datasets as j_ds
from mal_tpu.segment import evaluation as j_eval
from mal_tpu.segment import finetune as j_ft
from mal_tpu_torch.data.synthetic import _rle_counts, write_fake_coco
from mal_tpu_torch.segment import coco, datasets, evaluation, finetune


def _random_mask(rng, h, w):
    return (rng.uniform(size=(h, w)) < 0.3).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_decode_and_targets(seed):
    rng = np.random.RandomState(seed)
    h, w = 13, 17
    masks = [_random_mask(rng, h, w) for _ in range(5)]
    masks[1][0, 0] = 1                                 # a leading 0-run
    anns = []
    for i, m in enumerate(masks):
        counts = _rle_counts(m)
        rle = {"counts": counts, "size": [h, w]}
        got = finetune.rle_decode(counts, (h, w))
        np.testing.assert_array_equal(got, j_ft.rle_decode(counts, (h, w)))
        np.testing.assert_array_equal(got, m)
        anns.append({"category_id": [3, 90, 17][i % 3],
                     "segmentation": rle if i % 2 else m})
    cat = finetune.category_index([90, 3, 17, 3])
    assert cat == j_ft.category_index([90, 3, 17, 3]) == {3: 0, 17: 1, 90: 2}
    for T in (3, 8):
        got = finetune.coco_to_targets(anns, h, w, T, cat)
        want = j_ft.coco_to_targets(anns, h, w, T, cat)
        for g, x in zip(got, want, strict=True):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
    labels, masks_t, valid = finetune.collate_targets(
        [finetune.coco_to_targets(anns, h, w, 8, cat)] * 2)
    assert labels.shape == (2, 8) and masks_t.shape == (2, 8, h, w)
    assert valid.dtype == torch.bool and valid.sum() == 10


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_polygon_raster_matches_matplotlib(seed):
    """Star-shaped and self-intersecting polygons, several parts, vertices
    inside and outside the frame, at non-integer coordinates."""
    rng = np.random.RandomState(seed)
    h, w = 37, 53
    polys = []
    for part in range(3):
        n = rng.randint(3, 10)
        pts = rng.uniform(-5, 60, (n, 2)) + 0.123
        if part == 0:                                  # star-shaped
            c = rng.uniform(10, 30, 2)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            r = rng.uniform(3, 15, n)
            pts = c + np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
        polys.append(pts.ravel().tolist())
    got = coco.polygon_to_mask(polys, h, w)
    want = j_coco.polygon_to_mask(polys, h, w)
    assert got.dtype == want.dtype == np.uint8
    assert 0 < want.sum() < h * w
    np.testing.assert_array_equal(got, want)


def test_coco_dataset_on_a_tree(tmp_path):
    """The same items and batches from a fake COCO tree (RLE and polygon
    instances, sparse ids), and a compressed RLE refused by both."""
    paths = write_fake_coco(str(tmp_path), n_images=4, n_categories=7,
                            size=(120, 90), seed=3)
    args = (paths["annotations"], paths["images"], 48, 64, 5)
    ds, jds = coco.CocoInstanceDataset(*args), j_coco.CocoInstanceDataset(*args)
    assert len(ds) == len(jds) == 4 and ds.num_classes == jds.num_classes == 7
    for i in range(4):
        for g, x in zip(ds[i], jds[i], strict=True):
            np.testing.assert_array_equal(g, x)
    for got, want in zip(ds.batches(2, seed=5), jds.batches(2, seed=5),
                         strict=True):
        for g, x in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    with open(paths["annotations"]) as f:
        data = json.load(f)
    data["annotations"][0]["segmentation"] = {"counts": "abc", "size": [90, 120]}
    bad = os.path.join(tmp_path, "bad.json")
    with open(bad, "w") as f:
        json.dump(data, f)
    for module in (coco, j_coco):
        with pytest.raises(NotImplementedError, match="compressed"):
            module.CocoInstanceDataset(bad, paths["images"], 48, 64)[0]


def test_mask_ap():
    """Predictions near the ground truth, with duplicates, misses, wrong
    classes and more than `max_dets` detections."""
    rng = np.random.RandomState(4)
    h, w = 20, 24
    preds, gts = [], []
    for _ in range(3):
        g = np.stack([_random_mask(rng, h, w) for _ in range(4)])
        gc = rng.randint(0, 3, 4)
        noisy = g ^ (rng.uniform(size=g.shape) < 0.1)
        p = np.concatenate([noisy, noisy[:2], np.stack(
            [_random_mask(rng, h, w) for _ in range(3)])])
        preds.append({"masks": p, "scores": rng.uniform(size=len(p)),
                      "classes": np.concatenate([gc, gc[:2],
                                                 rng.randint(0, 3, 3)])})
        gts.append({"masks": g, "classes": gc})
    for max_dets in (100, 5):
        got = evaluation.evaluate_instances(preds, gts, max_dets=max_dets)
        want = j_eval.evaluate_instances(preds, gts, max_dets=max_dets)
        assert got == want and 0 < got["AP"] < 100
    np.testing.assert_array_equal(
        evaluation.mask_iou(preds[0]["masks"], gts[0]["masks"]),
        j_eval.mask_iou(preds[0]["masks"], gts[0]["masks"]))


def test_dataset_mappers(tmp_path):
    """Cityscapes labelIds, ADE's shifted labels, a panoptic png with a
    crowd segment, padding, a catalog from categories.json and the folder
    dataset."""
    rng = np.random.RandomState(5)
    label = rng.randint(0, 40, (16, 20)).astype(np.uint8)
    np.testing.assert_array_equal(
        datasets.cityscapes_labelid_to_trainid(label),
        j_ds.cityscapes_labelid_to_trainid(label))
    for name in ("cityscapes_sem_seg", "ade20k_sem_seg",
                 "mapillary_vistas_sem_seg"):
        for T in (4, 40):
            got = datasets.semantic_to_targets(label, datasets.CATALOGS[name], T)
            want = j_ds.semantic_to_targets(label, j_ds.CATALOGS[name], T)
            for g, x in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, x)
    assert set(datasets.CATALOGS) == set(j_ds.CATALOGS)
    for k, c in j_ds.CATALOGS.items():
        assert datasets.CATALOGS[k].__dict__ == c.__dict__, k

    cats = [{"id": 7, "name": "a", "isthing": 1},
            {"id": 3, "name": "b", "isthing": 0},
            {"id": 11, "name": "c", "isthing": 1}]
    cj = os.path.join(tmp_path, "categories.json")
    with open(cj, "w") as f:
        json.dump(cats, f)
    cat = datasets.catalog_from_panoptic_json("x", cj)
    assert cat.__dict__ == j_ds.catalog_from_panoptic_json("x", cj).__dict__
    ids = rng.randint(0, 4, (16, 20))
    pan = np.stack([ids * 10, ids, np.zeros_like(ids)], -1).astype(np.uint8)
    info = [{"id": 10 * k + 256 * k, "category_id": [7, 3, 11, 7][k],
             "iscrowd": int(k == 2)} for k in range(4)]
    for T in (2, 8):
        got = datasets.panoptic_to_targets(pan, info, cat, T)
        want = j_ds.panoptic_to_targets(pan, info, cat, T)
        for g, x in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, x)

    img = rng.randint(0, 255, (15, 21, 3)).astype(np.uint8)
    for got, want in zip(
            datasets.pad_divisible(img, label[:15, :21], 8,
                                   datasets.CATALOGS["ade20k_sem_seg"],
                                   pan[:15, :21]),
            j_ds.pad_divisible(img, label[:15, :21], 8,
                               j_ds.CATALOGS["ade20k_sem_seg"], pan[:15, :21]),
            strict=True):
        np.testing.assert_array_equal(got, want)

    from PIL import Image
    for sub in ("img/a", "gt/a"):
        os.makedirs(os.path.join(tmp_path, sub))
    Image.fromarray(img).save(os.path.join(tmp_path, "img/a/x.jpg"))
    Image.fromarray(label[:15, :21]).save(os.path.join(tmp_path, "gt/a/x.png"))
    args = (os.path.join(tmp_path, "img"), os.path.join(tmp_path, "gt"))
    ds = datasets.SemSegFolderDataset(*args, datasets.CATALOGS["ade20k_sem_seg"],
                                      size_divisibility=32)
    jds = j_ds.SemSegFolderDataset(*args, j_ds.CATALOGS["ade20k_sem_seg"],
                                   size_divisibility=32)
    assert ds.stems == jds.stems == ["a/x"]
    got_img, got_t = ds.targets(0, 6)
    want_img, want_t = jds.targets(0, 6)
    np.testing.assert_array_equal(got_img, want_img)
    for g, x in zip(got_t, want_t, strict=True):
        np.testing.assert_array_equal(g, x)
