"""The port's datasets and loaders (`mal_tpu_torch.data`) against
`mal_tpu.data`, on fake on-disk trees made from numpy seeds.

The datasets are copies of plain numpy / PIL code, so their items must be
equal exactly, random augmentations included (each side seeded alike). The
loaders' batches must be equal across epochs and host shards; the native
decode is the same `native/malio.cpp` built by each package with the same
flags, so where both libraries build their batches are equal too.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mal_tpu.data import native as j_native
from mal_tpu.data.cityscapes import CityscapesPreprocessedDataset as JCSPre
from mal_tpu.data.ddad import DDADDataset as JDDAD
from mal_tpu.data.doj import attach_doj_masks as j_attach
from mal_tpu.data.doj import load_doj_masks as j_load_doj
from mal_tpu.data.fast_loader import NativePrefetchLoader as JNative
from mal_tpu.data.kitti import KITTIRAWDataset as JKITTI
from mal_tpu.data.mono_dataset import DataLoader as JLoader
from mal_tpu_torch.data import native
from mal_tpu_torch.data.cityscapes import CityscapesPreprocessedDataset
from mal_tpu_torch.data.ddad import DDADDataset
from mal_tpu_torch.data.doj import attach_doj_masks, load_doj_masks
from mal_tpu_torch.data.fast_loader import NativePrefetchLoader
from mal_tpu_torch.data.kitti import KITTIRAWDataset
from mal_tpu_torch.data.mono_dataset import DataLoader
from mal_tpu_torch.data.synthetic import KITTI_DRIVE, write_fake_kitti

H, W = 32, 96


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core then oversubscribes
    them (30x slower steps measured under a six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(a, b, path=""):
    """Nested dicts of arrays equal exactly, with the same keys."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """A fake KITTI drive of 10 frames at 200x60, its 8 training lines, and
    a line at frame 0, whose frame -1 is missing."""
    root = str(tmp_path_factory.mktemp("kitti"))
    paths = write_fake_kitti(root, n_train=8, n_test=4, size=(200, 60))
    with open(paths["eigen_zhou"]) as f:
        lines = [l.strip() for l in f]
    lines.append(f"{KITTI_DRIVE} 0 l")
    return paths["data_path"], lines


@pytest.mark.parametrize("is_train", [False, True])
def test_kitti_items(kitti, is_train):
    data, lines = kitti
    args = (data, lines, H, W, [0, -1, 1])
    ours = KITTIRAWDataset(*args, is_train=is_train, seed=3)
    theirs = JKITTI(*args, is_train=is_train, seed=3)
    for i in range(len(lines)):
        _equal(ours[i], theirs[i], f"item {i}")
    assert ours[len(lines) - 1]["color"]["-1"].sum() == 0


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    """Preprocessed CityScapes: 3-wide triplet JPEGs and `_cam.txt` files."""
    root = tmp_path_factory.mktemp("cs")
    rng = np.random.RandomState(1)
    lines = []
    for city in ("aachen", "ulm"):
        (root / city).mkdir()
        for n in range(2):
            name = f"{city}_000000_00001{n}"
            img = rng.randint(0, 256, (48, 3 * 128, 3)).astype(np.uint8)
            Image.fromarray(img).save(root / city / f"{name}.jpg")
            cam = [2262.5, 0, 1096.9, 0, 2265.3, 513.1, 0, 0, 1]
            np.savetxt(root / city / f"{name}_cam.txt", [cam], delimiter=",")
            lines.append(f"{city} {name}")
    return str(root), lines


@pytest.mark.parametrize("is_train", [False, True])
def test_cityscapes_preprocessed_items(cityscapes, is_train):
    root, lines = cityscapes
    args = (root, lines, H, W, [0, -1, 1])
    ours = CityscapesPreprocessedDataset(*args, is_train=is_train, seed=5)
    theirs = JCSPre(*args, is_train=is_train, seed=5)
    for i in range(len(lines)):
        _equal(ours[i], theirs[i], f"item {i}")


def test_ddad_items(tmp_path):
    rng = np.random.RandomState(2)
    (tmp_path / "val").mkdir()
    for i in range(2):
        np.savez(tmp_path / "val" / f"{i:04d}.npz",
                 **{k: rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
                    for k in ("color_prev", "color", "color_next")},
                 K=rng.uniform(1, 100, (3, 3)).astype(np.float32),
                 depth_gt=rng.uniform(0, 200, (H, W)).astype(np.float32))
    ours, theirs = DDADDataset(str(tmp_path), H, W), JDDAD(str(tmp_path), H, W)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        _equal(ours[i], theirs[i], f"item {i}")


def test_doj_masks(kitti, tmp_path):
    data, lines = kitti
    rng = np.random.RandomState(4)
    key = f"{KITTI_DRIVE.replace('/', '_')}_2_l"
    for suffix in ("", "-1"):   # "+1" missing: a zero mask
        np.save(tmp_path / f"{key}{suffix}.npy",
                (rng.uniform(size=(60, 200)) > 0.7).astype(np.float32))
    for flip in (False, True):
        _equal(load_doj_masks(str(tmp_path), key, H, W, flip),
               j_load_doj(str(tmp_path), key, H, W, flip))
    args = (data, lines, H, W, [0, -1, 1])
    ours = attach_doj_masks(KITTIRAWDataset(*args), str(tmp_path))
    theirs = j_attach(JKITTI(*args), str(tmp_path))
    for i in range(len(lines)):
        _equal(ours[i], theirs[i], f"item {i}")
    assert ours[1]["doj_mask"].sum() > 0


@pytest.mark.parametrize("loader", ["pil", "native"])
def test_loaders_match_across_epochs_and_shards(kitti, loader):
    data, lines = kitti
    args = (data, lines * 2, H, W, [0, -1, 1])
    for shard in ((0, 1), (0, 2), (1, 2)):
        ours_ds = KITTIRAWDataset(*args, is_train=True, seed=7)
        theirs_ds = JKITTI(*args, is_train=True, seed=7)
        if loader == "pil":
            ours = DataLoader(ours_ds, 3, shuffle=True, seed=1, shard=shard)
            theirs = JLoader(theirs_ds, 3, shuffle=True, seed=1, shard=shard)
        else:
            ours = NativePrefetchLoader(ours_ds, 3, seed=1, shard=shard,
                                        num_threads=2)
            theirs = JNative(theirs_ds, 3, seed=1, shard=shard,
                             num_threads=2)
        assert len(ours) == len(theirs)
        for epoch in (0, 1):
            got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
            assert len(got) == len(want) == len(ours)
            for b, (g, w) in enumerate(zip(got, want)):
                _equal(g, w, f"{loader} shard {shard} epoch {epoch} batch {b}")


def test_native_builds_outside_the_repo_native_dir():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert os.path.dirname(native.LIB_PATH).endswith(
        os.path.join("build", "mal_tpu_torch_native"))
    assert j_native.available()


def test_native_decode_matches_pil_and_mal_tpu(kitti):
    data, lines = kitti
    img_dir = os.path.join(data, KITTI_DRIVE, "image_02", "data")
    paths = [os.path.join(img_dir, f"{i:010d}.jpg") for i in range(3)]
    flips = [False, True, False]
    got = native.load_batch(paths, W, H, flips, num_threads=2)
    np.testing.assert_array_equal(
        got, j_native.load_batch(paths, W, H, flips, num_threads=2))
    for i, (p, f) in enumerate(zip(paths, flips)):
        np.testing.assert_array_equal(native.load_image(p, W, H, f), got[i])
        # the native Lanczos and PIL's agree to within 1/255 rounding, as
        # tests/test_native.py holds mal_tpu's
        pil = native._load_image_pil(p, W, H, f)
        assert np.abs(got[i] - pil).max() <= 1.5 / 255.0
