"""The port's segmenter-instance cache (`mal_tpu_torch.segment.cache`)
against `mal_tpu.segment.cache`, on the CPU.

The numpy half is a copy, so arrays, file names and files must be equal
exactly, and a cache written by either package must load in the other. The
export runs a deterministic stand-in segmenter, written once in jnp and
once in torch, over a fake KITTI tree in both packages: every file equal,
both orientations, resumable. Then the loaders (PIL and native) pick the
file of each item's flip draw, the cached training step equals the online
one, and `cli export-seg` runs end to end with a Swin-T segmenter.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.data.fast_loader import NativePrefetchLoader as JNative
from mal_tpu.data.kitti import KITTIRAWDataset as JKITTI
from mal_tpu.segment import cache as jcache
from mal_tpu.segment.instances import Instances as JInstances
from mal_tpu_torch.data import native
from mal_tpu_torch.data.fast_loader import NativePrefetchLoader
from mal_tpu_torch.data.kitti import KITTIRAWDataset
from mal_tpu_torch.data.mono_dataset import _ANTIALIAS
from mal_tpu_torch.data.synthetic import write_fake_kitti
from mal_tpu_torch.segment import cache
from mal_tpu_torch.segment.instances import Instances
from mal_tpu_torch.train.state import create_train_state
from mal_tpu_torch.train.step import make_train_step

from test_torch_common import CFG, np_batch, to_torch, torch_cfg

H, W = 32, 96
FRAMES = [0, -1, 1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_data.py says why."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """A fake KITTI drive at 200x60 and 8 training lines, one of them
    twice (a split may repeat a frame)."""
    root = str(tmp_path_factory.mktemp("kitti_seg"))
    paths = write_fake_kitti(root, n_train=8, n_test=4, size=(200, 60))
    with open(paths["eigen_zhou"]) as f:
        lines = [line.strip() for line in f]
    return paths["data_path"], lines + lines[:1]


# --------------------------------------------------------------------------
# The stand-in segmenter: three instances a frame, each a function of the
# pixels computed exactly alike in float32 by jnp and torch, none
# flip-equivariant (scores and classes read the top-left pixels)
# --------------------------------------------------------------------------

def _j_seg(seg_variables, images):
    masks = jnp.stack([images[..., 0] > 0.5, images[..., 1] > 0.4,
                       images[..., 2] < 0.3], axis=1).astype(jnp.float32)
    first = (images[:, 0, 0, 1] * 255).astype(jnp.int32) % 80
    classes = jnp.stack([first, jnp.full_like(first, 3),
                         jnp.full_like(first, 7)], axis=1)
    scores = images[:, 0, :3, 0]
    return JInstances(masks, classes, scores, scores > 0.2)


def _t_seg(images):
    masks = torch.stack([images[..., 0] > 0.5, images[..., 1] > 0.4,
                         images[..., 2] < 0.3], dim=1).float()
    first = (images[:, 0, 0, 1] * 255).to(torch.int32) % 80
    classes = torch.stack([first, torch.full_like(first, 3),
                           torch.full_like(first, 7)], dim=1)
    scores = images[:, 0, :3, 0].contiguous()
    return Instances(masks, classes, scores, scores > 0.2)


def _instance_arrays(rng, n=5, h=13, w=37):
    return ((rng.rand(n, h, w) > 0.5).astype(np.float32),
            rng.randint(0, 80, n).astype(np.int32),
            rng.rand(n).astype(np.float32), rng.rand(n) > 0.3)


def _assert_same_files(a: str, b: str) -> None:
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


# --------------------------------------------------------------------------
# The numpy half
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,width", [(0, 37), (1, 96), (2, 8)])
def test_pack_and_unpack_match_mal_tpu(seed, width):
    masks = (np.random.RandomState(seed).rand(4, 13, width) > 0.5
             ).astype(np.float32)
    packed = cache.pack_masks(masks)
    np.testing.assert_array_equal(packed, jcache.pack_masks(masks))
    assert packed.dtype == np.uint8 and packed.shape[-1] == -(-width // 8)
    np.testing.assert_array_equal(cache.unpack_masks(packed, width), masks)
    np.testing.assert_array_equal(jcache.unpack_masks(packed, width), masks)


@pytest.mark.parametrize("folder,index,side,flip", [
    ("2011_09_26/2011_09_26_drive_0001_sync", 7, "l", True),
    ("aachen", 12345, None, False), ("a/b/c", 0, "r", False)])
def test_cache_path_matches_mal_tpu(tmp_path, folder, index, side, flip):
    got = cache.cache_path(str(tmp_path), folder, index, side, flip)
    assert got == jcache.cache_path(str(tmp_path), folder, index, side, flip)
    assert os.path.dirname(got) == str(tmp_path)


@pytest.mark.parametrize("writer", ["port", "mal_tpu"])
def test_a_file_written_by_either_package_loads_in_both(tmp_path, writer):
    arrays = _instance_arrays(np.random.RandomState(3))
    path = str(tmp_path / "frame.npz")
    (cache if writer == "port" else jcache).save_frame_instances(path, *arrays)
    ours, theirs = (cache.load_frame_instances(path),
                    jcache.load_frame_instances(path))
    assert set(ours) == set(theirs) == {"seg_masks", "seg_classes",
                                        "seg_scores", "seg_valid"}
    for k, want in zip(("seg_masks", "seg_classes", "seg_scores",
                        "seg_valid"), arrays):
        np.testing.assert_array_equal(ours[k], want, err_msg=k)
        np.testing.assert_array_equal(theirs[k], want, err_msg=k)
        assert ours[k].dtype == theirs[k].dtype, k


# --------------------------------------------------------------------------
# The export, in both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(kitti, tmp_path_factory):
    """Both packages' exports of the fake split with the stand-in at batch
    3 (8 unique frames x 2 orientations: a tail chunk of one, which only
    `mal_tpu` pads), and the counts of a first and a second export."""
    data, lines = kitti

    def export(name, root):
        if name == "port":
            ds = KITTIRAWDataset(data, lines, H, W, FRAMES, is_train=True)
            return cache.export_split_instances(ds, _t_seg, root, 3,
                                                device="cpu", log_every=0)
        ds = JKITTI(data, lines, H, W, FRAMES, is_train=True)
        return jcache.export_split_instances(ds, _j_seg, None, root, 3,
                                             log_every=0)

    out = {}
    for name in ("port", "mal_tpu"):
        root = str(tmp_path_factory.mktemp(f"cache_{name}"))
        out[name] = (root, export(name, root), export(name, root))
    return out


def test_export_writes_every_frame_twice_and_resumes(exported, kitti):
    unique = len(set(kitti[1]))
    for name, (root, first, second) in exported.items():
        assert first == 2 * unique, name
        assert second == 0, name
        files = os.listdir(root)
        assert len(files) == 2 * unique, name
        assert sum(f.endswith("_f.npz") for f in files) == unique, name


def test_exports_of_both_packages_are_equal(exported):
    (ours, *_), (theirs, *_) = exported["port"], exported["mal_tpu"]
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    for name in names:
        _assert_same_files(os.path.join(ours, name),
                           os.path.join(theirs, name))


def test_export_resumes_a_partial_cache(exported, kitti, tmp_path):
    """A cache cut short: only the missing files are written, and they
    equal the full export's."""
    data, lines = kitti
    full = exported["port"][0]
    names = sorted(os.listdir(full))
    for name in names[:5]:
        os.link(os.path.join(full, name), tmp_path / name)
    ds = KITTIRAWDataset(data, lines, H, W, FRAMES, is_train=True)
    assert cache.export_split_instances(ds, _t_seg, str(tmp_path), 4,
                                        device="cpu", log_every=0) \
        == len(names) - 5
    for name in names:
        _assert_same_files(str(tmp_path / name), os.path.join(full, name))


# --------------------------------------------------------------------------
# The loaders
# --------------------------------------------------------------------------

def test_pil_items_carry_the_instances_of_their_orientation(exported, kitti):
    """Each item's `seg_*` is the stand-in's output on the item's own
    current frame (flipped or not), and equals `mal_tpu`'s item."""
    data, lines = kitti
    root = exported["port"][0]
    args = (data, lines, H, W, FRAMES)
    ours = KITTIRAWDataset(*args, is_train=True, seed=3, seg_cache_root=root)
    theirs = JKITTI(*args, is_train=True, seed=3, seg_cache_root=root)
    flips = 0
    for i in range(len(lines)):
        item, want = ours[i], theirs[i]
        inst = _t_seg(torch.from_numpy(item["color"]["0"][None]))
        for k, v in zip(("seg_masks", "seg_classes", "seg_scores",
                         "seg_valid"), inst):
            np.testing.assert_array_equal(item[k], v[0].numpy(), err_msg=k)
            np.testing.assert_array_equal(item[k], want[k], err_msg=k)
        folder, frame, side = ours.index_to_folder_and_frame_idx(i)
        flipped = ours.get_color(folder, frame, side, True).resize(
            (W, H), _ANTIALIAS)
        flips += np.array_equal(item["color"]["0"],
                                np.asarray(flipped, np.float32) / 255.0)
    assert 0 < flips < len(lines)    # both orientations were drawn


def test_native_batches_carry_the_instances_of_their_orientation(
        exported, kitti):
    """The native loader matches each item's file to its flip draw (which
    decode, flipped or not, the batch holds), and its batches equal
    `mal_tpu`'s."""
    assert native.available(), native.build_error()
    data, lines = kitti
    root = exported["port"][0]
    args = (data, lines, H, W, FRAMES)
    ours = NativePrefetchLoader(
        KITTIRAWDataset(*args, is_train=True, seg_cache_root=root), 3,
        seed=2, num_threads=2)
    theirs = JNative(JKITTI(*args, is_train=True, seg_cache_root=root), 3,
                     seed=2, num_threads=2)
    order = np.arange(len(lines))
    np.random.RandomState(2).shuffle(order)
    drawn = set()
    for b, (got, want) in enumerate(zip(ours.epoch(0), theirs.epoch(0))):
        for k in ("seg_masks", "seg_classes", "seg_scores", "seg_valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for j, idx in enumerate(order[3 * b:3 * b + 3]):
            folder, frame, side = ours.ds.index_to_folder_and_frame_idx(idx)
            path = ours.ds.get_image_path(folder, frame, side)
            flip = [f for f in (False, True) if np.array_equal(
                native.load_image(path, W, H, f), got["color"]["0"][j])]
            assert len(flip) == 1
            drawn.add(flip[0])
            want_j = cache.load_frame_instances(
                cache.cache_path(root, folder, frame, side, flip[0]))
            for k, v in want_j.items():
                np.testing.assert_array_equal(got[k][j], v, err_msg=k)
    assert drawn == {False, True}


def test_a_cache_miss_raises(kitti, tmp_path):
    data, lines = kitti
    ds = KITTIRAWDataset(data, lines, H, W, FRAMES, is_train=True,
                         seg_cache_root=str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="mal_tpu_torch.cli export-seg"):
        ds[0]
    with pytest.raises(FileNotFoundError, match="export-seg"):
        next(iter(NativePrefetchLoader(ds, 2, num_threads=1)))


# --------------------------------------------------------------------------
# The cached training step
# --------------------------------------------------------------------------

def test_cached_step_equals_the_online_step():
    """`seg_cache_root` reads the current frame's instances from the batch;
    given the very instances the online segmenter gives, the step is the
    online step: the same loss and gradients from the same state."""
    B, Hs, Ws = CFG.batch_size, CFG.height, CFG.width
    cfg = torch_cfg(CFG).replace(temporal=True, ins_threshold=0.0)
    batch = to_torch(np_batch(CFG, seed=5, batch_size=B))
    g = torch.Generator().manual_seed(6)
    draws = {"matching_aug": torch.tensor([0.9, 0.1]),
             "automask_noise": torch.randn((B, 1, Hs, Ws), generator=g)}
    state0 = create_train_state(cfg, device="cpu")
    inst = _t_seg(batch["color"]["0"])
    cached = dict(batch, seg_masks=inst.masks, seg_classes=inst.classes,
                  seg_scores=inst.scores, seg_valid=inst.valid)
    calls = []

    def counting_seg(images):
        calls.append(images.shape[0])
        return _t_seg(images)

    out = {}
    for name, c, b in (("online", cfg, batch),
                       ("cached", cfg.replace(seg_cache_root="cache"), cached)):
        state = create_train_state(c, device="cpu", init_weights=False)
        state.model.load_state_dict(state0.model.state_dict())
        step = make_train_step(c, device="cpu", seg_fn=counting_seg)
        calls.clear()
        state, m = step(state, b, 0.0, draws=draws)
        out[name] = (m, {n: p.grad.clone()
                         for n, p in state.model.named_parameters()},
                     len(calls))
    (m_on, g_on, n_on), (m_c, g_c, n_c) = out["online"], out["cached"]
    assert (n_on, n_c) == (3, 2)    # the current frame is not segmented
    assert m_on["syn_items"] > 0
    for k in m_on:
        torch.testing.assert_close(m_c[k], m_on[k], rtol=0, atol=0,
                                   msg=k)
    for n in g_on:
        torch.testing.assert_close(g_c[n], g_on[n], rtol=0, atol=1e-6,
                                   msg=n)


# --------------------------------------------------------------------------
# The command
# --------------------------------------------------------------------------

def test_cli_export_seg_end_to_end(kitti, tmp_path, monkeypatch):
    """`export-seg` from a detectron2 `.pkl` of a Swin-T Mask2Former on
    the CPU: every unique frame in both orientations, nothing on a rerun,
    and the cached masks equal the segmenter's on the training item."""
    from mal_tpu_torch.cli import main
    from mal_tpu_torch.convert.mask2former import export_mask2former_pkl
    from mal_tpu_torch.segment.mask2former import Mask2Former, make_seg_fn

    data, lines = kitti
    seg = Mask2Former(swin_size="tiny", device="cpu",
                      generator=torch.Generator().manual_seed(1))
    pkl = str(tmp_path / "seg.pkl")
    export_mask2former_pkl(seg, pkl)
    split = tmp_path / "splits" / "smoke"
    split.mkdir(parents=True)
    (split / "train_files.txt").write_text("\n".join(lines[:3]) + "\n")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "segcache")
    argv = ["export-seg", "--data_path", data, "--seg_pkl", pkl, "--out", out,
            "--size", "tiny", "--device", "cpu", "--set", "split='smoke'",
            "height=64", "width=96", "batch_size=4", "max_instances=4"]
    assert main(argv) == 6
    assert len(os.listdir(out)) == 6
    assert main(argv) == 0

    ds = KITTIRAWDataset(data, lines[:3], 64, 96, FRAMES, is_train=True,
                         seg_cache_root=out)
    item = ds[0]
    inst = make_seg_fn(seg, 4)(torch.from_numpy(item["color"]["0"][None]))
    assert item["seg_masks"].shape == (4, 64, 96)
    np.testing.assert_array_equal(item["seg_masks"], inst.masks[0].numpy())
    np.testing.assert_array_equal(item["seg_classes"],
                                  inst.classes[0].numpy())
    np.testing.assert_allclose(item["seg_scores"], inst.scores[0].numpy(),
                               rtol=1e-5)
    assert item["seg_valid"].dtype == bool
