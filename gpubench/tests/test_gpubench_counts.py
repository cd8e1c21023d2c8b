"""The frozen operation and byte counts, worked by hand at small shapes,
and the FLOP counter the configurations' model FLOPs come from; the launch
inputs the kernel files keep."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from gpubench import peaks
from gpubench.kernels import plane_sweep, plane_sweep_occ, swin_block


def test_plane_sweep_counts_by_hand():
    # 2 frames of 4x8 features of 8 channels, 3 planes, 10 active samples:
    # bytes 4 (2 x 2x4x8x8 + 2x9 + 2x3 + 3 + 2x3x4x8) = 4 x 1243
    n_bytes, n_ops = plane_sweep.counts(2, 4, 8, 3, 10, channels=8)
    assert n_bytes == 4 * (2 * 512 + 18 + 6 + 3 + 192)
    # 10 a sample of the 192, and 15 + 9 x 8 = 87 for each active one
    assert n_ops == 10 * 192 + 10 * 87


def test_plane_sweep_active_samples_identity_pose():
    # an identity pose maps every pixel onto itself at every plane: the
    # active samples are the pixels inside both border masks (u, v in
    # 2..w-3 / 2..h-3), times the planes; at depths of 2 and more the
    # projection's 1e-7 guard vanishes in fp32, so x = u exactly
    h, w = 8, 12
    K = torch.tensor([[10.0, 0, 6, 0], [0, 10.0, 4, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]])[None]
    poses = torch.eye(4)[None, None]
    bins = plane_sweep.depth_bins(torch.tensor(2.0), torch.tensor(5.0), 4)
    got = plane_sweep.active_samples(poses, K, torch.linalg.inv(K), bins, h, w)
    assert got == 4 * (h - 4) * (w - 4)


def test_plane_sweep_active_samples_zero_pose():
    # the zero-cost-volume augmentation's all-zero pose projects nothing
    K = torch.eye(4)[None] * 10
    got = plane_sweep.active_samples(torch.zeros(1, 1, 4, 4), K,
                                     torch.linalg.inv(K),
                                     torch.linspace(1, 5, 4), 8, 12)
    assert got == 0


def test_swin_counts_by_hand():
    # K2 on one 2x2 window of 64 channels, 2 heads, unshifted, fp32 stream:
    # M = 4 tokens; qkv + proj 2 x 4 x 64 x 256; per head q k^T and p v
    # 4 x 16 x 32 plus 5 x 16 for the softmax
    n_bytes, n_ops = swin_block.attn_counts(1, 2, 2, 64, 2, 2, False, 4)
    assert n_ops == 2 * 4 * 64 * 256 + 1 * 2 * (4 * 16 * 32 + 5 * 16)
    params = 2 * 64 + 3 * 64 * 64 + 3 * 64 + 9 * 2 + 64 * 64 + 64 + 4
    assert n_bytes == 2 * 4 * 64 * 4 + 4 * params
    n_bytes, n_ops = swin_block.mlp_counts(10, 16, 2)
    assert n_ops == 2 * 10 * 16 * 64 * 2 + 10 * 10 * 64
    assert n_bytes == 2 * 10 * 16 * 2 + 4 * (2 * 16 + 8 * 256 + 5 * 16)


def test_swin_large_forward_matches_the_kernel_table():
    # Swin-L at 192x640, batch 12, bf16: 24 blocks, 48 launches, and the
    # bound the port's kernel table gives a fast step's three forwards
    # (K2 2.82 ms + K3 3.97 ms, PERF.md)
    total, launches = swin_block.forward_bound_s(
        12, 192, 640, peaks.PEAK_FLOPS["bfloat16"])
    assert launches == 48
    assert abs(3 * total * 1e3 - 6.79) < 0.01


def test_flop_counter_by_hand():
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3)
    a, b = torch.randn(5, 7), torch.randn(7, 6)
    with FlopCounterMode(display=False) as mode:
        F.conv2d(x, w, padding=1)
        a @ b
    # conv: 2 x (N Hout Wout) x Cout x (Cin k k); matmul: 2 m k n
    assert mode.get_total_flops() == 2 * (2 * 8 * 8) * 4 * 27 + 2 * 5 * 7 * 6


def test_plane_sweep_occ_samples_match_the_twin(monkeypatch):
    """K6's counts at the tiny size on the CPU: the geometry that
    `plane_sweep_occ` works out again from a captured forward is the one
    the port's cost volume was given, and its samples inside the masks,
    tested and occluded equal those of the plain twin's own projection,
    border masks and occlusion test, for a batch with a static-camera, a
    zeroed and a plain item (draws 0.1, 0.4, 0.9)."""
    from gpubench import traffic, train_cell
    from gpubench.kernels import plane_sweep_occ
    from gpubench.reference.dynamicdepth.cost_volume import (
        occlusion_aware_cost_volume)
    from gpubench.tests.tiny import tiny_cell
    from mal_tpu_torch.dynamic import model as dynamic_model

    cpu = torch.device("cpu")
    cell = tiny_cell("dynamicdepth_fp32.precomputed_doj")
    config = dict(cell.config)
    config["port_config"] = dict(config["port_config"], batch_size=3)
    state, step, _, _ = train_cell.build_system(config, 5, cpu)
    batch, draws = traffic.shard_inputs(cell.traffic, config["port_config"],
                                        5, 0, 0, cpu)
    draws["matching_aug"] = torch.tensor([0.1, 0.4, 0.9])
    given = []
    volume = dynamic_model.occlusion_aware_cost_volume_kernel

    def record(*args, **kwargs):
        given.append((args, kwargs))
        return volume(*args, **kwargs)

    monkeypatch.setattr(dynamic_model, "occlusion_aware_cost_volume_kernel",
                        record)
    kept = []
    hook = plane_sweep_occ.capture(state.model, kept)
    step(state, batch, 0.0, draws=draws)
    hook.remove()
    assert len(kept) == len(given) == 1
    g = plane_sweep_occ.launch_inputs(kept[0])
    (cur, lookup, poses, K, inv_K, bins, images, aug_mask), kw = given[0]
    assert torch.equal(g["poses"], poses) and torch.equal(g["K"], K)
    assert torch.equal(g["inv_K"], inv_K) and torch.equal(g["bins"], bins)
    assert torch.equal(g["apply"], aug_mask == 0)
    assert g["apply"].tolist() == [False, False, True]
    assert g["pool_th"] == kw["pool_th"]
    found = plane_sweep_occ.samples(g["poses"], g["K"], g["inv_K"], g["bins"],
                                    g["occ"], g["apply"], g["pool_th"],
                                    g["h"], g["w"])
    # the twin on the launch's own geometry, current features 0 and lookup
    # features 2: a sample inside the masks reads 2, or 1 where occluded,
    # and one outside them is missing
    with torch.no_grad():
        cost, missing = occlusion_aware_cost_volume(
            torch.zeros_like(cur), torch.full_like(lookup, 2.0), poses, K,
            inv_K, bins, images, aug_mask, set_1=True,
            pool_th=kw["pool_th"])
    inside = missing == 0
    applied = g["apply"][:, None, None, None]
    assert found["inside"] == int(inside.sum()) > 0
    assert found["tested"] == int((inside & applied).sum())
    assert found["occluded"] == int((inside & (cost < 1.5)).sum())
    assert 0 < found["occluded"] < found["tested"]


def test_plane_sweep_occ_counts_by_hand():
    # 2 frames of 4x8 features of 8 channels, 3 planes; 10 samples inside
    # the masks, 6 of them tested, 2 occluded; 1 frame applies the test
    found = {"inside": 10, "tested": 6, "occluded": 2}
    n_bytes, n_ops = plane_sweep_occ.counts(2, 4, 8, 3, found, 1, channels=8)
    assert n_bytes == 4 * (2 * 512 + 64 + 2 + 18 + 6 + 3 + 192)
    assert n_ops == 10 * 192 + 15 * 10 + 8 * 6 + 72 * 8 + 2 * 8 * 32


@pytest.mark.parametrize("name, kept", [
    ("mal_swinl_bf16.temporal_hint", "plane_sweep"),
    ("dynamicdepth_fp32.precomputed_doj", "plane_sweep_occ")])
def test_capture_keeps_the_launches_of_the_models_kernel(name, kept):
    """`kernels.capture` hooks every kernel file's `capture` on the model:
    one step of each model keeps the inputs of its one cost-volume launch,
    and nothing for the other kernel."""
    from gpubench import kernels, traffic, train_cell
    from gpubench.tests.tiny import tiny_cell

    cpu = torch.device("cpu")
    cell = tiny_cell(name)
    state, step, _, _ = train_cell.build_system(cell.config, 3, cpu)
    batch, draws = traffic.shard_inputs(cell.traffic,
                                        cell.config["port_config"], 3, 0, 0,
                                        cpu)
    captured = {}
    hooks = kernels.capture(state.model, captured)
    step(state, batch, 0.0, draws=draws)
    for hook in hooks:
        hook.remove()
    assert set(captured) == {"plane_sweep", "plane_sweep_occ"}
    assert len(captured[kept]) == 1
    assert [k for k, v in captured.items() if v] == [kept]
