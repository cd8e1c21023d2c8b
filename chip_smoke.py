#!/usr/bin/env python3
"""Drive the PyTorch port (`mal_tpu_torch`) on one CUDA GPU and check it.

    python3 chip_smoke.py [--steps N] [--profile]

Phases, each of which must pass or the script exits non-zero:
1. the card (name and power limit from nvidia-smi) and the fp32 settings;
2. build every CUDA kernel of the port from `mal_tpu_torch/csrc`, one
   `nvcc` per source, all at once;
3. each kernel against its plain PyTorch version at the shape the main path
   gives it, with both times, its bound and, where one PyTorch call computes
   the same function, that call's time: K1 (`plane_sweep_diffs`, BF=12,
   D=96, 48x160x64; max abs error and flipped border decisions), K4
   (`window_attention`, Swin-L stage 0 at 192x640, batch 12: 672 windows,
   6 heads, 144 tokens, shift mask of 56 windows) and K5
   (`ms_deform_attn_core`, batch 12, 2520 queries, 8 heads of 32, levels
   6x20 / 12x40 / 24x80, 4 points);
4. small-input references: one training step and one `eval_forward` at
   64x96 on the GPU against the same on the CPU (the plain PyTorch path),
   and one temporal step at 64x96 with a Swin-T Mask2Former, GPU against
   CPU (segmenter mask bits and loss);
5. the path without the temporal hint: `create_train_state`, N training
   steps at `Config()` (192x640, batch 12, 96 depth bins, ResNet-18, fp32)
   on a seeded synthetic batch and one `eval_forward`;
6. the main path of this slice, the temporal hint: `Config(temporal=True,
   ins_threshold=0.0)` with the full-width Swin-L Mask2Former (seeded
   random weights; the lowered threshold makes matching and synthesis work
   on every item), N steps and one `eval_forward`, then one timed segmenter
   forward.
Phases 5 and 6 each set every kernel's launch count to 0 just before they
run and read the counts just after; each kernel must have launched exactly
as often as its path calls it. The script then prints the `kernels` JSON
line (launches from phase 6), the card's line, and as the last line
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
`mal_tpu_torch` package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

K1_ATOL = 3e-5          # as tests/test_pallas_cv.py holds K1 on the TPU side
K1_MAX_FLIPS = 0        # kernel and plain version share x, y to the bit
# K4: outputs of O(1); the kernel's online softmax and 32-wide dot products
# round in another order than the plain version's matmuls
K4_ATOL = 2e-5
# K5: the kernel computes a sample's coordinate as x * w - 0.5, the plain
# version as grid_sample's ((2x - 1 + 1) * w - 1) / 2; the ~1e-7 relative
# difference moves bilinear weights on values of O(1), summed over 12 samples
K5_ATOL = 1e-4
# the small temporal reference: GPU against CPU
SEG_MAX_BIT_FLIPS = 1e-3   # share of segmenter mask bits that may differ
TEMPORAL_LOSS_RTOL = 1e-3
SOURCES = ["plane_sweep", "window_attention", "deform_sample"]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_inputs(device="cuda", BF=12, h=48, w=160, C=64, D=96, seed=0):
    """Main-path shaped K1 inputs (cur, lookup, M, t, bins): poses as
    tests/test_pallas_cv.py draws them, with a small rotation, and one
    all-zero (missing) pose."""
    import numpy as np
    import torch

    from mal_tpu_torch.ops.cost_volume import (compute_depth_bins,
                                               plane_sweep_terms)

    rng = np.random.RandomState(seed)
    cur = rng.uniform(0, 1, (BF, h, w, C)).astype(np.float32)
    lookup = rng.uniform(0, 1, (BF, h, w, C)).astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.58 * w, 1.92 * h
    K[0, 2], K[1, 2] = 0.5 * w, 0.5 * h
    K = np.broadcast_to(K, (BF, 4, 4)).copy()
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (BF, 1, 4, 4)).copy()
    poses[:, 0, 0, 3] = rng.uniform(-0.3, 0.3, BF)
    poses[:, 0, 1, 3] = rng.uniform(-0.05, 0.05, BF)
    poses[:, 0, 2, 3] = rng.uniform(-0.2, 0.2, BF)
    c, s = np.cos(0.05), np.sin(0.05)
    poses[:, 0, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    poses[-1] = 0.0
    M, t = plane_sweep_terms(torch.from_numpy(poses), torch.from_numpy(K),
                             torch.from_numpy(np.linalg.inv(K)))
    bins = compute_depth_bins(0.1, 10.0, D)
    return [x.contiguous().to(device) for x in (
        torch.from_numpy(cur), torch.from_numpy(lookup), M.reshape(BF, 3, 3),
        t.reshape(BF, 3), bins)]


def k1_phase() -> dict:
    import torch

    from mal_tpu_torch.ops.cuda.cost_volume_kernel import (
        plane_sweep_diffs, plane_sweep_diffs_reference)

    cur, lookup, M, t, bins = k1_inputs()
    BF, h, w, C = cur.shape
    D = bins.shape[0]
    out = plane_sweep_diffs(cur, lookup, M, t, bins)
    torch.cuda.synchronize()
    plain = plane_sweep_diffs_reference(cur, lookup, M, t, bins)
    err = (out - plain).abs().max().item()
    flips = ((out == 0) != (plain == 0)).sum().item()
    active = (plain != 0).sum().item()
    print(f"K1 plane_sweep_diffs at BF={BF} D={D} h={h} w={w} C={C}: "
          f"max_abs_err={err:.3e} (atol {K1_ATOL}) flips={flips} "
          f"(max {K1_MAX_FLIPS}) active samples={active} of {out.numel()}")
    check(torch.isfinite(out).all().item(), "K1 output not finite")
    check(err <= K1_ATOL, f"K1 disagrees with its plain version: {err}")
    check(flips <= K1_MAX_FLIPS, f"K1 flipped {flips} border decisions")
    check(active > 0, "K1 check sampled nothing")

    ms = cuda_time_ms(lambda: plane_sweep_diffs(cur, lookup, M, t, bins), 50)
    plain_ms = cuda_time_ms(
        lambda: plane_sweep_diffs_reference(cur, lookup, M, t, bins), 10)
    # least bytes: each input read once, the output written once
    n_bytes = 4 * (2 * cur.numel() + M.numel() + t.numel() + D + out.numel())
    # operations this data needs: ~10 per sample for the projection and the
    # masks, and for each sample inside the masks ~15 for the bilinear
    # weights plus 9 per channel (4 mul + 3 add for the corners, the
    # difference and the accumulation)
    n_ops = 10 * out.numel() + active * (15 + 9 * C)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FP32_FLOPS * 1e3
    print(f"K1 time {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes / 1e6:.1f} MB -> "
          f"{bytes_ms:.4f} ms, {n_ops / 1e9:.2f} GFLOP -> {ops_ms:.4f} ms)")
    return {"name": "plane_sweep_diffs", "route": "cuda",
            "source": "mal_tpu_torch/csrc/plane_sweep.cu",
            "replaces": "mal_tpu/ops/pallas/cost_volume_kernel.py:123",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def _to(batch: dict, dev: str) -> dict:
    return {k: ({f: v.to(dev) for f, v in x.items()} if isinstance(x, dict)
                else x.to(dev)) for k, x in batch.items()}


def small_reference_phase() -> None:
    """One step and one eval at a small size: GPU path vs CPU plain path."""
    import torch

    from mal_tpu_torch.config import Config
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    cfg = Config(height=64, width=96, num_depth_bins=16, batch_size=2)
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(3), "cpu")
    B, H, W = 2, cfg.height, cfg.width
    g = torch.Generator().manual_seed(4)
    draws = {"matching_aug": torch.tensor([0.9, 0.1]),
             "automask_noise": torch.randn((B, 1, H, W), generator=g)}
    res = {}
    for dev in ("cpu", "cuda"):
        b = _to(batch, dev)
        state = create_train_state(cfg, device=dev)
        step = make_train_step(cfg, device=dev)
        state, m = step(state, b, 0.0,
                        draws={k: v.to(dev) for k, v in draws.items()})
        ev = state.model.eval_forward(b, state.bins.min_depth,
                                      state.bins.max_depth)
        res[dev] = (m["loss"].item(), ev["disp"].cpu(), ev["mono_disp"].cpu())
    (l_cpu, d_cpu, md_cpu), (l_gpu, d_gpu, md_gpu) = res["cpu"], res["cuda"]
    d_err = max((d_cpu - d_gpu).abs().max().item(),
                (md_cpu - md_gpu).abs().max().item())
    print(f"small reference (64x96, B=2, D=16): loss cpu {l_cpu:.6f} gpu "
          f"{l_gpu:.6f}; eval disparity max abs diff {d_err:.3e}")
    # a per-pixel selection may flip between the two at a near-tie; that
    # moves the loss by far less than 1e-4 of it
    check(abs(l_cpu - l_gpu) <= 1e-4 * abs(l_cpu), "GPU loss != CPU loss")
    check(d_err <= 1e-4, "GPU eval disparity != CPU eval disparity")


def k4_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from mal_tpu_torch.ops.cuda.window_attention import (
        relative_position_index, window_attention, window_attention_reference)
    from mal_tpu_torch.segment.swin import shift_mask

    # Swin-L stage 0 at 192x640, batch 12: the 48x160 map pads to 48x168,
    # 4 x 14 = 56 windows of 12x12 per image, 6 heads of 32
    images, heads, ws, Hp, Wp = 12, 6, 12, 48, 168
    N, C = ws * ws, heads * 32
    g = torch.Generator(device="cuda").manual_seed(4)
    mask = shift_mask(Hp, Wp, ws, ws // 2, "cuda")
    nm = mask.shape[0]
    nW = images * nm
    qkv = torch.randn((nW, N, 3 * C), generator=g, device="cuda")
    table = 0.02 * torch.randn(((2 * ws - 1) ** 2, heads), generator=g,
                               device="cuda")
    out = window_attention(qkv, table, mask, heads)
    torch.cuda.synchronize()
    plain = window_attention_reference(qkv, table, mask, heads)
    err = (out - plain).abs().max().item()
    print(f"K4 window_attention at nW={nW} heads={heads} N={N} d=32 "
          f"nm={nm}: max_abs_err={err:.3e} (atol {K4_ATOL})")
    check(torch.isfinite(out).all().item(), "K4 output not finite")
    check(err <= K4_ATOL, f"K4 disagrees with its plain version: {err}")

    ms = cuda_time_ms(lambda: window_attention(qkv, table, mask, heads), 20)
    plain_ms = cuda_time_ms(
        lambda: window_attention_reference(qkv, table, mask, heads), 5)
    # the library yardstick: one SDPA call on (nW, heads, N, d) q, k, v
    # with the bias and mask added into one (nW, heads, N, N) mask
    q, k, v = (t.reshape(nW, N, heads, 32).transpose(1, 2).contiguous()
               for t in qkv.reshape(nW, N, 3, C).unbind(2))
    idx = torch.from_numpy(relative_position_index(ws)).cuda()
    bias = table[idx.reshape(-1)].reshape(N, N, heads).permute(2, 0, 1)
    attn_mask = (bias[None] + mask[:, None]).repeat(images, 1, 1, 1)
    lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
    lib_err = (lib_out.transpose(1, 2).reshape(nW, N, C) - plain).abs().max()
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask), 20)
    # least bytes: qkv, table and mask read once, out written once
    n_bytes = 4 * (qkv.numel() + table.numel() + mask.numel() + out.numel())
    # operations: q k^T and p v (2 N^2 d multiply-adds each), and ~5 per
    # score for bias, mask, max, exp, sum and the division
    n_ops = nW * heads * (4 * N * N * 32 + 5 * N * N)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FP32_FLOPS * 1e3
    print(f"K4 time {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f}"
          f" ms (max diff to plain {lib_err.item():.2e}); bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes / 1e6:.1f} MB -> "
          f"{bytes_ms:.4f} ms, {n_ops / 1e9:.2f} GFLOP -> {ops_ms:.4f} ms)")
    return {"name": "window_attention", "route": "cuda",
            "source": "mal_tpu_torch/csrc/window_attention.cu",
            "replaces": "mal_tpu/ops/pallas/window_attention.py:64",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def k5_phase() -> dict:
    import torch

    from mal_tpu_torch.ops.cuda.deform_sample import (
        ms_deform_attn_core, ms_deform_attn_core_per_level)

    # the pixel decoder at 192x640, batch 12: res5 / res4 / res3 levels
    B, heads, ch, P = 12, 8, 32, 4
    shapes = [(6, 20), (12, 40), (24, 80)]
    L, S = len(shapes), sum(h * w for h, w in shapes)
    Lq = S
    g = torch.Generator(device="cuda").manual_seed(5)
    value = torch.randn((B, S, heads, ch), generator=g, device="cuda")
    # around the unit square, some samples outside (zeros padding)
    locs = -0.1 + 1.2 * torch.rand((B, Lq, heads, L, P, 2), generator=g,
                                   device="cuda")
    aw = torch.rand((B, Lq, heads, L * P), generator=g, device="cuda")
    aw = aw.softmax(-1).reshape(B, Lq, heads, L, P).contiguous()
    args = (value, shapes, locs, aw)
    out = ms_deform_attn_core(*args)
    torch.cuda.synchronize()
    plain = ms_deform_attn_core_per_level(*args)
    err = (out - plain).abs().max().item()
    print(f"K5 ms_deform_attn_core at B={B} Lq={Lq} heads={heads} ch={ch} "
          f"levels={shapes} points={P}: max_abs_err={err:.3e} "
          f"(atol {K5_ATOL})")
    check(torch.isfinite(out).all().item(), "K5 output not finite")
    check(err <= K5_ATOL, f"K5 disagrees with its plain version: {err}")

    ms = cuda_time_ms(lambda: ms_deform_attn_core(*args), 20)
    plain_ms = cuda_time_ms(lambda: ms_deform_attn_core_per_level(*args), 5)
    # corners inside their level map: what this data makes the kernel read
    sizes = torch.tensor([[w, h] for h, w in shapes], device="cuda")
    xy0 = torch.floor(locs * sizes[:, None] - 0.5)
    inside = [((xy0[..., i:i + 1] + d >= 0)
               & (xy0[..., i:i + 1] + d <= sizes[:, None, i:i + 1] - 1))
              for i in range(2) for d in (0, 1)]
    corners = sum(((inside[a] & inside[2 + b]).sum().item()
                   for a in (0, 1) for b in (0, 1)))
    n_samples = aw.numel()
    # least bytes: value, locations and weights read once, out written once
    n_bytes = 4 * (value.numel() + locs.numel() + aw.numel() + out.numel())
    # operations: ~18 per sample for its coordinates and corner weights,
    # a multiply-add per channel for each corner inside the map, and the
    # attention weight's multiply-add per channel
    n_ops = n_samples * (18 + 2 * ch) + corners * 2 * ch
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FP32_FLOPS * 1e3
    print(f"K5 time {ms:.4f} ms, plain {plain_ms:.4f} ms; {corners} of "
          f"{4 * n_samples} corners inside; bound {max(bytes_ms, ops_ms):.4f}"
          f" ms ({n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms, "
          f"{n_ops / 1e9:.3f} GFLOP -> {ops_ms:.4f} ms)")
    return {"name": "ms_deform_attn_core", "route": "cuda",
            "source": "mal_tpu_torch/csrc/deform_sample.cu",
            "replaces": "mal_tpu/ops/pallas/deform_sample.py:174",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def small_temporal_reference_phase() -> None:
    """One temporal step at 64x96 with a Swin-T Mask2Former: GPU against
    CPU, from the same weights, batch and draws."""
    import torch

    from mal_tpu_torch.config import Config
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.segment.mask2former import Mask2Former, make_seg_fn
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    cfg = Config(height=64, width=96, num_depth_bins=16, batch_size=2,
                 temporal=True, ins_threshold=0.0)
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(3), "cpu")
    B, H, W = 2, cfg.height, cfg.width
    g = torch.Generator().manual_seed(4)
    draws = {"matching_aug": torch.tensor([0.9, 0.1]),
             "automask_noise": torch.randn((B, 1, H, W), generator=g)}
    res = {}
    for dev in ("cpu", "cuda"):
        seg = Mask2Former(swin_size="tiny", num_queries=20, device=dev,
                          generator=torch.Generator().manual_seed(1))
        seg_fn = make_seg_fn(seg, cfg.max_instances)
        b = _to(batch, dev)
        bits = seg_fn(b["color"]["0"]).masks.cpu()
        state = create_train_state(cfg, device=dev)
        step = make_train_step(cfg, device=dev, seg_fn=seg_fn)
        state, m = step(state, b, 0.0,
                        draws={k: v.to(dev) for k, v in draws.items()})
        res[dev] = (m["loss"].item(), m["syn_items"].item(), bits)
    (l_cpu, n_cpu, b_cpu), (l_gpu, n_gpu, b_gpu) = res["cpu"], res["cuda"]
    flips = (b_cpu != b_gpu).float().mean().item()
    print(f"small temporal reference (64x96, B=2, Swin-T, 20 queries): loss "
          f"cpu {l_cpu:.6f} gpu {l_gpu:.6f}; matched items cpu {n_cpu:.0f} "
          f"gpu {n_gpu:.0f}; segmenter mask bits differing {flips:.2e} "
          f"(max {SEG_MAX_BIT_FLIPS})")
    check(flips <= SEG_MAX_BIT_FLIPS, "GPU segmenter masks != CPU masks")
    check(n_gpu > 0 and n_gpu == n_cpu, "matching differs or found nothing")
    check(abs(l_cpu - l_gpu) <= TEMPORAL_LOSS_RTOL * abs(l_cpu),
          "GPU temporal loss != CPU temporal loss")


def run_path(cfg, steps: int, seg_fn, counters, profile: str | None):
    """`create_train_state`, `steps` training steps and one `eval_forward`
    at `cfg` on a seeded synthetic batch, with every kernel's launch count
    set to 0 just before and read just after. Returns (launches by kernel
    name, the state, the batch)."""
    import torch

    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    state = create_train_state(cfg)
    step = make_train_step(cfg, seg_fn=seg_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = synthetic_batch(cfg, gen, "cuda")
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.2f} s; tf32 cudnn="
          f"{torch.backends.cudnn.allow_tf32} matmul="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 left on")

    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, 0.0, gen)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        print(f"step {i}: loss {loss:.6f}, items with a matched pair "
              f"{metrics['syn_items'].item():.0f} ({times[-1]:.2f} ms)")
        check(all(torch.isfinite(v).all().item() for v in metrics.values()),
              f"non-finite metrics at step {i}")
        if cfg.temporal:
            check(metrics["syn_items"].item() > 0,
                  f"no item had a matched pair at step {i}")
    t0 = time.perf_counter()
    out = state.model.eval_forward(batch, state.bins.min_depth,
                                   state.bins.max_depth)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    B, H, W = cfg.batch_size, cfg.height, cfg.width
    h, w = H // 4, W // 4
    want = {"disp": (B, H, W, 1), "mono_disp": (B, H, W, 1),
            "lowest_cost": (B, h, w), "consistency_mask": (B, h, w)}
    for k, shape in want.items():
        check(tuple(out[k].shape) == shape, f"eval {k} shape {out[k].shape}")
        check(torch.isfinite(out[k]).all().item(), f"eval {k} not finite")
    steady = statistics.median(times[1:]) if steps > 1 else times[0]
    print(f"eval_forward {eval_ms:.2f} ms; step ms (first {times[0]:.2f}, "
          f"median of the rest {steady:.2f}); peak memory {peak:.2f} GiB; "
          f"launches {launches}")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, batch, 0.0, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device busy time: the union of the device events' intervals
        # (cuDNN may overlap kernels on its own streams); the profiler's
        # buffer flushes are not work of the step
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.name != "Buffer Flush")
        busy_us, reach = 0.0, float("-inf")
        for a, b in spans:
            busy_us += max(0.0, b - max(a, reach))
            reach = max(reach, b)
        busy_ms = busy_us / 1e3
        print(f"profiled step {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms: "
              f"device idle share {1 - busy_ms / wall_ms:.3f}")
        os.makedirs("chiprun_out", exist_ok=True)
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        with open(f"chiprun_out/{profile}.txt", "w") as f:
            f.write(table)
        print(table[:6000])
    return launches, state, batch


def main_path_phase(steps: int, profile: bool) -> None:
    """The path without the temporal hint at `Config()`."""
    from mal_tpu_torch.config import Config
    from mal_tpu_torch.ops.cuda.cost_volume_kernel import plane_sweep_diffs

    cfg = Config()
    print(f"path without the temporal hint: Config() {cfg.height}x"
          f"{cfg.width} batch {cfg.batch_size}, {cfg.num_depth_bins} bins, "
          f"ResNet-{cfg.num_layers}, {cfg.compute_dtype}; {steps} steps + "
          f"1 eval")
    launches, _, _ = run_path(cfg, steps, None, [plane_sweep_diffs],
                              "profile_step" if profile else None)
    check(launches["plane_sweep_diffs"] == steps + 1,
          "K1 launch count != steps + evals")


def temporal_path_phase(steps: int, profile: bool) -> dict[str, int]:
    """This slice's main path: the temporal hint with the full-width
    Swin-L Mask2Former."""
    import torch

    from mal_tpu_torch.config import Config
    from mal_tpu_torch.ops.cuda.cost_volume_kernel import plane_sweep_diffs
    from mal_tpu_torch.ops.cuda.deform_sample import ms_deform_attn_core
    from mal_tpu_torch.ops.cuda.window_attention import window_attention
    from mal_tpu_torch.segment.mask2former import Mask2Former, make_seg_fn
    from mal_tpu_torch.segment.matcher import match_instances
    from mal_tpu_torch.temporal import image_synthesis

    cfg = Config(temporal=True, ins_threshold=0.0)
    t0 = time.perf_counter()
    seg = Mask2Former(generator=torch.Generator().manual_seed(1))
    seg_fn = make_seg_fn(seg, cfg.max_instances)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in seg.parameters())
    print(f"main path: Config(temporal=True, ins_threshold=0.0) "
          f"{cfg.height}x{cfg.width} batch {cfg.batch_size}; Mask2Former "
          f"Swin-L, {n_params / 1e6:.1f} M parameters, built in "
          f"{time.perf_counter() - t0:.2f} s; {steps} steps + 1 eval")
    counters = [plane_sweep_diffs, window_attention, ms_deform_attn_core]
    launches, _, batch = run_path(cfg, steps, seg_fn, counters,
                                  "profile_temporal_step" if profile else None)
    # per step: 3 segmenter forwards (the current frame, two warped
    # frames) of 24 Swin blocks and 6 deformable encoder layers
    want = {"plane_sweep_diffs": steps + 1, "window_attention": 72 * steps,
            "ms_deform_attn_core": 18 * steps}
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times "
              f"on the main path, not {n}")

    seg_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inst = seg_fn(batch["color"]["0"])
        torch.cuda.synchronize()
        seg_ms.append((time.perf_counter() - t0) * 1e3)
    check(tuple(inst.masks.shape) == (cfg.batch_size, cfg.max_instances,
                                      cfg.height, cfg.width),
          f"segmenter masks {tuple(inst.masks.shape)}")
    check(torch.isfinite(inst.scores).all().item(), "segmenter scores")
    print(f"segmenter forward at batch {cfg.batch_size}: "
          f"{', '.join(f'{t:.2f}' for t in seg_ms)} ms")

    # the synthesis on the adjacent frames, and its host-side matching
    frames = [batch["color"][f].permute(0, 3, 1, 2) for f in ("-1", "1")]
    others = [seg_fn(batch["color"][f]) for f in ("-1", "1")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    match_instances(*others, inst.threshold(cfg.ins_threshold))
    match_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, _, has = image_synthesis(*frames, inst, *others, cfg.ins_threshold)
    torch.cuda.synchronize()
    syn_ms = (time.perf_counter() - t0) * 1e3
    print(f"image_synthesis {syn_ms:.2f} ms ({has.sum().item()} items with a "
          f"matched pair), of which matching {match_ms:.2f} ms (the costs "
          f"copied to the host once, {cfg.batch_size * 2} assignments "
          f"solved there)")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3,
                        help="training steps of each path")
    parser.add_argument("--profile", action="store_true",
                        help="profile one extra step after each path")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mal_tpu_torch  # noqa: F401
        from mal_tpu_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: the mal_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 1

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build_libraries(SOURCES)
    print(f"kernel build {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = [k1_phase(), k4_phase(), k5_phase()]
    small_reference_phase()
    small_temporal_reference_phase()
    main_path_phase(args.steps, args.profile)
    launches = temporal_path_phase(args.steps, args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
