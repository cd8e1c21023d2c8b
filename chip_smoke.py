#!/usr/bin/env python3
"""Drive the PyTorch port (`mal_tpu_torch`) on one CUDA GPU and check it.

    python3 chip_smoke.py [--steps N] [--profile] [--kernels-only]

Phases, each of which must pass or the script exits non-zero:
1. the card (name and power limit from nvidia-smi);
2. build every CUDA kernel of the port from `mal_tpu_torch/csrc`, one
   `nvcc` per source, all at once;
3. each kernel against its plain PyTorch version at shapes of the main
   paths, with both times, its bound and, where one PyTorch call computes
   the same function, that call's time: K1 (`plane_sweep_diffs`, BF=12,
   D=96, 48x160x64), K6 (`plane_sweep_diffs_occ`, DynamicDepth's
   occlusion-aware volume, BF=14, D=96, 48x128x64, with black patches in
   the occlusion masks and the substitution on for some frames: also 0
   flipped occlusion decisions; K1 and K6 also print the share of their
   tiles on each route, as the kernel counts them, which must equal
   `plane_sweep_routes`' mirror, and their registers and spills), K2
   (`swin_attn_fused`) and K3 (`swin_mlp_fused`) at the four stages of
   Swin-L (C = 192 / 384 / 768 / 1536; stages 0 and 1 shifted with their
   masks) in bf16 and fp32, beside
   the port's unfused bf16 block, with the bf16 time of one fast step's 72
   launches of each (with `--profile` also every bf16 call's kernels), K4
   (`window_attention`) in fp32 at the same four stages (the tiled route)
   and at Swin-T's four (MaskFormer v1, batch 2 at 256x448: the w7 route),
   each also on the loop route and beside fp32 SDPA, the shifted stages
   also without their masks: the device time of each call (torch.profiler)
   and the caller's time (median and min-max of 7 rounds of 50 calls),
   with the sums over one fp32 hint step's 72 launches and one v1
   forward's 12, K5 (`ms_deform_attn_core`, batch 12, 2520 queries, 8
   heads of 32, levels 6x20 / 12x40 / 24x80, 4 points; also x 18 launches
   a step) and K5b (`deform_sample_fused`, the same work sample-major, on
   its staged and its gather route); the registers and spills of K4's and
   K5b's kernels; DualRefine's Gauss-Newton reduction (`normal_equations`,
   batch 12, 64 channels, 48x160): H, b and the four inputs' gradients
   against float64, two launches to the bit, H and b to the plain
   version's float32 bits, forward and backward times
   beside the plain version's;
4. small-input references, GPU against CPU (the plain PyTorch path): one
   training step and one `eval_forward` at 64x96; one temporal step at
   64x96 with a Swin-T Mask2Former; the same temporal step in fast mode;
   one DynamicDepth step and one eval forward at 64x96 (the loss, and the
   share of DOMD pixels that differ); one DualRefine step (the method's
   defaults at 64x96, batch 2) and one eval forward (the loss, pose_loss,
   and the largest difference of the refined disparity `disp_0_1` and of
   T*);
5. the path without the temporal hint: `create_train_state`, N training
   steps at `Config()` (192x640, batch 12, 96 depth bins, ResNet-18, fp32)
   on a seeded synthetic batch and one `eval_forward`;
5b. the ManyDepth options at `Config()`, 2 steps each from the same seeded
   weights, batch and draws: `Config()` itself, `remat=True` (first loss
   within 1e-4 relative and BN running statistics within 1e-5 of
   `Config()`'s, peak memory strictly below it), `pareto=True` (w_ori +
   w_distil = 1 within 1e-6, w_distil in [0.3, 0.9]) and
   `train_teacher_only=True` (the student's parameters bit-identical, every
   teacher and pose sub-net moved); K1 once a step on each;
6. the temporal hint in fp32: `Config(temporal=True, ins_threshold=0.0)`
   with the full-width Swin-L Mask2Former (seeded random weights; the
   lowered threshold makes matching and synthesis work on every item), N
   steps and one `eval_forward`;
7. the hint in fast mode: `Config(temporal=True,
   ins_threshold=0.0, **TRAIN_FAST_SETTINGS)` with `Mask2Former(
   bf16_backbone=True, fused_swin=True)`, N steps and one `eval_forward`,
   then the segmenter forward timed fused bf16, unfused bf16 and fp32, and
   the share of mask bits on which the fast segmenter leaves the fp32 one;
7b. the cached hint in fast mode: phase 7's configuration with
   `seg_cache_root` set and the batch carrying `seg_*` from a forward of
   the same segmenter on the same images (mask bits off a second forward's
   at most 1e-3), 3 steps beside 3 online steps from the same weights and
   draws, in turns: first loss within 1e-3 relative of the online one, step
   ms of both; K2 = K3 = 48 and K5 = 12 a cached step (online 72 / 18);
8. the DynamicDepth path (`benchmarks/bench_methods.py:59-61`):
   `Config(height=192, width=512, batch_size=14, method="dynamicdepth",
   cv_min=True, cv_set_1=True, cv_pool_th=0.15)` on a seeded batch with
   `synthetic_doj_masks`, N steps and one eval forward, in fp32 and then
   with `**TRAIN_FAST_SETTINGS`: K6 = steps + evals, K1-K5 = 0.
8b. the DualRefine path: `Config(method="dualrefine")` (192x640, batch 12,
   frames 0 / -1 / +1, HRNet-W18, Anderson with 6 evaluations, corr radius
   8 over 3 levels) on a seeded batch, N steps and one eval forward in fp32
   and then with `**TRAIN_FAST_SETTINGS` (every loss finite on every step;
   step ms first and median, frames/s, peak memory, eval ms; with
   `--profile` the idle share and the top device operations, also in
   `chiprun_out/profile_dualref_step.txt` and `..._fast_step.txt`), then in
   fp32 one step with the optimizer of `freeze_teacher_epoch`, which must
   move `conv2 / context / hidden / update_block` and nothing else. One
   kernel is on this path, the Gauss-Newton reduction (8 forwards and 1
   backward a step); every other count must stay 0.
8c. DynamicDepth with the online dynamic-object masks: phase 8's
   configuration with `online_doj=True, ins_threshold=0.0` and a seeded
   Swin-L Mask2Former making the masks of the three frames in each step,
   N steps and one eval forward, in fp32 (K4 = 24 and K5 = 6 a segmenter
   forward, three forwards a step) and in fast mode (K2 = K3 = 24, K4 = 0,
   K5 = 6 a forward); K6 = steps + evals; the masks binary and not all
   empty;
8d. data parallelism: the one-process step on `Config()`'s whole global
   batch of 12, run alone, then two gloo ranks on cuda:0 spawned by the
   script, each with half of the batch (on a machine with 2, 3, 4 or 6
   cards instead one NCCL rank a card, each with its share), 2 steps from
   the same state and draws (loss 2e-4 relative, bins 1e-5, every
   parameter and buffer 5e-5 absolute; the ranks' states equal bit for
   bit; on each rank K1 once a step and every other kernel 0; the ranks'
   step ms, each step after a barrier; then one more step with a barrier
   before each collective: the collectives, the time in them and the
   wait for the other ranks);
8e. the depth axis: `Config()`'s one-process step run alone, then two
   gloo ranks on cuda:0 as one depth row (1 data x 2 depth,
   `num_depth_shards=2`; on a machine whose card count is even and divides
   24, one NCCL rank a card as (cards / 2) data x 2 depth), each row
   holding its shard of the global batch of 12 and splitting the volume's
   96 planes, 2 steps from the same state and draws (phase 8d's bounds;
   the ranks equal bit for bit; K1 once a step on each rank, on its 48
   planes: its share of the volume holds cost on those planes and 0
   elsewhere before the gather; every other kernel 0; each rank's step ms
   and one step's gather ms); one DynamicDepth step (its benchmark
   configuration at a global batch of 12) in the same layout, the depth
   ranks replicas (K6 once on each; loss and state against one process);
   and on rank 0 K1 on its 48-plane share against its plain version,
   timed;
9. the CLI (`mal_tpu_torch.cli.main` only), in a fake KITTI tree of seeded
   1242x375 JPEGs under `build/chip_smoke_cli` with its own `splits/`:
   `train --preset kitti` at the recipe in fast mode (3 steps, one
   validation, one checkpoint; ms per step, the wait on the loader, which
   loader ran and, if `libmalio.so` did not build, why; frames/s through
   the CLI against the same state and step on a synthetic batch; with
   `--profile` the device idle share of one trainer step), `eval` of the
   checkpoint and, after `export-pth`, of its `.pth` directory (abs_rel
   within 1e-6), `train --seg_pkl` with the hint from a `.pkl` written from
   a seeded Swin-L Mask2Former (2 steps), `export-seg` of the same split
   with that `.pkl` in fp32 (2 files a frame; K4 = 24 and K5 = 6 a forward
   of batch 12; the export's time a file) and its rerun (0 files, 0
   launches), `train` with the hint from that cache (2 steps; K2 = K3 = 48,
   K5 = 12 a step), DynamicDepth `train` (2 steps, one validation) and its
   `eval --doj_root` on mask files, and DualRefine: `train --set
   method='dualrefine'` (2 steps, one validation, the end-of-epoch
   checkpoint), `eval` of it in fp32, `export-pth` to `depth_pose.pth` and
   `eval` of that directory (abs_rel within 1e-6), every kernel but the
   Gauss-Newton reduction (not counted here) at 0;
   DynamicDepth `train --seg_pkl --set online_doj=True` (2 steps, fast
   mode: K2 = K3 = 72 and K5 = 18 a step); and `train` at the recipe, 3
   steps, through a one-process NCCL group (`--coordinator 127.0.0.1:port
   --num_hosts 1 --host_id 0`; it checks the flags and the group's set-up
   only: at world 1 no collective runs, which the phase counts) beside the
   same command without the flags;
10. segmenter fine-tuning (phase 4 also holds the Swin-T fine-tuning loss
   on the card against the CPU, with no kernel launched):
   `finetune-seg` through `mal_tpu_torch.cli.main` at Swin-L, 256x448,
   batch 2, 100 queries, an 81-way head, 16 targets and 12,544 points, on a
   fake COCO tree of 6 seeded 640x480 JPEGs with COCO's 80 sparse ids and
   2-12 RLE / polygon instances each: 3 steps (every kernel 0), the
   mask-AP pass (K4 = 24, K5 = 6 a forward) and `model.pkl`; each step's ms
   and the matching's host ms, the peak memory, ms a forward of the AP pass;
11. segmenter inference at Swin-L, batch 2: K4 and K5 against their plain
   versions inside one forward at each TTA scale (192x320, 256x448,
   320x576), then semantic and panoptic output from one forward and
   `semantic_tta` at (0.75, 1, 1.25) with flip, each variant timed (K4 =
   24, K5 = 6 a forward);
12. MaskFormer v1 at `mal_tpu`'s defaults (Swin-T, 100 queries, 80
   classes, fp32), batch 2 at 256x448: every K4 call of one forward
   against its plain version at phase 11's tolerance, each on the w7
   route, then
   counted a forward (K4 = 12, every other kernel 0) with semantic and
   panoptic inference on its output, and `PerPixelBaselineHead` with the
   FPN and with the transformer-encoder pixel decoder on the backbone's
   features (no kernel), each forward timed.
Phases 5 to 12 set every kernel's launch count to 0 just before each path
(in phase 5b each option, in 7b each step, in 8b the frozen step, in phase
9 each command) and
read the counts just after; each kernel must have launched exactly as
often as its path calls it (phase 7: K2 = K3 = 72 per step, K4 = 0), and
at least once on some path. K5b is
exempt: nothing calls it, in `mal_tpu` either, and its phase is its
launch. The script then prints the `kernels`
JSON line (launches per path and in all), the card's line, and as the last
line `{"ok": true, "device": {...}}`. Without a CUDA device, or without the
`mal_tpu_torch` package beside it, it exits non-zero and prints no result.
`--kernels-only` stops after phase 3.
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
# K6: as K1; the warped occlusion mask is summed in one order by both, so
# no occlusion decision may flip either
K6_ATOL = 3e-5
K6_MAX_FLIPS = 0
# the small DynamicDepth reference, GPU against CPU: cuDNN's and the CPU's
# convolutions sum in other orders, and the DOMD splat truncates each
# projected point to a pixel, so a point within ~1e-6 of a pixel edge may
# land next door on one side
DYN_LOSS_RTOL = 1e-3
DYN_MAX_DOMD_SHARE = 1e-3   # share of DOMD frame values off by more than 1e-4
# K4: outputs of O(1); the kernels' softmax and 32-wide dot products round
# in another order than the plain version's matmuls
K4_ATOL = 2e-5
# K4's caller's time: rounds of back-to-back calls, each round bracketed by
# CUDA events (at ~0.03 ms a call one 20-call mean moved 2x between runs)
K4_ROUNDS = 7
K4_CALLS = 50
# K5: the kernel computes a sample's coordinate as x * w - 0.5, the plain
# version as grid_sample's ((2x - 1 + 1) * w - 1) / 2; the ~1e-7 relative
# difference moves bilinear weights on values of O(1), summed over 12 samples
K5_ATOL = 1e-4
# K2 / K3 in fp32: outputs of O(1) from sums of 192 to 6144 products, taken
# in another order than the plain version's cuBLAS products; erff against
# torch.erf
K23_F32_ATOL = 2e-4
# K2 / K3 in bf16: kernel and plain version round at the same places, so
# they differ where an fp32 sum in another order crosses a bf16 rounding
# boundary: an output moves by an ulp or two (2^-8 of its binade each), a
# few more after the 6144-term fc2 sums of stage 3
K23_BF16_RTOL = 2 ** -6
K23_BF16_ATOL = 2 ** -6
# ... and on average the two must agree far better than bf16 agrees with
# fp32 (a mean error of ~1e-3 at these shapes)
K23_BF16_MEAN = 3e-4
# K5b: as K5, three samples instead of twelve
K5B_ATOL = 1e-4
# the small DualRefine reference, GPU against CPU: cuDNN's and the CPU's
# convolutions sum in other orders; the per-pixel automask, the argmin
# over the trajectory's update norms and the consistency mask's argmin over
# 96 bins may each pick the other side of a near tie
DUALREF_LOSS_RTOL = 1e-3
DUALREF_DISP_ATOL = 1e-3
# the small temporal reference: GPU against CPU
SEG_MAX_BIT_FLIPS = 1e-3   # share of segmenter mask bits that may differ
TEMPORAL_LOSS_RTOL = 1e-3
# the same in fast mode: cuDNN's and the CPU's bf16 convolutions, and K2 / K3
# against their plain versions, sum in other orders, and every bf16 rounding
# that flips moves what follows by 2^-8 of its value
FAST_SEG_MAX_BIT_FLIPS = 2e-2
FAST_LOSS_RTOL = 2e-2
# the fast segmenter against the fp32 one on the card, with random weights
# (whose mask logits sit near 0 far more often than trained ones): a loose
# gate against a broken path, not a measure of the mode
FAST_VS_FP32_MAX_BIT_FLIPS = 0.25
PEAK_BF16_FLOPS = 989e12   # H100 SXM tensor cores, dense
SOURCES = ["plane_sweep", "window_attention", "deform_sample", "swin_block",
           "gauss_newton"]
# DynamicDepth's benchmark configuration (`benchmarks/bench_methods.py:59-61`)
DYNAMIC = dict(height=192, width=512, batch_size=14, method="dynamicdepth",
               cv_min=True, cv_set_1=True, cv_pool_th=0.15)


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


def ptxas_usage(source: str, fragment: str) -> list[str]:
    """Registers and spills, from the `-Xptxas -v` build log of
    csrc/<source>.cu, of each kernel whose mangled name holds `fragment`."""
    import re

    from mal_tpu_torch.ops.cuda import build

    log = build.library_path(source).with_suffix(".log").read_text()
    found, name, spill = [], None, "spill not reported"
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and fragment in name:
            spill = f"spill {m.group(1)} / {m.group(2)} bytes"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and fragment in name:
            found.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return found


def plane_sweep_report(tag: str, routes, M, t, bins, h: int, w: int, C: int,
                       occ: bool) -> None:
    """Print the share of K1's (occ: K6's) tiles on each route, as the
    kernel counted them, and the kernel's registers and spills; the counts
    must equal `plane_sweep_routes`' mirror of the kernel's decision."""
    from mal_tpu_torch.ops.cuda.cost_volume_kernel import (ROUTES,
                                                           plane_sweep_routes)

    got = dict(zip(ROUTES, routes.tolist()))
    want = plane_sweep_routes(M, t, bins, h, w, C, occ=occ)
    total = sum(got.values())
    full = got["staged"] + got["direct"]
    print(f"{tag} tiles by route: " + ", ".join(
        f"{r} {n} ({n / total:.4f})" for r, n in got.items())
        + f"; direct {got['direct'] / max(full, 1):.4f} of the tiles with a "
        f"sample inside the masks")
    check(got == want, f"{tag} routes {got} != plane_sweep_routes {want}")
    for line in ptxas_usage("plane_sweep", f"plane_sweep_diffs_kernelILb{int(occ)}E"):
        print(f"  {line}")


def _k1_measure(tag: str, cur, lookup, M, t, bins) -> dict:
    """K1 on these inputs against its plain version (the route counts
    against `plane_sweep_routes`, the error, the flipped border decisions),
    then its time, the plain version's and the bound."""
    import torch

    from mal_tpu_torch.ops.cuda.cost_volume_kernel import (
        plane_sweep_diffs, plane_sweep_diffs_reference)
    from mal_tpu_torch.utils.profiling import cuda_time_ms

    BF, h, w, C = cur.shape
    D = bins.shape[0]
    routes = torch.zeros(3, dtype=torch.int32, device="cuda")
    out = plane_sweep_diffs(cur, lookup, M, t, bins, routes=routes)
    torch.cuda.synchronize()
    plane_sweep_report(tag, routes, M, t, bins, h, w, C, occ=False)
    plain = plane_sweep_diffs_reference(cur, lookup, M, t, bins)
    err = (out - plain).abs().max().item()
    flips = ((out == 0) != (plain == 0)).sum().item()
    active = (plain != 0).sum().item()
    print(f"{tag} plane_sweep_diffs at BF={BF} D={D} h={h} w={w} C={C}: "
          f"max_abs_err={err:.3e} (atol {K1_ATOL}) flips={flips} "
          f"(max {K1_MAX_FLIPS}) active samples={active} of {out.numel()}")
    check(torch.isfinite(out).all().item(), f"{tag} output not finite")
    check(err <= K1_ATOL, f"{tag} disagrees with its plain version: {err}")
    check(flips <= K1_MAX_FLIPS, f"{tag} flipped {flips} border decisions")
    check(active > 0, f"{tag} check sampled nothing")

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
    print(f"{tag} time {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes / 1e6:.1f} MB -> "
          f"{bytes_ms:.4f} ms, {n_ops / 1e9:.2f} GFLOP -> {ops_ms:.4f} ms)")
    return {"planes": D, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def k1_phase() -> dict:
    got = _k1_measure("K1", *k1_inputs())
    return {"name": "plane_sweep_diffs", "route": "cuda",
            "source": "mal_tpu_torch/csrc/plane_sweep.cu",
            "replaces": "mal_tpu/ops/pallas/cost_volume_kernel.py:123",
            "max_abs_err": got["max_abs_err"], "ms": got["ms"],
            "plain_ms": got["plain_ms"], "bound_ms": got["bound_ms"],
            "bound_by": got["bound_by"], "library_ms": None}


def k6_phase() -> dict:
    """K6 at DynamicDepth's shape: BF = 14, D = 96, 48x128x64, K1's poses,
    occlusion masks with black patches, the substitution on for about
    two thirds of the frames, pool_th 0.15."""
    import numpy as np
    import torch

    from mal_tpu_torch.ops.cuda.cost_volume_kernel import (
        plane_sweep_diffs_occ, plane_sweep_diffs_occ_reference)
    from mal_tpu_torch.utils.profiling import cuda_time_ms

    pool_th = DYNAMIC["cv_pool_th"]
    cur, lookup, M, t, bins = k1_inputs(BF=14, w=128, seed=1)
    BF, h, w, C = cur.shape
    D = bins.shape[0]
    rng = np.random.RandomState(2)
    occ = np.zeros((BF, h, w), np.float32)
    occ[:, 15:30, 32:80] = 1.0                       # a moved car's hole
    for b in range(BF):                              # and smaller ones
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 12)
        occ[b, y:y + 8, x:x + 12] = 1.0
    apply_occ = (rng.uniform(0, 1, BF) > 0.33).astype(np.float32)
    occ, apply_occ = (torch.from_numpy(a).cuda() for a in (occ, apply_occ))
    args = (cur, lookup, occ, apply_occ, M, t, bins, pool_th)
    routes = torch.zeros(3, dtype=torch.int32, device="cuda")
    out = plane_sweep_diffs_occ(*args, routes=routes)
    torch.cuda.synchronize()
    plane_sweep_report("K6", routes, M, t, bins, h, w, C, occ=True)
    plain = plane_sweep_diffs_occ_reference(*args)
    err = (out - plain).abs().max().item()
    border_flips = ((out == 0) != (plain == 0)).sum().item()
    # occlusion decisions: where the occluded value (all frames occluded)
    # and the open one (none) are well apart, which of them each side gave
    occluded = plane_sweep_diffs_occ_reference(
        cur, lookup, torch.ones_like(occ), torch.ones_like(apply_occ), M, t,
        bins, pool_th)
    open_ = plane_sweep_diffs_occ_reference(
        cur, lookup, occ, torch.zeros_like(apply_occ), M, t, bins, pool_th)
    apart = (occluded - open_).abs() > 100 * K6_ATOL

    def chose_occluded(x):
        return (x - occluded).abs() < (x - open_).abs()

    occ_flips = (apart & (chose_occluded(out) != chose_occluded(plain))).sum().item()
    inside = (open_ != 0).sum().item()
    n_occluded = (apart & chose_occluded(plain)).sum().item()
    print(f"K6 plane_sweep_diffs_occ at BF={BF} D={D} h={h} w={w} C={C}: "
          f"max_abs_err={err:.3e} (atol {K6_ATOL}) border flips={border_flips}"
          f" occlusion flips={occ_flips} (max {K6_MAX_FLIPS} each); samples "
          f"inside the masks {inside} of {out.numel()}, occluded {n_occluded}")
    check(torch.isfinite(out).all().item(), "K6 output not finite")
    check(err <= K6_ATOL, f"K6 disagrees with its plain version: {err}")
    check(border_flips <= K6_MAX_FLIPS, f"K6 flipped {border_flips} border "
          f"decisions")
    check(occ_flips <= K6_MAX_FLIPS, f"K6 flipped {occ_flips} occlusion "
          f"decisions")
    check(n_occluded > 0 and inside > n_occluded, "K6 check substituted "
          "nothing or everything")

    ms = cuda_time_ms(lambda: plane_sweep_diffs_occ(*args), 50)
    plain_ms = cuda_time_ms(lambda: plane_sweep_diffs_occ_reference(*args), 10)
    n_bytes = 4 * (2 * cur.numel() + occ.numel() + BF + M.numel() + t.numel()
                   + D + out.numel())
    # operations this data needs: ~10 per sample for the projection and the
    # masks; inside them ~15 for the bilinear weights and, where the frame
    # applies the substitution, ~8 for the warped mask and its test; the
    # feature gathers (9 per channel) only for the samples not occluded;
    # and 2 per channel for each pixel's occluded value
    applied = apply_occ.bool()[:, None, None, None]
    inside_applied = ((open_ != 0) & applied).sum().item()
    pixels_applied = int(apply_occ.sum().item()) * h * w
    n_ops = (10 * out.numel() + 15 * inside + 8 * inside_applied
             + 9 * C * (inside - n_occluded) + 2 * C * pixels_applied)
    bound = _bound(n_bytes, n_ops, PEAK_FP32_FLOPS)
    print(f"K6 time {ms:.4f} ms, plain {plain_ms:.4f} ms; {bound['text']}")
    return {"name": "plane_sweep_diffs_occ", "route": "cuda",
            "source": "mal_tpu_torch/csrc/plane_sweep.cu",
            "replaces": "mal_tpu/ops/pallas/cost_volume_kernel.py:307",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
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


def small_dynamic_reference_phase() -> None:
    """One DynamicDepth step and one eval forward at 64x96 (the bench
    recipe's options, D = 16, B = 2): GPU path (K6) against the CPU's plain
    path, from the same weights, batch and draws."""
    import torch

    from mal_tpu_torch.config import Config
    from mal_tpu_torch.data.synthetic import (synthetic_batch,
                                              synthetic_doj_masks)
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    cfg = Config(**dict(DYNAMIC, height=64, width=96, batch_size=2,
                        num_depth_bins=16))
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(3), "cpu")
    batch.update(synthetic_doj_masks(cfg, "cpu"))
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
        res[dev] = (m["loss"].item(), {k: v.cpu() for k, v in ev.items()})
    (l_cpu, e_cpu), (l_gpu, e_gpu) = res["cpu"], res["cuda"]
    share = ((e_cpu["domd_color/-1"] - e_gpu["domd_color/-1"]).abs()
             > 1e-4).float().mean().item()
    d_err = (e_cpu["disp"] - e_gpu["disp"]).abs().max().item()
    print(f"small DynamicDepth reference (64x96, B=2, D=16): loss cpu "
          f"{l_cpu:.6f} gpu {l_gpu:.6f} (rtol {DYN_LOSS_RTOL}); eval DOMD "
          f"frame values off by > 1e-4: {share:.2e} (max {DYN_MAX_DOMD_SHARE})"
          f"; eval disparity max abs diff {d_err:.3e}")
    check(abs(l_cpu - l_gpu) <= DYN_LOSS_RTOL * abs(l_cpu),
          "GPU DynamicDepth loss != CPU loss")
    check(share <= DYN_MAX_DOMD_SHARE, "GPU DOMD frames != CPU DOMD frames")
    check(d_err <= 1e-3, "GPU eval disparity != CPU eval disparity")


def _rounds_ms(fns: dict, rounds: int = K4_ROUNDS,
               calls: int = K4_CALLS) -> dict[str, list[float]]:
    """The caller's time of each of `fns` (name -> fn): `rounds` rounds of
    `calls` back-to-back calls bracketed by CUDA events (`cuda_time_ms`),
    the functions in turns within each round. Once the host's cost of a
    call exceeds its kernel's, this is the host's time."""
    from mal_tpu_torch.utils.profiling import cuda_time_ms

    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].append(cuda_time_ms(fn, calls, warmup=1))
    return out


def _spread(times: list[float]) -> dict:
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def _spread_text(d: dict) -> str:
    return f"{d['median']:.4f} ({d['min']:.4f}-{d['max']:.4f})"


def _k4_stage_rows(label: str, stages: dict, ws: int, images: int,
                   launches: dict) -> tuple[list[dict], dict]:
    """K4 at each of `stages` (stage -> (padded map, real map, C, heads,
    whether its odd blocks shift)) for `images` images of window `ws`, in
    fp32, on its route (`window_attention_route(ws)`) and on the loop
    route, each against the plain version and beside fp32 SDPA: the device
    time per call of each (torch.profiler, SDPA's kernels summed) and the
    caller's time (`_rounds_ms`: median and min-max); the shifted stages
    also without their masks. With the sum over `launches` (stage ->
    launches) of the route's times."""
    import torch
    import torch.nn.functional as F

    from mal_tpu_torch.ops.cuda.window_attention import (
        relative_position_index, window_attention, window_attention_reference,
        window_attention_route)
    from mal_tpu_torch.segment.swin import shift_mask
    from mal_tpu_torch.utils.profiling import cuda_time_ms

    N = ws * ws
    route = window_attention_route(ws)
    routes = [route] + (["loop"] if route != "loop" else [])
    idx = torch.from_numpy(relative_position_index(ws)).cuda()
    shapes = []
    for stage, ((Hp, Wp), _, C, heads, shifted) in stages.items():
        g = torch.Generator(device="cuda").manual_seed(4 + stage)
        nm = (Hp // ws) * (Wp // ws)
        nW = images * nm
        mask = shift_mask(Hp, Wp, ws, ws // 2, "cuda") if shifted else None
        qkv = torch.randn((nW, N, 3 * C), generator=g, device="cuda")
        table = 0.02 * torch.randn(((2 * ws - 1) ** 2, heads), generator=g,
                                   device="cuda")
        plain = window_attention_reference(qkv, table, mask, heads)
        errs = {}
        for r in reversed(routes):   # the route's own output kept as `out`
            out = window_attention(qkv, table, mask, heads, route=r)
            torch.cuda.synchronize()
            errs[r] = (out - plain).abs().max().item()
            check(torch.isfinite(out).all().item(),
                  f"K4 ({r}) output not finite")
            check(errs[r] <= K4_ATOL, f"K4 ({r}) disagrees with its plain "
                  f"version at {label} stage {stage}: {errs[r]}")
        print(f"K4 window_attention {label} stage {stage} at nW={nW} "
              f"heads={heads} N={N} d={C // heads}"
              f"{f' nm={nm}' if shifted else ', no mask'}: max_abs_err "
              + ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
              + f" (atol {K4_ATOL})")
        del plain
        plain_ms = cuda_time_ms(
            lambda: window_attention_reference(qkv, table, mask, heads), 3, 1)
        # the library yardstick: one SDPA call on (nW, heads, N, d) q, k, v
        # with the bias (and mask) added into one (nW, heads, N, N) mask
        d = C // heads
        q, k, v = (t.reshape(nW, N, heads, d).transpose(1, 2).contiguous()
                   for t in qkv.reshape(nW, N, 3, C).unbind(2))
        bias = table[idx.reshape(-1)].reshape(N, N, heads).permute(2, 0, 1)
        per_window = bias[None] if mask is None else bias[None] + mask[:, None]
        attn_mask = per_window.expand(nm, heads, N, N).repeat(images, 1, 1, 1)
        lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        lib_err = (lib_out.transpose(1, 2).reshape(nW, N, C) - out).abs().max()
        fns = {r: (lambda r=r: window_attention(qkv, table, mask, heads,
                                                route=r)) for r in routes}
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask)
        if mask is not None:
            # the route without the mask: what reading the mask costs
            fns["unmasked"] = lambda: window_attention(qkv, table, None,
                                                       heads)
        device, names = {}, {}
        for name, fn in fns.items():
            parts = _sub_kernel_ms(fn)
            device[name] = sum(ms for _, ms in parts)
            names[name] = "+".join(n for n, _ in parts)
        caller = {name: _spread(t) for name, t in _rounds_ms(fns).items()}
        del q, k, v, attn_mask, lib_out
        for r in routes:
            check(f"window_attention_{'' if r == 'loop' else r + '_'}kernel"
                  in names[r], f"K4 route {r} launched {names[r]}")
        # least bytes: qkv, table and mask read once, out written once
        n_bytes = 4 * (qkv.numel() + table.numel() + out.numel()
                       + (0 if mask is None else mask.numel()))
        # operations: q k^T and p v (2 N^2 d multiply-adds each), and ~5 per
        # score for bias, mask, max, exp, sum and the division
        n_ops = nW * heads * (4 * N * N * d + 5 * N * N)
        bound = _bound(n_bytes, n_ops, PEAK_FP32_FLOPS)
        print(f"K4 {label} stage {stage}, device ms a call (torch.profiler) "
              f"/ caller's ms a call (median (min-max) of {K4_ROUNDS} rounds"
              f" of {K4_CALLS}): "
              + "; ".join(f"{name} {device[name]:.4f} / "
                          f"{_spread_text(caller[name])}"
                          for name in fns)
              + f"; plain {plain_ms:.4f} ms; SDPA max diff "
              f"{lib_err.item():.2e} ({names['sdpa']}); "
              f"{n_ops / device[route] / 1e9:.1f} TFLOP/s on {route}; "
              f"{bound['text']}")
        row = {"stage": stage, "nW": nW, "heads": heads, "N": N,
               "route": route, "max_abs_err": errs[route],
               "ms": caller[route]["median"], "device_ms": device[route],
               "caller_ms": caller[route], "plain_ms": plain_ms,
               "library_ms": caller["sdpa"]["median"],
               "library_device_ms": device["sdpa"],
               "library_caller_ms": caller["sdpa"],
               "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
        if route != "loop":
            row["loop"] = {"max_abs_err": errs["loop"],
                           "device_ms": device["loop"],
                           "caller_ms": caller["loop"]}
        if mask is not None:
            row["unmasked"] = {"device_ms": device["unmasked"],
                               "caller_ms": caller["unmasked"]}
        shapes.append(row)
        del qkv, out
    total = {key: sum(launches[r["stage"]] * r[key] for r in shapes)
             for key in ("ms", "device_ms", "library_ms",
                         "library_device_ms", "bound_ms")}
    return shapes, total


def k4_phase() -> dict:
    """K4 at the four stages of Swin-L in fp32 (stages 0 and 1 shifted with
    their masks, and also timed without them), with the time of one fp32
    hint step's launches, and at the four stages of Swin-T (MaskFormer v1,
    window 7, every stage shifted), with the time of one v1 forward's
    launches; each on its route and the loop route, beside fp32 SDPA."""
    shapes, per_step = _k4_stage_rows("Swin-L", SWIN_L_STAGES, SWIN_WINDOW,
                                      12, SWIN_L_LAUNCHES)
    print(f"K4 per fp32 hint step (launches x ms over the four stages, "
          f"{sum(SWIN_L_LAUNCHES.values())} launches): device "
          f"{per_step['device_ms']:.4f} ms, caller {per_step['ms']:.4f} ms;"
          f" SDPA {per_step['library_device_ms']:.4f} / "
          f"{per_step['library_ms']:.4f} ms; bound "
          f"{per_step['bound_ms']:.4f} ms")
    t_shapes, per_forward = _k4_stage_rows("Swin-T", SWIN_T_STAGES,
                                           SWIN_T_WINDOW, V1_BATCH,
                                           SWIN_T_LAUNCHES)
    print(f"K4 per MaskFormer v1 forward (launches x ms over the four "
          f"stages, {K4_V1_A_FORWARD} launches): device "
          f"{per_forward['device_ms']:.4f} ms, caller "
          f"{per_forward['ms']:.4f} ms; SDPA "
          f"{per_forward['library_device_ms']:.4f} / "
          f"{per_forward['library_ms']:.4f} ms; bound "
          f"{per_forward['bound_ms']:.4f} ms")
    for line in ptxas_usage("window_attention", "window_attention"):
        print(f"K4 {line}")
    main = shapes[0]
    return {"name": "window_attention", "route": "cuda",
            "source": "mal_tpu_torch/csrc/window_attention.cu",
            "replaces": "mal_tpu/ops/pallas/window_attention.py:64",
            "max_abs_err": max(r["max_abs_err"] for r in shapes + t_shapes),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "per_fp32_step_ms": per_step,
            "shapes": shapes, "swin_t_shapes": t_shapes,
            "per_v1_forward_ms": per_forward}


def k5_phase() -> dict:
    import torch

    from mal_tpu_torch.ops.cuda.deform_sample import (
        ms_deform_attn_core, ms_deform_attn_core_per_level)
    from mal_tpu_torch.utils.profiling import cuda_time_ms

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
    print(f"K5 per hint step (18 launches): {18 * ms:.4f} ms; bound "
          f"{18 * max(bytes_ms, ops_ms):.4f} ms")
    return {"name": "ms_deform_attn_core", "route": "cuda",
            "source": "mal_tpu_torch/csrc/deform_sample.cu",
            "replaces": "mal_tpu/ops/pallas/deform_sample.py:174",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}

# DualRefine's Gauss-Newton reduction against its plain version in float64,
# as a share of the largest entry: the kernel's fp32 sums
GN_REL_ATOL = 1e-5
# Gauss-Newton forwards and backwards of a DualRefine step at the defaults:
# the solve's 6 evaluations, the phantom unroll's and its recompute
GN_FORWARDS, GN_BACKWARDS = 8, 1


def gauss_newton_phase() -> dict:
    """DualRefine's Gauss-Newton normal equations at its cell's shape
    (batch 12, 64 channels, 48x160): H, b and the gradients of the four
    inputs against the plain version in float64, two launches to the bit,
    H and b to the plain version's float32 bits, then the device times of the kernel's forward and backward beside the
    plain version's and the bytes bound."""
    import torch

    from mal_tpu_torch.ops.cuda import gauss_newton as gn

    B, C, h, w = 12, 64, 48, 160
    N = h * w
    g = torch.Generator(device="cuda").manual_seed(11)
    u = lambda *s: torch.rand(s, generator=g, device="cuda",
                              dtype=torch.float64)
    X, Y, Z = 20 * u(B, N) - 10, 20 * u(B, N) - 10, 2 + 18 * u(B, N)
    fx, fy = 0.58 * w, 1.92 * h     # KITTI's intrinsics at the map's scale
    Jp = torch.stack([
        torch.stack([fx / Z, 0 * Z, -fx * X / Z ** 2, -fx * X * Y / Z ** 2,
                     fx + fx * X * X / Z ** 2, -fx * Y / Z], -1),
        torch.stack([0 * Z, fy / Z, -fy * Y / Z ** 2, -fy - fy * Y * Y / Z ** 2,
                     fy * X * Y / Z ** 2, fy * X / Z], -1)], 2)
    args64 = [u(B, C, 5, N), u(B, C, N), Jp, u(B, N)]
    dH64, db64 = u(B, 6, 6) - 0.5, u(B, 6) - 0.5
    leaves64 = [a.clone().requires_grad_(True) for a in args64]
    H64, b64 = gn.normal_equations_reference(*leaves64)
    want = (H64, b64, *torch.autograd.grad(
        (H64 * dH64).sum() + (b64 * db64).sum(), leaves64))
    leaves = [a.float().requires_grad_(True) for a in args64]
    dH, db = dH64.float(), db64.float()

    def kernel():
        H, b = gn.normal_equations(*leaves)
        return (H, b, *torch.autograd.grad((H * dH).sum() + (b * db).sum(),
                                           leaves))

    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    errs = {name: ((x.double() - t).abs().max() / t.abs().max()).item()
            for name, x, t in zip(("H", "b", "df", "dsrc", "dJp", "dw"),
                                  got, want)}
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    with torch.no_grad():
        plain = gn.normal_equations_reference(*(a.detach() for a in leaves))
    as_plain = all(torch.equal(x, y) for x, y in zip(got[:2], plain))
    print(f"Gauss-Newton normal equations at B={B} C={C} {h}x{w}: error "
          f"against float64 as a share of the largest entry "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (at most "
          f"{GN_REL_ATOL}); two launches {'equal' if same else 'DIFFER'}; "
          f"H and b {'equal' if as_plain else 'NOT equal'} to the plain "
          f"version's float32 bits")
    for line in ptxas_usage("gauss_newton", "normal_equations"):
        print(f"  {line}")
    check(all(v <= GN_REL_ATOL for v in errs.values()),
          f"Gauss-Newton kernel disagrees with its plain version: {errs}")
    check(same, "two Gauss-Newton launches differ")
    check(as_plain, "Gauss-Newton H and b differ from the plain version's "
          "bits at the cell's shape")

    args = [a.detach() for a in leaves]

    def plain_both():
        H, b = gn.normal_equations_reference(*leaves)
        torch.autograd.grad((H * dH).sum() + (b * db).sum(), leaves)

    # device ms a call by torch.profiler: the caller's time of one call is
    # the host's (ctypes, autograd), which the step overlaps
    parts = dict(_sub_kernel_ms(kernel, 10))
    _print_breakdown("Gauss-Newton forward + backward", list(parts.items()))
    ms = sum(v for k, v in parts.items() if "normal_equations_" in k
             and "normal_equations_bwd" not in k)
    bwd_ms = sum(v for k, v in parts.items() if "normal_equations_bwd" in k)
    with torch.no_grad():
        plain_ms = sum(v for _, v in _sub_kernel_ms(
            lambda: gn.normal_equations_reference(*args), 3))
    plain_both_ms = sum(v for _, v in _sub_kernel_ms(plain_both, 3))
    # least bytes: the inputs read once, H and b (forward) or the inputs'
    # gradients (backward) written once; operations a (pixel, channel): g,
    # r and j ~31, the 27 weighted products ~60 (forward); S j, j . db and
    # dj ~100, dg, dJp and dw ~60 more (backward)
    inputs = 4 * sum(a.numel() for a in args)
    fwd = _bound(inputs + 4 * B * 42, 91 * B * C * N, PEAK_FP32_FLOPS)
    bwd = _bound(2 * inputs + 4 * B * 42, 191 * B * C * N, PEAK_FP32_FLOPS)
    print(f"Gauss-Newton device ms: forward {ms:.4f} ({fwd['text']}), plain "
          f"{plain_ms:.4f}; backward {bwd_ms:.4f} ({bwd['text']}), plain "
          f"forward + backward {plain_both_ms:.4f}")
    print(f"Gauss-Newton per DualRefine step ({GN_FORWARDS} forwards, "
          f"{GN_BACKWARDS} backward): {GN_FORWARDS * ms + GN_BACKWARDS * bwd_ms:.4f}"
          f" ms; plain {(GN_FORWARDS - 1) * plain_ms + plain_both_ms:.4f} ms")
    return {"name": "normal_equations", "route": "cuda",
            "source": "mal_tpu_torch/csrc/gauss_newton.cu",
            "replaces": None, "max_rel_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "backward_ms": bwd_ms,
            "plain_backward_ms": plain_both_ms - plain_ms,
            "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
            "backward_bound_ms": bwd["bound_ms"], "library_ms": None}


# Swin-L at 192x640 with window 12: stage -> (padded map, real map, C, heads,
# whether odd blocks shift). `segment/swin.py`'s rule: a map pads to window
# multiples, and is shifted only where both padded sides exceed one window.
SWIN_L_STAGES = {0: ((48, 168), (48, 160), 192, 6, True),
                 1: ((24, 84), (24, 80), 384, 12, True),
                 2: ((12, 48), (12, 40), 768, 24, False),
                 3: ((12, 24), (6, 20), 1536, 48, False)}
SWIN_WINDOW = 12
# K2 / K3 launches per fast step by stage: blocks 2 / 2 / 18 / 2, times the
# segmenter's 3 forwards a step (the current frame and two warped frames,
# `train/step.py`); stages 0 and 1 time their shifted block for all
SWIN_L_LAUNCHES = {0: 6, 1: 6, 2: 54, 3: 6}


def _bound(n_bytes: float, n_ops: float, peak_flops: float) -> dict:
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / peak_flops * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "text": f"bound {max(bytes_ms, ops_ms):.4f} ms ({n_bytes / 1e6:.1f}"
                    f" MB -> {bytes_ms:.4f} ms, {n_ops / 1e9:.2f} GFLOP -> "
                    f"{ops_ms:.4f} ms)"}


def _sub_kernel_ms(fn, reps: int = 5) -> list[tuple[str, float]]:
    """Device time per call of each kernel fn() launches, by kernel name in
    the order of first launch, from torch.profiler: [(kernel name, ms),
    ...]. A name's time is its mean over the calls' events times its
    launches a call, so an event the profiler drops (it has dropped one in
    twenty) moves no number much."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.name != "Buffer Flush"),
                    key=lambda e: e.time_range.start)
    if not events:
        raise RuntimeError(f"no kernel events over {reps} calls")
    by_name: dict[str, list[float]] = {}
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:72]
        by_name.setdefault(name, []).append(e.time_range.elapsed_us())
    return [(name, statistics.fmean(us) * max(1, round(len(us) / reps)) / 1e3)
            for name, us in by_name.items()]


def _print_breakdown(what: str, parts: list[tuple[str, float]]) -> None:
    lines = [f"{what} sub-kernels (torch.profiler, device ms per call):"]
    lines += [f"  {i}. {name}: {ms:.4f}" for i, (name, ms) in enumerate(parts)]
    lines.append(f"  sum {sum(ms for _, ms in parts):.4f}")
    print("\n".join(lines))


def _swin_block(stage: int):
    """A shifted-or-not Swin-L block of `stage` on the card in its unfused
    bf16 form, with seeded random parameters that K2 / K3 are given too."""
    import torch

    from mal_tpu_torch.segment.swin import SwinBlock

    _, _, C, heads, shifted = SWIN_L_STAGES[stage]
    block = SwinBlock(C, heads, SWIN_WINDOW, shifted,
                      compute_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(20 + stage)
    with torch.no_grad():
        for name, p in block.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() == 2 and name.endswith("weight"):
                p.copy_(r / p.shape[1] ** 0.5)          # Linear kernels
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * r)                  # norm scales
            else:
                p.copy_(0.1 * r)                        # biases, the table
    return block.cuda().eval().requires_grad_(False)


def _swin_agreement(what: str, out, plain, mode: str) -> float:
    """Hold a K2 / K3 output against its plain version; returns max abs err."""
    import torch

    check(torch.isfinite(out).all().item(), f"{what} output not finite")
    diff = (out.float() - plain.float()).abs()
    err, mean = diff.max().item(), diff.mean().item()
    scale = plain.float().abs().max().item()
    if mode == "fp32":
        print(f"{what}: max_abs_err={err:.3e} (atol {K23_F32_ATOL}), "
              f"relative to the largest output {err / scale:.3e}")
        check(err <= K23_F32_ATOL, f"{what} disagrees with its plain version")
    else:
        worst = (diff / (K23_BF16_ATOL + K23_BF16_RTOL
                         * plain.float().abs())).max().item()
        print(f"{what}: max_abs_err={err:.3e}, relative to the largest output "
              f"{err / scale:.3e}, {worst:.2f} of the tolerance (atol "
              f"{K23_BF16_ATOL} + rtol {K23_BF16_RTOL}); mean_abs_err="
              f"{mean:.3e} (max {K23_BF16_MEAN})")
        check(worst <= 1.0, f"{what} disagrees with its plain version")
        check(mean <= K23_BF16_MEAN, f"{what}: mean error {mean}")
    return err


def _swin_modes():
    import torch

    return (("bf16", torch.bfloat16, PEAK_BF16_FLOPS),
            ("fp32", torch.float32, PEAK_FP32_FLOPS))


def _swin_summary(name: str, replaces: str, shapes: list[dict]) -> dict:
    """The `kernels` entry of K2 or K3: stage 0 in bf16 (the fast path's
    first block) as its headline, every stage and mode under `shapes`, and
    the bf16 time of one fast step's launches, stage by stage."""
    bf16 = [r for r in shapes if r["mode"] == "bf16"]
    per_step = {k: sum(SWIN_L_LAUNCHES[r["stage"]] * r[k] for r in bf16)
                for k in ("ms", "unfused_bf16_ms", "bound_ms")}
    print(f"{name} per fast step (bf16, launches x ms over the four stages, "
          f"{sum(SWIN_L_LAUNCHES.values())} launches): {per_step['ms']:.4f} ms;"
          f" unfused bf16 {per_step['unfused_bf16_ms']:.4f} ms; bound "
          f"{per_step['bound_ms']:.4f} ms")
    main = shapes[0]
    return {"name": name, "route": "cuda",
            "source": "mal_tpu_torch/csrc/swin_block.cu",
            "replaces": replaces,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "unfused_bf16_ms": main["unfused_bf16_ms"],
            "per_fast_step_ms": per_step, "shapes": shapes}


def k2_phase(profile: bool = False) -> dict:
    """K2 at the four stages of Swin-L (stages 0 and 1 shifted with their
    masks, every map padded to window multiples), in bf16 (stream and
    compute) and in fp32; with `profile`, each bf16 call's kernels."""
    import torch
    import torch.nn.functional as F

    from mal_tpu_torch.ops.cuda.swin_block import (swin_attn_fused,
                                                   swin_attn_reference)
    from mal_tpu_torch.segment.swin import (shift_mask, window_partition,
                                            window_reverse)
    from mal_tpu_torch.utils.profiling import cuda_time_ms

    B, ws = 12, SWIN_WINDOW
    N = ws * ws
    shapes = []
    for stage, ((Hp, Wp), (H, W), C, heads, shifted) in SWIN_L_STAGES.items():
        block = _swin_block(stage)
        g = torch.Generator(device="cuda").manual_seed(6 + stage)
        x = torch.randn((B, H, W, C), generator=g, device="cuda")
        xr = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        valid = F.pad(torch.ones((H, W), device="cuda"), (0, Wp - W, 0, Hp - H))
        mask = None
        if shifted:
            xr = torch.roll(xr, (-ws // 2, -ws // 2), dims=(1, 2))
            valid = torch.roll(valid, (-ws // 2, -ws // 2), dims=(0, 1))
            mask = shift_mask(Hp, Wp, ws, ws // 2, "cuda")
        a = block.attn
        params = (block.norm1.weight, block.norm1.bias, a.qkv.weight,
                  a.qkv.bias, a.relative_position_bias_table, mask,
                  a.proj.weight, a.proj.bias)
        M, nW = B * Hp * Wp, B * Hp * Wp // N
        for mode, dt, peak in _swin_modes():
            xs = xr.to(dt).contiguous()

            def call(fn):
                return fn(xs, valid, *params, window_size=ws, num_heads=heads,
                          compute_dtype=dt)

            out = call(swin_attn_fused)
            torch.cuda.synchronize()
            plain = call(swin_attn_reference)
            what = (f"K2 swin_attn_fused stage {stage} {mode} at {B}x{Hp}x{Wp}"
                    f"x{C}, {heads} heads, {nW} windows"
                    f"{', shifted' if shifted else ''}")
            err = _swin_agreement(what, out, plain, mode)
            del plain
            ms = cuda_time_ms(lambda: call(swin_attn_fused), 10)
            plain_ms = cuda_time_ms(lambda: call(swin_attn_reference), 2, 1)
            # least bytes: the stream read and written once, the parameters,
            # valid, table and mask once
            n_bytes = (2 * xs.numel() * xs.element_size() + 4 * sum(
                t.numel() for t in (valid, *params) if t is not None))
            # operations: the qkv and proj products, q k^T and p v per window
            # and head, ~5 per score for the softmax
            n_ops = (2 * M * C * 4 * C
                     + nW * heads * (4 * N * N * 32 + 5 * N * N))
            bound = _bound(n_bytes, n_ops, peak)
            row = {"stage": stage, "mode": mode, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"], "unfused_bf16_ms": None}
            text = f"K2 stage {stage} {mode}: {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if mode == "bf16":
                # the same function from the port's unfused bf16 pieces:
                # cuBLAS Linears in bf16 around K4
                def unfused():
                    y = block.norm1(xs.float()) * valid[None, :, :, None]
                    wins = block.attn(window_partition(y, ws), mask)
                    return window_reverse(wins, ws, Hp, Wp)

                row["unfused_bf16_ms"] = cuda_time_ms(unfused, 10)
                gap = (unfused() - out.float()).abs().max().item()
                text += (f", unfused bf16 (cuBLAS + K4) "
                         f"{row['unfused_bf16_ms']:.4f} ms (max diff {gap:.2e})"
                         f", {ms / row['unfused_bf16_ms']:.3f} of it")
                if profile:
                    _print_breakdown(f"K2 stage {stage} bf16",
                                     _sub_kernel_ms(lambda: call(swin_attn_fused)))
            print(f"{text}; {bound['text']}")
            shapes.append(row)
    return _swin_summary("swin_attn_fused",
                         "mal_tpu/ops/pallas/swin_block.py:170", shapes)


def k3_phase(profile: bool = False) -> dict:
    """K3 at the four stages of Swin-L (92,160 / 23,040 / 5,760 / 1,440
    tokens of 192 / 384 / 768 / 1536), in bf16 and in fp32; with `profile`,
    each bf16 call's kernels."""
    import torch

    from mal_tpu_torch.ops.cuda.swin_block import (swin_mlp_fused,
                                                   swin_mlp_reference)
    from mal_tpu_torch.utils.profiling import cuda_time_ms

    B = 12
    shapes = []
    for stage, (_, (H, W), C, _, _) in SWIN_L_STAGES.items():
        block = _swin_block(stage)
        M = B * H * W
        g = torch.Generator(device="cuda").manual_seed(8 + stage)
        x = torch.randn((M, C), generator=g, device="cuda")
        m = block.mlp
        params = (block.norm2.weight, block.norm2.bias, m.fc1.weight,
                  m.fc1.bias, m.fc2.weight, m.fc2.bias)
        for mode, dt, peak in _swin_modes():
            xs = x.to(dt)

            def call(fn):
                return fn(xs, *params, compute_dtype=dt)

            out = call(swin_mlp_fused)
            torch.cuda.synchronize()
            plain = call(swin_mlp_reference)
            err = _swin_agreement(f"K3 swin_mlp_fused stage {stage} {mode} at "
                                  f"{M}x{C}, hidden {4 * C}", out, plain, mode)
            del plain
            ms = cuda_time_ms(lambda: call(swin_mlp_fused), 10)
            plain_ms = cuda_time_ms(lambda: call(swin_mlp_reference), 2, 1)
            n_bytes = (2 * xs.numel() * xs.element_size()
                       + 4 * sum(t.numel() for t in params))
            n_ops = 2 * M * C * 4 * C * 2 + 10 * M * 4 * C   # products, GELU
            bound = _bound(n_bytes, n_ops, peak)
            row = {"stage": stage, "mode": mode, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"], "unfused_bf16_ms": None}
            text = f"K3 stage {stage} {mode}: {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if mode == "bf16":
                def unfused():
                    xf = xs.float()
                    return xf + block.mlp(block.norm2(xf))

                row["unfused_bf16_ms"] = cuda_time_ms(unfused, 10)
                gap = (unfused() - out.float()).abs().max().item()
                text += (f", unfused bf16 (cuBLAS) "
                         f"{row['unfused_bf16_ms']:.4f} ms (max diff {gap:.2e})"
                         f", {ms / row['unfused_bf16_ms']:.3f} of it")
                if profile:
                    _print_breakdown(f"K3 stage {stage} bf16",
                                     _sub_kernel_ms(lambda: call(swin_mlp_fused)))
            print(f"{text}; {bound['text']}")
            shapes.append(row)
    return _swin_summary("swin_mlp_fused",
                         "mal_tpu/ops/pallas/swin_block.py:364", shapes)


def k5b_phase() -> dict:
    """K5b at the pixel decoder's shapes in the sample-major layout: 96
    (batch x head) groups of 32 channels, 2520 queries x 4 points = 10,080
    samples a group in 5 tiles of 2048, the tail padded with aw = 0. Both
    routes (`major_staged_channels` takes the staged one here), each
    against the plain version, with device and caller's times."""
    import torch

    from mal_tpu_torch.ops.cuda.deform_sample import (
        deform_sample_fused, deform_sample_fused_reference,
        major_staged_channels)
    from mal_tpu_torch.utils.profiling import cuda_time_ms

    G, ch, T, S, real = 96, 32, 5, 2048, 10080
    shapes = ((6, 20), (12, 40), (24, 80))
    check(major_staged_channels(sum(h * w for h, w in shapes), ch) == 8,
          "K5b would not take its staged route at the phase's shapes")
    g = torch.Generator(device="cuda").manual_seed(9)
    vms = [torch.randn((G, h * ch, w), generator=g, device="cuda")
           for h, w in shapes]
    x, y = (-0.1 + 1.2 * torch.rand((G, T, 3, S), generator=g, device="cuda")
            for _ in range(2))
    aw = torch.rand((G, 3, T * S), generator=g, device="cuda")
    aw[..., real:] = 0.0                              # the padded tail
    aw = aw.reshape(G, 3, T, S).transpose(1, 2).contiguous()
    args = (*vms, x, y, aw, shapes, ch)
    plain = deform_sample_fused_reference(*args)
    routes = ("staged", "gather")
    errs, outs = {}, {}
    for r in routes:
        outs[r] = deform_sample_fused(*args, route=r)
        torch.cuda.synchronize()
        errs[r] = (outs[r] - plain).abs().max().item()
        check(torch.isfinite(outs[r]).all().item(),
              f"K5b ({r}) output not finite")
        check(errs[r] <= K5B_ATOL,
              f"K5b ({r}) disagrees with its plain version: {errs[r]}")
    check(outs["staged"].abs().max().item() > 1.0, "K5b sampled nothing")
    same = torch.equal(outs["staged"], outs["gather"])
    print(f"K5b deform_sample_fused at G={G} T={T} S={S} ch={ch} levels="
          f"{shapes}: max_abs_err staged {errs['staged']:.3e}, gather "
          f"{errs['gather']:.3e} (atol {K5B_ATOL}); the two routes equal "
          f"to the bit: {same}")
    del plain, outs

    fns = {r: (lambda r=r: deform_sample_fused(*args, route=r))
           for r in routes}
    device, names = {}, {}
    for r, fn in fns.items():
        parts = _sub_kernel_ms(fn)
        device[r] = sum(ms for _, ms in parts)
        names[r] = "+".join(n for n, _ in parts)
    check("major_staged_kernel" in names["staged"]
          and "major_kernel" in names["gather"],
          f"K5b routes launched {names}")
    caller = {r: _spread(t) for r, t in _rounds_ms(fns, calls=20).items()}
    plain_ms = cuda_time_ms(lambda: deform_sample_fused_reference(*args), 3)
    # corners inside their level map: what this data makes the kernel read
    sizes = torch.tensor([[w, h] for h, w in shapes], device="cuda")
    xy0 = torch.floor(torch.stack([x, y], -1) * sizes[:, None] - 0.5)
    inside = [((xy0[..., i:i + 1] + d >= 0)
               & (xy0[..., i:i + 1] + d <= sizes[:, None, i:i + 1] - 1))
              for i in range(2) for d in (0, 1)]
    corners = sum(((inside[a] & inside[2 + b]).sum().item()
                   for a in (0, 1) for b in (0, 1)))
    n_bytes = 4 * (sum(v.numel() for v in vms) + 3 * x.numel()
                   + G * T * ch * S)
    n_ops = x.numel() * (18 + 2 * ch) + corners * 2 * ch
    bound = _bound(n_bytes, n_ops, PEAK_FP32_FLOPS)
    print(f"K5b device ms a call (torch.profiler) / caller's ms a call "
          f"(median (min-max) of {K4_ROUNDS} rounds of 20): "
          + "; ".join(f"{r} {device[r]:.4f} / {_spread_text(caller[r])}"
                      for r in routes)
          + f"; plain {plain_ms:.4f} ms; {corners} of {4 * x.numel()} "
          f"corners inside; {bound['text']}")
    for line in ptxas_usage("deform_sample", "major"):
        print(f"K5b {line}")
    return {"name": "deform_sample_fused", "route": "cuda",
            "source": "mal_tpu_torch/csrc/deform_sample.cu",
            "replaces": "mal_tpu/ops/pallas/deform_sample.py:213",
            "max_abs_err": max(errs.values()), "ms": caller["staged"]["median"],
            "device_ms": device["staged"], "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None,
            "routes": {r: {"max_abs_err": errs[r], "device_ms": device[r],
                           "caller_ms": caller[r]} for r in routes}}


def small_temporal_reference_phase(fast: bool = False) -> None:
    """One temporal step at 64x96 with a Swin-T Mask2Former: GPU against
    CPU, from the same weights, batch and draws. `fast`: in fast mode (bf16
    nets and payloads, the segmenter's blocks as K2 and K3 on the GPU and
    as their plain versions on the CPU)."""
    import torch

    from mal_tpu_torch.config import TRAIN_FAST_SETTINGS, Config
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.segment.mask2former import Mask2Former, make_seg_fn
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    cfg = Config(height=64, width=96, num_depth_bins=16, batch_size=2,
                 temporal=True, ins_threshold=0.0,
                 **(TRAIN_FAST_SETTINGS if fast else {}))
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(3), "cpu")
    B, H, W = 2, cfg.height, cfg.width
    g = torch.Generator().manual_seed(4)
    draws = {"matching_aug": torch.tensor([0.9, 0.1]),
             "automask_noise": torch.randn((B, 1, H, W), generator=g)}
    res = {}
    for dev in ("cpu", "cuda"):
        seg = Mask2Former(swin_size="tiny", num_queries=20, device=dev,
                          generator=torch.Generator().manual_seed(1),
                          bf16_backbone=fast, fused_swin=fast)
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
    max_flips = FAST_SEG_MAX_BIT_FLIPS if fast else SEG_MAX_BIT_FLIPS
    rtol = FAST_LOSS_RTOL if fast else TEMPORAL_LOSS_RTOL
    print(f"small {'fast-mode ' if fast else ''}temporal reference (64x96, "
          f"B=2, Swin-T, 20 queries): loss cpu {l_cpu:.6f} gpu {l_gpu:.6f} "
          f"(rtol {rtol}); matched items cpu {n_cpu:.0f} gpu {n_gpu:.0f}; "
          f"segmenter mask bits differing {flips:.2e} (max {max_flips})")
    check(flips <= max_flips, "GPU segmenter masks != CPU masks")
    # in fast mode a flipped mask bit may change which instances pair up
    check(n_gpu > 0 and (fast or n_gpu == n_cpu),
          "matching differs or found nothing")
    check(abs(l_cpu - l_gpu) <= rtol * abs(l_cpu),
          "GPU temporal loss != CPU temporal loss")


def run_path(cfg, steps: int, seg_fn, counters, profile: str | None,
             doj_fn=None):
    """`create_train_state`, `steps` training steps and one `eval_forward`
    at `cfg` on a seeded synthetic batch, with every kernel's launch count
    set to 0 just before and read just after (`doj_fn`: DynamicDepth's
    online masks). Returns (launches by kernel name, the state, the
    batch)."""
    import torch

    from mal_tpu_torch.data.synthetic import (synthetic_batch,
                                              synthetic_doj_masks)
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step
    from mal_tpu_torch.utils.profiling import idle_share

    dynamic = cfg.method == "dynamicdepth"
    t0 = time.perf_counter()
    state = create_train_state(cfg)
    step = make_train_step(cfg, seg_fn=seg_fn, doj_fn=doj_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = synthetic_batch(cfg, gen, "cuda")
    if dynamic:
        batch.update(synthetic_doj_masks(cfg, "cuda"))
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
        pairs = ("" if dynamic else f", items with a matched pair "
                 f"{metrics['syn_items'].item():.0f}")
        print(f"step {i}: loss {loss:.6f}{pairs} ({times[-1]:.2f} ms)")
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
    # MALModel's eval gives the matching maps at 1/4, DynDepthModel's at 1
    h, w = (H, W) if dynamic else (H // 4, W // 4)
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
        def one_step():
            nonlocal state
            state, _ = step(state, batch, 0.0, gen)

        _, busy_ms, prof = idle_share(one_step)
        # K1 / K6 in this step (each a few tenths of a ms: below the table)
        sweep = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "plane_sweep_diffs_kernel" in e.name]
        print(f"plane-sweep kernels in the profiled step: {len(sweep)} "
              f"launches, {sum(sweep) / 1e3:.4f} ms of device time "
              f"({sum(sweep) / 1e3 / busy_ms:.4f} of the busy time)")
        os.makedirs("chiprun_out", exist_ok=True)
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        with open(f"chiprun_out/{profile}.txt", "w") as f:
            f.write(table)
        print(table[:6000])
    return launches, state, batch


def main_path_phase(steps: int, profile: bool) -> dict[str, int]:
    """The path without the temporal hint at `Config()`."""
    from mal_tpu_torch.config import Config

    cfg = Config()
    print(f"path without the temporal hint: Config() {cfg.height}x"
          f"{cfg.width} batch {cfg.batch_size}, {cfg.num_depth_bins} bins, "
          f"ResNet-{cfg.num_layers}, {cfg.compute_dtype}; {steps} steps + "
          f"1 eval")
    launches, _, _ = run_path(cfg, steps, None, _counted_wrappers(),
                              "profile_step" if profile else None)
    check(launches["plane_sweep_diffs"] == steps + 1,
          "K1 launch count != steps + evals")
    check(launches["plane_sweep_diffs_occ"] == 0, "K6 launched off its path")
    return launches


def _draws(cfg, seed: int) -> dict:
    """A step's two random draws on the card, made from `seed`."""
    import torch

    g = torch.Generator().manual_seed(seed)
    B, H, W = cfg.batch_size, cfg.height, cfg.width
    return {"matching_aug": torch.rand(B, generator=g).cuda(),
            "automask_noise": torch.randn((B, 1, H, W), generator=g).cuda()}


def _timed_steps(cfg, weights, batch, draws, steps: int, every: list,
                 seg_fn=None) -> dict:
    """`steps` training steps at `cfg` from `weights` with the draws
    injected, every kernel's count set to 0 just before and read just after:
    the state, each step's metrics and ms, the peak memory (GiB) and the
    launches, plus the BN running statistics after the first step."""
    import torch

    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    state = create_train_state(cfg, init_weights=False)
    state.model.load_state_dict(weights)
    step = make_train_step(cfg, seg_fn=seg_fn)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in every:
        fn.launches = 0
    out = {"metrics": [], "ms": []}
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, 0.0, draws=draws)
        m = {k: v.item() for k, v in m.items()}
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append(m)
        check(all(v == v and abs(v) != float("inf") for v in m.values()),
              f"non-finite metrics at step {i}: {m}")
        if i == 0:
            out["bn"] = {k: v.cpu().clone()
                         for k, v in state.model.state_dict().items()
                         if "running" in k}
    out["launches"] = {fn.__name__: fn.launches for fn in every}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["state"] = state
    return out


def options_phase(every: list, steps: int = 2) -> dict[str, dict[str, int]]:
    """The ManyDepth options at `Config()`'s full width (192x640, batch 12,
    96 bins, fp32), each from the same seeded weights, batch and draws:
    `pareto`, `remat` beside a twin without it (which is `Config()`
    itself), and `train_teacher_only`. K1 launches once a step on each."""
    import torch

    from mal_tpu_torch.config import Config
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.train.state import create_train_state

    base = Config()
    weights = {k: v.clone() for k, v in
               create_train_state(base).model.state_dict().items()}
    batch = synthetic_batch(base, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    draws = _draws(base, 5)
    runs, by_path = {}, {}
    card = card_line()
    for name, option in (("config", {}), ("remat", {"remat": True}),
                         ("pareto", {"pareto": True}),
                         ("teacher_only", {"train_teacher_only": True})):
        run = _timed_steps(base.replace(**option), weights, batch, draws,
                           steps, every)
        launches = run["launches"]
        print(f"option {name} at Config() 192x640 batch 12, 96 "
              f"bins, fp32: step ms {', '.join(f'{t:.2f}' for t in run['ms'])}"
              f", peak memory {run['peak_gib']:.2f} GiB, first loss "
              f"{run['metrics'][0]['loss']:.6f}; launches {launches} ({card})")
        for kernel, n in launches.items():
            want = steps if kernel == "plane_sweep_diffs" else 0
            check(n == want, f"{name}: {kernel} launched {n} times, not {want}")
        if name == "teacher_only":
            moved = {k.split(".")[0] for k, p in
                     run["state"].model.named_parameters()
                     if not torch.equal(p, weights[k])}
            print(f"teacher_only: sub-nets whose parameters moved {moved}")
            check(moved == {"mono_encoder", "mono_depth", "pose_encoder",
                            "pose"}, "teacher_only moved the student or "
                  "left a teacher sub-net where it was")
        run.pop("state")
        runs[name] = run
        by_path[f"option_{name}"] = launches
        torch.cuda.empty_cache()

    for i, m in enumerate(runs["pareto"]["metrics"]):
        w0, w1 = m["w_ori"], m["w_distil"]
        print(f"pareto step {i}: w_ori {w0!r} w_distil {w1!r}")
        check(abs(w0 + w1 - 1.0) <= 1e-6, "pareto weights do not sum to 1")
        check(0.3 - 1e-6 <= w1 <= 0.9 + 1e-6, "pareto w_distil out of bounds")
    twin, remat = runs["config"], runs["remat"]
    l0, l1 = twin["metrics"][0]["loss"], remat["metrics"][0]["loss"]
    bn_gap = max((remat["bn"][k] - v).abs().max().item()
                 for k, v in twin["bn"].items())
    print(f"remat against its twin: first loss {l1!r} / {l0!r}, BN running "
          f"statistics after the first step at most {bn_gap:.3e} apart; peak "
          f"memory {remat['peak_gib']:.3f} / {twin['peak_gib']:.3f} GiB "
          f"({card})")
    check(abs(l1 - l0) <= 1e-4 * abs(l0), "remat changed the loss")
    check(bn_gap <= 1e-5, "remat moved the BN running statistics")
    check(remat["peak_gib"] < twin["peak_gib"], "remat did not lower the "
          "peak memory")
    return by_path


def cached_hint_phase(seg_fn, every: list, steps: int = 3
                      ) -> dict[str, dict[str, int]]:
    """The hint in fast mode with the current frame's instances from the
    batch (`seg_cache_root`), beside the online step from the same weights
    and draws: the batch carries `seg_*` from one forward of the same fused
    segmenter on the same images. `steps` steps of each, in turns."""
    import torch

    from mal_tpu_torch.config import TRAIN_FAST_SETTINGS, Config
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    online = Config(temporal=True, ins_threshold=0.0, **TRAIN_FAST_SETTINGS)
    cached = online.replace(seg_cache_root="synthetic")
    batch = synthetic_batch(online,
                            torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    inst = seg_fn(batch["color"]["0"])
    again = seg_fn(batch["color"]["0"]).masks
    flips = (inst.masks != again).float().mean().item()
    print(f"cached hint: mask bits on which two forwards of the fused "
          f"segmenter differ {flips:.2e} (max {SEG_MAX_BIT_FLIPS})")
    check(flips <= SEG_MAX_BIT_FLIPS, "the cached instances are not the "
          "online ones")
    batch_c = dict(batch, seg_masks=inst.masks, seg_classes=inst.classes,
                   seg_scores=inst.scores, seg_valid=inst.valid)
    weights = {k: v.clone() for k, v in
               create_train_state(online).model.state_dict().items()}
    draws = _draws(online, 6)
    states, fns = {}, {}
    for name, cfg in (("online", online), ("cached", cached)):
        states[name] = create_train_state(cfg, init_weights=False)
        states[name].model.load_state_dict(weights)
        fns[name] = make_train_step(cfg, seg_fn=seg_fn)
    ms = {"online": [], "cached": []}
    loss0, cached_launches = {}, {}
    for i in range(steps):
        for name, b in (("online", batch), ("cached", batch_c)):
            for fn in every:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[name], m = fns[name](states[name], b, 0.0, draws=draws)
            loss, items = m["loss"].item(), m["syn_items"].item()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            launches = {fn.__name__: fn.launches for fn in every}
            forwards = 3 if name == "online" else 2
            want = {"plane_sweep_diffs": 1, "swin_attn_fused": 24 * forwards,
                    "swin_mlp_fused": 24 * forwards,
                    "ms_deform_attn_core": 6 * forwards}
            for kernel, n in launches.items():
                check(n == want.get(kernel, 0), f"{name} hint step: {kernel} "
                      f"launched {n} times, not {want.get(kernel, 0)}")
            check(loss == loss and items > 0, f"{name} hint step {i}: loss "
                  f"{loss}, {items} items with a matched pair")
            loss0.setdefault(name, loss)
            if name == "cached":
                cached_launches = {k: cached_launches.get(k, 0) + n
                                   for k, n in launches.items()}
    gap = abs(loss0["cached"] - loss0["online"])
    # the first step of each carries its own warm-up
    saved = (statistics.median(ms["online"][1:])
             - statistics.median(ms["cached"][1:]))
    print(f"cached hint, fast mode, Config() 192x640 batch 12: first loss "
          f"cached {loss0['cached']!r}, online {loss0['online']!r} (rtol "
          f"{TEMPORAL_LOSS_RTOL}); step ms cached "
          f"{', '.join(f'{t:.2f}' for t in ms['cached'])}, online "
          f"{', '.join(f'{t:.2f}' for t in ms['online'])}; online - cached, "
          f"medians after the first step: {saved:.2f} ms ({card_line()}); "
          f"launches of the cached "
          f"steps {cached_launches}")
    check(gap <= TEMPORAL_LOSS_RTOL * abs(loss0["online"]),
          "the cached step's loss is not the online step's")
    return {"fast_cached": cached_launches}


def _segmenter_forward_ms(seg_fn, images, reps: int = 3) -> list[float]:
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg_fn(images)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def temporal_path_phase(steps: int, profile: bool, fast: bool):
    """The temporal hint with the full-width Swin-L Mask2Former: in exact
    fp32 (the unfused blocks around K4), or with `fast` in fast mode, this
    slice's main path (bf16 nets and payloads, every Swin block as K2 and
    K3). Returns the launches and the segmenter."""
    import torch

    from mal_tpu_torch.config import TRAIN_FAST_SETTINGS, Config
    from mal_tpu_torch.segment.mask2former import (Mask2Former, make_seg_fn,
                                                   resolve_fused_swin)
    from mal_tpu_torch.segment.matcher import match_instances
    from mal_tpu_torch.temporal import image_synthesis

    cfg = Config(temporal=True, ins_threshold=0.0,
                 **(TRAIN_FAST_SETTINGS if fast else {}))
    fused = resolve_fused_swin(cfg)
    check(fused == fast, f"resolve_fused_swin gave {fused} with fast={fast}")

    def build(bf16: bool, fused_swin: bool):
        seg = Mask2Former(generator=torch.Generator().manual_seed(1),
                          bf16_backbone=bf16, fused_swin=fused_swin)
        return seg, make_seg_fn(seg, cfg.max_instances)

    t0 = time.perf_counter()
    seg, seg_fn = build(fast, fused)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in seg.parameters())
    print(f"{'main path, fast mode' if fast else 'temporal path'}: "
          f"Config(temporal=True, ins_threshold=0.0"
          f"{', **TRAIN_FAST_SETTINGS' if fast else ''}) {cfg.height}x"
          f"{cfg.width} batch {cfg.batch_size}, {cfg.compute_dtype}; "
          f"Mask2Former Swin-L (bf16_backbone={fast}, fused_swin={fused}), "
          f"{n_params / 1e6:.1f} M parameters, built in "
          f"{time.perf_counter() - t0:.2f} s; {steps} steps + 1 eval")
    counters = _counted_wrappers()
    name = "profile_fast_step" if fast else "profile_temporal_step"
    launches, _, batch = run_path(cfg, steps, seg_fn, counters,
                                  name if profile else None)
    # per step: 3 segmenter forwards (the current frame, two warped
    # frames) of 24 Swin blocks and 6 deformable encoder layers
    blocks = 72 * steps
    want = {"plane_sweep_diffs": steps + 1, "plane_sweep_diffs_occ": 0,
            "swin_attn_fused": blocks if fused else 0,
            "swin_mlp_fused": blocks if fused else 0,
            "window_attention": 0 if fused else blocks,
            "ms_deform_attn_core": 18 * steps}
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times "
              f"on this path, not {n}")

    images = batch["color"]["0"]
    seg_ms = _segmenter_forward_ms(seg_fn, images)
    inst = seg_fn(images)
    check(tuple(inst.masks.shape) == (cfg.batch_size, cfg.max_instances,
                                      cfg.height, cfg.width),
          f"segmenter masks {tuple(inst.masks.shape)}")
    check(torch.isfinite(inst.scores).all().item(), "segmenter scores")
    print(f"segmenter forward at batch {cfg.batch_size}"
          f"{' (fused bf16)' if fast else ''}: "
          f"{', '.join(f'{t:.2f}' for t in seg_ms)} ms")

    # the synthesis on the adjacent frames, and its host-side matching
    frames = [batch["color"][f].permute(0, 3, 1, 2) for f in ("-1", "1")]
    others = [seg_fn(batch["color"][f]) for f in ("-1", "1")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    match_instances(*others, inst.threshold(cfg.ins_threshold))
    match_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, _, has = image_synthesis(
        *frames, inst, *others, cfg.ins_threshold,
        payload_dtype=torch.bfloat16 if fast else None)
    torch.cuda.synchronize()
    syn_ms = (time.perf_counter() - t0) * 1e3
    print(f"image_synthesis {syn_ms:.2f} ms ({has.sum().item()} items with a "
          f"matched pair), of which matching {match_ms:.2f} ms (the costs "
          f"copied to the host once, {cfg.batch_size * 2} assignments "
          f"solved there)")

    if fast:
        # the same weights in the other two forms of the segmenter, in turns
        del others, frames
        _, unfused_fn = build(True, False)
        _, fp32_fn = build(False, False)
        rows = {"fused bf16": seg_fn, "unfused bf16": unfused_fn,
                "fp32": fp32_fn, "fused bf16 again": seg_fn}
        for label, fn in rows.items():
            ms = _segmenter_forward_ms(fn, images)
            print(f"segmenter forward, {label}: "
                  f"{', '.join(f'{t:.2f}' for t in ms)} ms")
        exact = fp32_fn(images).masks
        for label, fn in (("fused bf16", seg_fn), ("unfused bf16", unfused_fn)):
            flips = (fn(images).masks != exact).float().mean().item()
            print(f"mask bits on which the {label} segmenter differs from "
                  f"the fp32 one (random weights): {flips:.3e} (max "
                  f"{FAST_VS_FP32_MAX_BIT_FLIPS})")
            check(flips <= FAST_VS_FP32_MAX_BIT_FLIPS,
                  f"the {label} segmenter's masks are far from the fp32 ones")
    return launches, seg_fn


def small_dualref_reference_phase() -> None:
    """One DualRefine step and one eval forward at 64x96 (batch 2, the
    method's defaults otherwise): GPU path against the CPU's plain path,
    from the same weights, batch and automask draws."""
    import torch

    from mal_tpu_torch.config import Config
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.dualref.step import noise_keys
    from mal_tpu_torch.models.mal_model import to_nchw
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    cfg = Config(method="dualrefine", height=64, width=96, batch_size=2)
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(4)
    noise = {k: torch.randn((2, 1, 64, 96), generator=g)
             for k in noise_keys(cfg)}
    res = {}
    for dev in ("cpu", "cuda"):
        b = _to(batch, dev)
        state = create_train_state(cfg, device=dev)
        step = make_train_step(cfg, device=dev)
        state, m = step(state, b, 0.0, draws={"automask_noise": {
            k: v.to(dev) for k, v in noise.items()}})
        color = to_nchw(b)["color"]
        with torch.no_grad():
            out, poses = state.model(color["0"], color["-1"], b["K"],
                                     invert=True, train=False)
        res[dev] = (m["loss"].item(), m["pose_loss"].item(),
                    out["disp_0_1"].cpu(), poses[1].cpu())
    (l_cpu, p_cpu, d_cpu, t_cpu), (l_gpu, p_gpu, d_gpu, t_gpu) = (
        res["cpu"], res["cuda"])
    d_err = (d_cpu - d_gpu).abs().max().item()
    t_err = (t_cpu - t_gpu).abs().max().item()
    print(f"small DualRefine reference (64x96, B=2): loss cpu {l_cpu:.6f} "
          f"gpu {l_gpu:.6f}, pose_loss cpu {p_cpu:.6f} gpu {p_gpu:.6f} "
          f"(rtol {DUALREF_LOSS_RTOL}); eval disp_0_1 max abs diff "
          f"{d_err:.3e}, T* {t_err:.3e}")
    check(abs(l_cpu - l_gpu) <= DUALREF_LOSS_RTOL * abs(l_cpu),
          "GPU DualRefine loss != CPU loss")
    check(abs(p_cpu - p_gpu) <= DUALREF_LOSS_RTOL * abs(p_cpu),
          "GPU DualRefine pose_loss != CPU pose_loss")
    check(d_err <= DUALREF_DISP_ATOL, "GPU eval disp_0_1 != CPU disp_0_1")
    check(t_err <= DUALREF_DISP_ATOL, "GPU eval T* != CPU T*")


def dualref_path_phase(steps: int, profile: bool, fast: bool,
                       counters: list) -> dict[str, dict[str, int]]:
    """DualRefine at `Config(method="dualrefine")` (192x640, batch 12,
    frames 0 / -1 / +1, HRNet-W18, Anderson with 6 evaluations), in exact
    fp32 or with `fast` in fast mode: `steps` steps on a seeded synthetic
    batch and one eval forward, with every kernel's count set to 0 just
    before and read just after (0 each), but the Gauss-Newton kernel's:
    8 forwards and 1 backward a step. In fp32 one more step then runs with
    the frozen optimizer of `freeze_teacher_epoch`, which must move the
    refinement student and nothing else."""
    import torch

    from mal_tpu_torch.config import TRAIN_FAST_SETTINGS, Config
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.models.mal_model import to_nchw
    from mal_tpu_torch.ops.cuda.gauss_newton import normal_equations as gn
    from mal_tpu_torch.train.state import create_train_state, make_optimizer
    from mal_tpu_torch.train.step import make_train_step
    from mal_tpu_torch.utils.profiling import idle_share

    cfg = Config(method="dualrefine", **(TRAIN_FAST_SETTINGS if fast else {}))
    name = "dualref_fast" if fast else "dualref"
    print(f"DualRefine path{', fast mode' if fast else ''}: Config(method="
          f"'dualrefine'{', **TRAIN_FAST_SETTINGS' if fast else ''}) "
          f"{cfg.height}x{cfg.width} batch {cfg.batch_size}, frames "
          f"{cfg.frame_ids}, HRNet-W{cfg.num_layers}, {cfg.deq_solver} "
          f"{cfg.deq_iters} evaluations, corr radius {cfg.corr_radius} x "
          f"{cfg.corr_levels} levels, {cfg.compute_dtype}; {steps} steps + "
          f"1 eval")
    t0 = time.perf_counter()
    state = create_train_state(cfg)
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = synthetic_batch(cfg, gen, "cuda")
    color = to_nchw(batch)["color"]
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.2f} s")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    gn.launches = gn.backward_launches = 0
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch, 0.0, gen)
        m = {k: v.item() for k, v in m.items()}
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        print(f"step {i}: loss {m['loss']!r} pose_loss {m['pose_loss']!r} "
              f"consistency {m['consistency_loss']!r} ({times[-1]:.2f} ms)")
        check(_finite(m), f"non-finite metrics at step {i}: {m}")
    gn_steps = (gn.launches, gn.backward_launches)
    check(gn_steps == (GN_FORWARDS * steps, GN_BACKWARDS * steps),
          f"Gauss-Newton kernel launches {gn_steps} in {steps} steps")
    t0 = time.perf_counter()
    with torch.no_grad():
        out, poses = state.model(color["0"], color["-1"], batch["K"],
                                 invert=True, train=False)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches for fn in counters}
    launches[gn.__name__] = gn.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    B, H, W = cfg.batch_size, cfg.height, cfg.width
    want = {"disp_0_0": (B, 1, H, W), "disp_0_1": (B, 1, H, W),
            "disp_2_1": (B, 1, H // 4, W // 4),
            "consistency_mask": (B, 1, H // 4, W // 4)}
    for k, shape in want.items():
        check(tuple(out[k].shape) == shape, f"eval {k} shape {out[k].shape}")
        check(torch.isfinite(out[k].float()).all().item(),
              f"eval {k} not finite")
    check(all(torch.isfinite(p).all().item() for p in poses),
          "eval poses not finite")
    steady = statistics.median(times[1:]) if steps > 1 else times[0]
    print(f"eval forward {eval_ms:.2f} ms; step ms (first {times[0]:.2f}, "
          f"median of the rest {steady:.2f}; {B * 1e3 / steady:.2f} frames/s)"
          f"; peak memory {peak:.2f} GiB; launches {launches} "
          f"({card_line()})")
    print(f"Gauss-Newton kernel: {gn_steps[0]} forwards and {gn_steps[1]} "
          f"backwards in {steps} steps, {gn.launches - gn_steps[0]} in the "
          f"eval forward")
    for fn in counters:
        check(launches[fn.__name__] == 0, f"{fn.__name__} launched "
              f"{launches[fn.__name__]} times on the DualRefine path")
    by_path = {name: launches}

    if profile:
        def one_step():
            nonlocal state
            state, _ = step(state, batch, 0.0, gen)

        _, _, prof = idle_share(one_step)
        os.makedirs("chiprun_out", exist_ok=True)
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        with open(f"chiprun_out/profile_{name}_step.txt", "w") as f:
            f.write(table)
        print(table[:6000])

    if not fast:
        # the freeze epoch's optimizer: only the refinement student moves
        student = ("conv2", "context", "hidden", "update_block")
        state.optimizer = make_optimizer(cfg, state.model,
                                         freeze_backbone=True)
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        for fn in counters:
            fn.launches = 0
        gn.launches = gn.backward_launches = 0
        state, m = step(state, batch, 0.0, gen)
        check(_finite({k: v.item() for k, v in m.items()}),
              "non-finite metrics in the frozen step")
        check((gn.launches, gn.backward_launches)
              == (GN_FORWARDS, GN_BACKWARDS),
              f"Gauss-Newton kernel launches {gn.launches} / "
              f"{gn.backward_launches} in the frozen step")
        by_path["dualref_frozen"] = {fn.__name__: fn.launches
                                     for fn in counters}
        moved = {n.split(".")[0] for n, p in state.model.named_parameters()
                 if not torch.equal(p, before[n])}
        print(f"frozen-optimizer step: moved {sorted(moved)}; launches "
              f"{by_path['dualref_frozen']}")
        check(moved == set(student), f"the frozen step moved {sorted(moved)}"
              f", not exactly {student}")
        check(not any(by_path["dualref_frozen"].values()),
              "a kernel launched in the frozen DualRefine step")
    return by_path


def dynamic_path_phase(steps: int, profile: bool, fast: bool,
                       counters: list) -> dict[str, int]:
    """DynamicDepth at its benchmark configuration, in exact fp32 or with
    `fast` in fast mode: K6 once per step and once per eval, nothing else."""
    from mal_tpu_torch.config import TRAIN_FAST_SETTINGS, Config
    from mal_tpu_torch.ops.cuda.cost_volume_kernel import plane_sweep_diffs_occ

    cfg = Config(**DYNAMIC, **(TRAIN_FAST_SETTINGS if fast else {}))
    print(f"DynamicDepth path{', fast mode' if fast else ''}: Config("
          f"method='dynamicdepth', cv_min, cv_set_1, cv_pool_th=0.15"
          f"{', **TRAIN_FAST_SETTINGS' if fast else ''}) {cfg.height}x"
          f"{cfg.width} batch {cfg.batch_size}, {cfg.num_depth_bins} bins, "
          f"ResNet-{cfg.num_layers}, {cfg.compute_dtype}, exact DOMD splat; "
          f"{steps} steps + 1 eval")
    name = "profile_dynamic_fast_step" if fast else "profile_dynamic_step"
    launches, _, _ = run_path(cfg, steps, None, counters,
                              name if profile else None)
    for fn in counters:
        want = steps + 1 if fn is plane_sweep_diffs_occ else 0
        check(launches[fn.__name__] == want, f"{fn.__name__} launched "
              f"{launches[fn.__name__]} times on this path, not {want}")
    return launches


DOJ_FAVOURED_CLASS = 2     # COCO's car, one of `DYNAMIC_COCO_CLASSES`


def online_doj_phase(steps: int, profile: bool, fast: bool,
                     counters: list) -> dict[str, int]:
    """DynamicDepth at its benchmark configuration with the online
    dynamic-object masks (`online_doj`): the frozen Swin-L Mask2Former
    (seeded random weights, `ins_threshold=0.0`, as random weights keep no
    instance at 0.9, and the class bias of `car` raised) makes `doj_mask`
    and `doj_mask-1` / `+1` in the step, one forward per frame of
    `frame_ids`. In fp32 each forward launches K4
    24 times (its 24 Swin blocks) and K5 6 times (its 6 deformable encoder
    layers); in fast mode K2 and K3 24 times each and K5 6 times; K6 once a
    step and once an eval."""
    import torch

    from mal_tpu_torch.config import TRAIN_FAST_SETTINGS, Config
    from mal_tpu_torch.segment.doj import make_doj_fn
    from mal_tpu_torch.segment.mask2former import (Mask2Former,
                                                   resolve_fused_swin)

    cfg = Config(**DYNAMIC, online_doj=True, ins_threshold=0.0,
                 **(TRAIN_FAST_SETTINGS if fast else {}))
    fused = resolve_fused_swin(cfg)
    check(fused == fast, f"resolve_fused_swin gave {fused} with fast={fast}")
    seg = Mask2Former(generator=torch.Generator().manual_seed(1),
                      bf16_backbone=fast, fused_swin=fused)
    # random weights give every query one class (here not a movable one,
    # so every mask would be empty): the class head's bias favours `car`
    with torch.no_grad():
        seg.sem_seg_head.predictor.class_embed.bias[DOJ_FAVOURED_CLASS] += 5.0
    doj_fn = make_doj_fn(seg, cfg.max_instances, cfg.ins_threshold)
    print(f"online doj path{', fast mode' if fast else ''}: Config("
          f"method='dynamicdepth', cv_min, cv_set_1, cv_pool_th=0.15, "
          f"online_doj=True, ins_threshold=0.0"
          f"{', **TRAIN_FAST_SETTINGS' if fast else ''}) {cfg.height}x"
          f"{cfg.width} batch {cfg.batch_size}, {cfg.compute_dtype}; "
          f"Mask2Former Swin-L (bf16_backbone={fast}, fused_swin={fused}); "
          f"{steps} steps + 1 eval ({card_line()})")
    name = "profile_doj_fast_step" if fast else "profile_doj_step"
    launches, _, batch = run_path(cfg, steps, None, counters,
                                  name if profile else None, doj_fn=doj_fn)
    forwards = len(cfg.frame_ids) * steps
    want = {"plane_sweep_diffs_occ": steps + 1,
            "swin_attn_fused": 24 * forwards if fused else 0,
            "swin_mlp_fused": 24 * forwards if fused else 0,
            "window_attention": 0 if fused else 24 * forwards,
            "ms_deform_attn_core": 6 * forwards}
    for fn in counters:
        n = want.get(fn.__name__, 0)
        check(launches[fn.__name__] == n, f"{fn.__name__} launched "
              f"{launches[fn.__name__]} times on this path, not {n}")
    masks = {f: doj_fn(batch["color"][f]) for f in ("0", "-1", "1")}
    share = {f: m.mean().item() for f, m in masks.items()}
    print(f"online doj masks, share of pixels per frame {share}; images "
          f"with a non-empty mask of frame 0: "
          f"{int((masks['0'].sum(dim=(1, 2)) > 0).sum())} of "
          f"{cfg.batch_size}")
    check(all(((m == 0) | (m == 1)).all().item() for m in masks.values()),
          "online doj masks are not binary")
    check(any(m.sum().item() > 0 for m in masks.values()),
          "the online doj masks are empty on every image")
    return launches


# data parallelism: two processes on the one card with gloo (NCCL takes
# one rank a GPU), the global batch of Config() split 6 / 6, or on a
# machine with more cards one NCCL process per card, against the
# one-process step on the whole batch from the same state and draws; the
# bounds of mal_tpu's mesh test (tests/test_parallel.py:50-74)
DP_STEPS = 2
DP_LOSS_RTOL = 2e-4
DP_BINS_RTOL = 1e-5
DP_PARAM_ATOL = 5e-5


def _counted_wrappers() -> list:
    """Every kernel wrapper that counts its launches, K1-K5b."""
    from mal_tpu_torch.ops.cuda.cost_volume_kernel import (
        plane_sweep_diffs, plane_sweep_diffs_occ)
    from mal_tpu_torch.ops.cuda.deform_sample import (deform_sample_fused,
                                                      ms_deform_attn_core)
    from mal_tpu_torch.ops.cuda.swin_block import (swin_attn_fused,
                                                   swin_mlp_fused)
    from mal_tpu_torch.ops.cuda.window_attention import window_attention

    return [plane_sweep_diffs, plane_sweep_diffs_occ, swin_attn_fused,
            swin_mlp_fused, window_attention, ms_deform_attn_core,
            deform_sample_fused]


def _split_collectives(step, state, batch, draws) -> dict:
    """One more step of a rank, each all-reduce and broadcast split into
    the wait for the other ranks (a barrier just before it) and the
    collective itself, both on the host clock with the card synchronized;
    the split step's own time includes the barriers and is not a step
    time."""
    import torch
    import torch.distributed as dist

    plain = {"all_reduce": dist.all_reduce, "broadcast": dist.broadcast}
    calls, wait_s, run_s = [0], [0.0], [0.0]

    def split(op):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.barrier()
            t1 = time.perf_counter()
            out = op(*args, **kwargs)
            torch.cuda.synchronize()
            calls[0] += 1
            wait_s[0] += t1 - t0
            run_s[0] += time.perf_counter() - t1
            return out
        return run

    for name, op in plain.items():
        setattr(dist, name, split(op))
    try:
        step(state, batch, 0.0, draws=draws)
        torch.cuda.synchronize()
    finally:
        for name, op in plain.items():
            setattr(dist, name, op)
    return {"collectives": calls[0], "collective_wait_ms": wait_s[0] * 1e3,
            "collective_ms": run_s[0] * 1e3}


def _timed_gather(step, state, batch, draws) -> dict:
    """One more step of a depth rank, its volume's gather timed: the share
    checked first (this rank's planes each hold some cost, every other
    plane is 0), then the wait for the row (a barrier on its group) and the
    gather itself, both on the host clock with the card synchronized."""
    import torch
    import torch.distributed as dist

    from mal_tpu_torch.ops import cost_volume
    from mal_tpu_torch.parallel import mesh

    plain = cost_volume.gather_planes
    rec = {}

    def timed(volume, group):
        torch.cuda.synchronize()
        _, index, n = mesh.depth_share()
        share = cost_volume.plane_share(volume.shape[1], index, n)
        outside = torch.ones(volume.shape[1], dtype=torch.bool)
        outside[share] = False
        rec["share_planes"] = int((volume[:, share].abs().amax(dim=(0, 2, 3))
                                   > 0).sum())
        rec["outside_max"] = volume[:, outside.cuda()].abs().max().item()
        t0 = time.perf_counter()
        dist.barrier(group=group)
        t1 = time.perf_counter()
        out = plain(volume, group)
        torch.cuda.synchronize()
        rec["gather_wait_ms"] = (t1 - t0) * 1e3
        rec["gather_ms"] = (time.perf_counter() - t1) * 1e3
        rec["gather_bytes"] = volume.numel() * volume.element_size()
        return out

    cost_volume.gather_planes = timed
    try:
        step(state, batch, 0.0, draws=draws)
        torch.cuda.synchronize()
    finally:
        cost_volume.gather_planes = plain
    return rec


def _dp_run(rank: int | None = None, world: int = 1, n_depth: int = 1
            ) -> dict:
    """`DP_STEPS` steps at `Config()` on the global batch (rank None) or on
    rank `rank`'s share of it in a group of `world` with `n_depth` ranks a
    depth row (the row's ranks take the same shard and split the volume's
    planes): the losses, bins and step ms of each step (a rank's steps
    start together, after a barrier), every kernel's launches a step, the
    parameters and buffers after the steps and, for a rank, one more
    step's collectives (`_split_collectives`) or, in a depth row, its
    volume's gather (`_timed_gather`)."""
    import torch
    import torch.distributed as dist

    from mal_tpu_torch.config import Config
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.parallel import distributed, mesh
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import check_parallel, make_train_step

    every = _counted_wrappers()
    cfg = Config()
    batch = synthetic_batch(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    draws = [_draws(cfg, 5 + i) for i in range(DP_STEPS)]
    local = cfg
    if rank is not None:
        cfg = cfg.replace(num_depth_shards=n_depth)
        check_parallel(cfg, world, global_batch=cfg.batch_size)
        g = distributed.grid(n_depth, world, rank)
        local = cfg.replace(batch_size=cfg.batch_size // g.n_data)
        batch = mesh.shard_batch(batch, g.data_index, g.n_data)
        draws = [mesh.shard_batch(d, g.data_index, g.n_data) for d in draws]
    # rank 1 starts from other weights: the broadcast gives it rank 0's
    state = create_train_state(local, generator=torch.Generator().manual_seed(
        1 if rank == 1 else 0))
    mesh.broadcast_state(state)
    step = make_train_step(local)
    out = {"loss": [], "bins": [], "ms": [], "launches": []}
    for i in range(DP_STEPS):
        for fn in every:
            fn.launches = 0
        torch.cuda.synchronize()
        if rank is not None:
            dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, batch, 0.0, draws=draws[i])
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append({fn.__name__: fn.launches for fn in every})
        out["loss"].append(m["loss"].item())
        out["bins"].append((state.bins.min_depth.item(),
                            state.bins.max_depth.item()))
    out["state"] = {k: v.cpu() for k, v in state.model.state_dict().items()}
    if rank is not None and n_depth > 1:
        out.update(_timed_gather(step, state, batch, draws[-1]))
    elif rank is not None:
        out.update(_split_collectives(step, state, batch, draws[-1]))
    return out


def _dyn_run(rank: int | None = None, world: int = 1, n_depth: int = 1
             ) -> dict:
    """One DynamicDepth step at its benchmark configuration with a global
    batch of DEPTH_DYN_BATCH, on the whole batch (rank None) or on rank
    `rank`'s share in a group of `world` with `n_depth` ranks a depth row,
    whose ranks are replicas (`mal_tpu` does not split DynamicDepth's
    volume either): the loss, ms, launches and the state after."""
    import torch

    from mal_tpu_torch.config import Config
    from mal_tpu_torch.data.synthetic import (synthetic_batch,
                                              synthetic_doj_masks)
    from mal_tpu_torch.parallel import distributed, mesh
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.train.step import make_train_step

    every = _counted_wrappers()
    cfg = Config(**{**DYNAMIC, "batch_size": DEPTH_DYN_BATCH})
    batch = synthetic_batch(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    batch.update(synthetic_doj_masks(cfg, "cuda"))
    draws = _draws(cfg, 11)
    local = cfg
    if rank is not None:
        cfg = cfg.replace(num_depth_shards=n_depth)
        g = distributed.grid(n_depth, world, rank)
        local = cfg.replace(batch_size=cfg.batch_size // g.n_data)
        batch = mesh.shard_batch(batch, g.data_index, g.n_data)
        draws = mesh.shard_batch(draws, g.data_index, g.n_data)
    state = create_train_state(local, generator=torch.Generator().manual_seed(
        1 if rank == 1 else 0))
    mesh.broadcast_state(state)
    step = make_train_step(local)
    for fn in every:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch, 0.0, draws=draws)
    torch.cuda.synchronize()
    return {"loss": m["loss"].item(), "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {fn.__name__: fn.launches for fn in every},
            "state": {k: v.cpu() for k, v in state.model.state_dict().items()}}


def dp_rank_main(rank: int, out_dir: str) -> int:
    """A rank of `data_parallel_phase` or `depth_axis_phase` (its group as
    `setup.json` in `out_dir` says): `_dp_run` (and in a depth row
    `_dyn_run`, and on rank 0 K1 on its share of the planes), its results
    written to `out_dir`."""
    import torch

    from mal_tpu_torch.parallel import distributed

    with open(os.path.join(out_dir, "setup.json")) as f:
        setup = json.load(f)
    n_depth = setup.get("n_depth", 1)
    device = torch.device("cuda", rank if setup["nccl"] else 0)
    distributed.initialize(f"file://{os.path.join(out_dir, 'rendezvous')}",
                           setup["world"], rank,
                           backend="nccl" if setup["nccl"] else "gloo",
                           device=device)
    try:
        out = _dp_run(rank, setup["world"], n_depth)
        if n_depth > 1:
            torch.cuda.empty_cache()
            out["dynamic"] = _dyn_run(rank, setup["world"], n_depth)
            if rank == 0:
                out["k1_share"] = k1_share_check(n_depth)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


def _spawn_ranks(world: int, nccl: bool, n_depth: int = 1) -> list:
    """`world` ranks of this script (`--dp-rank r`), their results read
    back; a rank that fails fails the phase."""
    import shutil

    import torch

    out_dir = os.path.abspath(os.path.join("build", "chip_smoke_dp"))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with open(os.path.join(out_dir, "setup.json"), "w") as f:
        json.dump({"world": world, "nccl": nccl, "n_depth": n_depth}, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dp-rank", str(r), "--dp-dir", out_dir])
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0] * world, f"ranks exited with {rcs}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
             for r in range(world)]
    shutil.rmtree(out_dir, ignore_errors=True)
    return ranks


def _hold_ranks(what: str, ranks: list, ref: dict) -> None:
    """The ranks' states equal bit for bit, and rank 0's losses, bins and
    parameters and buffers against the one-process run `ref` (DP_LOSS_RTOL,
    DP_BINS_RTOL, DP_PARAM_ATOL)."""
    import torch

    a = ranks[0]
    for r, other in enumerate(ranks[1:], start=1):
        for k, v in a["state"].items():
            check(torch.equal(v, other["state"][k]),
                  f"{what}: rank {r}'s {k} differs from rank 0's")
    for i in range(len(ref["loss"])):
        check(abs(a["loss"][i] - ref["loss"][i])
              <= DP_LOSS_RTOL * abs(ref["loss"][i]), f"{what}: step {i} loss")
        for g, w in zip(a["bins"][i], ref["bins"][i]):
            check(abs(g - w) <= DP_BINS_RTOL * abs(w),
                  f"{what}: step {i} bins")
    gap = max((v.double() - ref["state"][k].double()).abs().max().item()
              for k, v in a["state"].items() if v.is_floating_point())
    print(f"{what} against one process: largest parameter or buffer "
          f"difference after {len(ref['loss'])} steps {gap:.3e} (at most "
          f"{DP_PARAM_ATOL})")
    check(gap <= DP_PARAM_ATOL, f"{what}: the state left the one-process "
          f"state")


def data_parallel_phase(world: int = 2, nccl: bool = False
                        ) -> dict[str, dict[str, int]]:
    """`world` ranks, spawned here, each with its share of `Config()`'s
    global batch of 12: gloo on cuda:0, or with `nccl` rank r on cuda:r;
    against the one-process step on the whole batch on cuda:0, run first
    and alone, `DP_STEPS` steps from the same state and draws: the loss
    (2e-4 relative), the bins (1e-5), every parameter and buffer after the
    steps (5e-5 absolute); the ranks' states equal bit for bit; K1 once a
    step on each rank and every other kernel 0. A rank that fails fails
    the phase."""
    import torch

    ref = _dp_run()
    torch.cuda.empty_cache()
    ranks = _spawn_ranks(world, nccl)
    card = card_line()
    where = (f"NCCL, cuda:0-{world - 1}" if nccl
             else f"gloo, all {world} on cuda:0")
    want = {fn.__name__: int(fn.__name__ == "plane_sweep_diffs")
            for fn in _counted_wrappers()}
    print(f"one process, batch 12 (run alone): losses {ref['loss']}, bins "
          f"{ref['bins']}, step ms "
          f"{', '.join(f'{t:.2f}' for t in ref['ms'])} ({card})")
    for r, got in enumerate(ranks):
        print(f"data parallel, rank {r} of {world} ({where}, batch "
              f"{12 // world} of 12): losses {got['loss']}, bins "
              f"{got['bins']}, step ms (after a barrier) "
              f"{', '.join(f'{t:.2f}' for t in got['ms'])}; one more step: "
              f"{got['collectives']} collectives, "
              f"{got['collective_ms']:.2f} ms in them and "
              f"{got['collective_wait_ms']:.2f} ms waiting for the other "
              f"ranks before them (barriers; host clock, card synchronized)"
              f" ({card})")
        for i, n in enumerate(got["launches"]):
            check(n == want, f"rank {r} step {i}: launches {n}, not {want}")
    _hold_ranks("data parallel", ranks, ref)
    return {f"dp{'_nccl' if nccl else ''}_rank{r}":
            {k: sum(n[k] for n in got["launches"]) for k in want}
            for r, got in enumerate(ranks)}


DEPTH_SHARDS = 2
# DynamicDepth's replica step in the depth phase: its benchmark
# configuration with a global batch that every data width of the phase
# (1, 2, 3, 4, 6 or 12 shards) divides
DEPTH_DYN_BATCH = 12


def k1_share_check(n_depth: int) -> dict:
    """K1 on depth rank 0's share of `Config()`'s 96 planes (48 for two
    ranks) at the main path's other shapes, against its plain version and
    timed, as `k1_phase` holds the 96-plane launch."""
    from mal_tpu_torch.ops.cost_volume import plane_share

    cur, lookup, M, t, bins = k1_inputs()
    share = plane_share(bins.shape[0], 0, n_depth)
    return _k1_measure(f"K1 (depth share 0 of {n_depth})", cur, lookup, M, t,
                       bins[share].contiguous())


def depth_axis_phase(world: int = 2, nccl: bool = False
                     ) -> tuple[dict[str, dict[str, int]], dict]:
    """The depth axis at `Config()` (192x640, batch 12, 96 planes):
    `world` ranks as world / 2 data shards x 2 depth ranks (gloo on cuda:0,
    or with `nccl` rank r on cuda:r), each depth row holding one shard of
    the global batch of 12 and splitting the volume's planes, against the
    one-process step run alone first: `DP_STEPS` steps, the loss (2e-4
    relative), the bins (1e-5), every parameter and buffer (5e-5); the
    ranks equal bit for bit; K1 once a step on each rank, on its 48 planes
    (its volume's other planes 0 before the gather) and every other kernel
    0; each rank's step ms and the ms of one step's gather. Then one
    DynamicDepth step in the same layout, the depth ranks replicas: K6
    once on each rank, the loss against one process's. On rank 0, K1 on
    its 48-plane share against its plain version, timed. Returns the
    launches by path and the share's K1 record."""
    import torch

    n_depth = DEPTH_SHARDS
    ref = _dp_run()
    ref_dyn = _dyn_run()
    torch.cuda.empty_cache()
    ranks = _spawn_ranks(world, nccl, n_depth)
    card = card_line()
    n_data = world // n_depth
    where = (f"NCCL, cuda:0-{world - 1}" if nccl
             else f"gloo, all {world} on cuda:0")
    names = [fn.__name__ for fn in _counted_wrappers()]
    want = {k: int(k == "plane_sweep_diffs") for k in names}
    want_dyn = {k: int(k == "plane_sweep_diffs_occ") for k in names}
    planes = 96 // n_depth
    print(f"one process, batch 12 (run alone): losses {ref['loss']}, bins "
          f"{ref['bins']}, step ms "
          f"{', '.join(f'{t:.2f}' for t in ref['ms'])}; DynamicDepth batch "
          f"{DEPTH_DYN_BATCH}: loss {ref_dyn['loss']}, "
          f"{ref_dyn['ms']:.2f} ms ({card})")
    for r, got in enumerate(ranks):
        g_data, g_depth = divmod(r, n_depth)
        print(f"depth axis, rank {r} of {world} ({where}; data shard "
              f"{g_data} of {n_data}, batch {12 // n_data}; depth share "
              f"{g_depth} of {n_depth}, {got['share_planes']} planes): "
              f"losses {got['loss']}, bins {got['bins']}, step ms (after a "
              f"barrier) {', '.join(f'{t:.2f}' for t in got['ms'])}; one "
              f"more step: gather {got['gather_ms']:.3f} ms of "
              f"{got['gather_bytes'] / 2 ** 20:.1f} MiB after "
              f"{got['gather_wait_ms']:.3f} ms waiting for the row (barrier; "
              f"host clock, card synchronized); DynamicDepth replica step "
              f"loss {got['dynamic']['loss']}, {got['dynamic']['ms']:.2f} ms"
              f" ({card})")
        for i, n in enumerate(got["launches"]):
            check(n == want, f"depth rank {r} step {i}: launches {n}, not "
                  f"{want}")
        check(got["share_planes"] == planes and got["outside_max"] == 0.0,
              f"depth rank {r}: its volume held {got['share_planes']} "
              f"planes (not {planes}), {got['outside_max']} outside them")
        check(got["dynamic"]["launches"] == want_dyn,
              f"depth rank {r} DynamicDepth: launches "
              f"{got['dynamic']['launches']}, not {want_dyn}")
    _hold_ranks("depth axis", ranks, ref)
    _hold_ranks("depth axis, DynamicDepth replicas",
                [{"loss": [x["dynamic"]["loss"]], "bins": [()],
                  "state": x["dynamic"]["state"]} for x in ranks],
                {"loss": [ref_dyn["loss"]], "bins": [()],
                 "state": ref_dyn["state"]})
    tag = "_nccl" if nccl else ""
    by_path = {}
    for r, got in enumerate(ranks):
        by_path[f"depth{tag}_rank{r}"] = {
            k: sum(n[k] for n in got["launches"]) for k in names}
        by_path[f"depth{tag}_dynamic_rank{r}"] = got["dynamic"]["launches"]
    share = dict(ranks[0]["k1_share"], launches_per_step_per_rank=1,
                 step_ms_rank0=ranks[0]["ms"],
                 gather_ms_rank0=ranks[0]["gather_ms"])
    return by_path, share


# the CLI phase's fake KITTI tree: 36 training lines (3 steps at batch 12),
# 24 test lines (2 validation batches), and two shorter training splits
# for the 2-step runs (24 lines at batch 12, 28 at DynamicDepth's 14)
CLI_TRAIN_LINES, CLI_TEST_LINES = 36, 24
CLI_SPLITS = {"smoke_24": 24, "smoke_28": 28}
CLI_ABS_REL_ATOL = 1e-6   # the checkpoint and its .pth export, evaluated
DYN_CLI = ["method='dynamicdepth'", "height=192", "width=512",
           "batch_size=14", "cv_min=True", "cv_set_1=True",
           "cv_pool_th=0.15"]


def _write_cli_tree() -> dict:
    """The fake KITTI tree in the working directory, the short splits, and
    dynamic-object masks for the test lines as `.npy` files."""
    import numpy as np

    from mal_tpu_torch.data.synthetic import KITTI_DRIVE, write_fake_kitti

    paths = write_fake_kitti(".", CLI_TRAIN_LINES, CLI_TEST_LINES, seed=0)
    with open(paths["eigen_zhou"]) as f:
        lines = f.readlines()
    for name, n in CLI_SPLITS.items():
        os.makedirs(os.path.join("splits", name))
        with open(os.path.join("splits", name, "train_files.txt"), "w") as f:
            f.writelines(lines[:n])
    os.makedirs("doj")
    mask = np.zeros((375, 1242), np.float32)
    mask[200:330, 300:700] = 1.0
    key = KITTI_DRIVE.replace("/", "_")
    for i in range(1, CLI_TEST_LINES + 1):
        for suffix in ("", "-1", "+1"):
            np.save(os.path.join("doj", f"{key}_{i}_l{suffix}.npy"), mask)
    return paths


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _finite(d: dict) -> bool:
    return all(isinstance(v, float) and v == v and abs(v) != float("inf")
               for v in d.values())


def _steps_ms(trainer) -> str:
    ms = [t * 1e3 for t in trainer.step_s]
    wait = [t * 1e3 for t in trainer.loader_wait_s]
    return (f"step ms (host clock, loader wait to the step's fetched "
            f"metrics) {', '.join(f'{t:.2f}' for t in ms)}; of which "
            f"waiting on the loader {', '.join(f'{t:.2f}' for t in wait)}")


def cli_phase(profile: bool, every: list) -> dict[str, dict[str, int]]:
    """The port driven only through `mal_tpu_torch.cli.main`, in a fake
    KITTI tree of seeded 1242x375 JPEGs under `build/chip_smoke_cli` (the
    working directory of the phase, with its own `splits/`): ManyDepth
    `train` at the recipe (`--preset kitti`, fast mode, 3 steps, one
    validation, one checkpoint), `eval` of the checkpoint, `export-pth`,
    `eval` of the `.pth` directory (abs_rel within 1e-6), `train --seg_pkl`
    with the temporal hint (2 steps), DynamicDepth `train` (2 steps, one
    validation) and its `eval --doj_root`; after the hint's run,
    `export-seg` of its split, a rerun, and `train` from that cache. Each
    command runs with every kernel's count set to 0 just before and read
    just after."""
    import shutil

    import torch

    from mal_tpu_torch.cli import main as cli
    from mal_tpu_torch.convert.mask2former import export_mask2former_pkl
    from mal_tpu_torch.data import native
    from mal_tpu_torch.data.synthetic import synthetic_batch
    from mal_tpu_torch.device import batch_to_device
    from mal_tpu_torch.segment.mask2former import Mask2Former
    from mal_tpu_torch.utils.profiling import idle_share

    t_phase = time.perf_counter()
    root = os.path.abspath(os.path.join("build", "chip_smoke_cli"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cwd = os.getcwd()
    by_path: dict[str, dict[str, int]] = {}

    def counted(name: str, argv: list[str], want: dict[str, int]):
        for fn in every:
            fn.launches = 0
        out = cli(argv)
        by_path[name] = {fn.__name__: fn.launches for fn in every}
        print(f"{name}: launches {by_path[name]}")
        for kernel in by_path[name]:
            n = want.get(kernel, 0)
            check(by_path[name][kernel] == n, f"{name}: {kernel} launched "
                  f"{by_path[name][kernel]} times, not {n}")
        return out

    try:
        os.chdir(root)
        t0 = time.perf_counter()
        paths = _write_cli_tree()
        print(f"CLI phase: fake KITTI tree ({CLI_TRAIN_LINES} training and "
              f"{CLI_TEST_LINES} test lines of 1242x375 JPEGs, GT depths, "
              f"doj masks) in {time.perf_counter() - t0:.2f} s")
        common = ["--data_path", paths["data_path"], "--gt", paths["gt"]]

        # ManyDepth at the recipe's full width, fast mode by the CLI's default
        val_batches = -(-CLI_TEST_LINES // 12)
        trainer = counted(
            "cli_train", ["train", "--preset", "kitti", *common, "--set",
                          "num_epochs=1", "validate_every=2",
                          "validate_from=0", "save_until=0", "log_every=1",
                          "ckpt_dir='ck'"],
            {"plane_sweep_diffs": 3 + val_batches})
        cfg = trainer.cfg
        check((cfg.height, cfg.width, cfg.batch_size, cfg.num_depth_bins,
               cfg.num_layers, cfg.compute_dtype)
              == (192, 640, 12, 96, 18, "bfloat16"),
              f"train ran another configuration: {cfg}")
        check(trainer.step == 3, f"train took {trainer.step} steps, not 3")
        print(f"loader: {type(trainer.train_loader).__name__}; native "
              f"library built: {native.available()}"
              f"{'' if native.available() else ': ' + str(native.build_error())}")
        print(f"cli train: {_steps_ms(trainer)}")
        val = {k: v for _, m in trainer.logger.history for k, v in m.items()
               if k.startswith("val/")}
        check(len(val) >= 7 and _finite(val), f"validation metrics {val}")
        print(f"validation at step 2: {json.dumps(val)}")

        # the same state and step function on a synthetic batch already on
        # the card: the step without the loader
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = synthetic_batch(cfg, gen, "cuda")
        syn_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = trainer.step_fn(trainer.state, batch, 0.0, gen)
            check(_finite({k: float(v) for k, v in metrics.items()}),
                  "non-finite synthetic-batch metrics")
            syn_ms.append((time.perf_counter() - t0) * 1e3)
        cli_ms = statistics.median(t * 1e3 for t in trainer.step_s[1:])
        syn = statistics.median(syn_ms[1:])
        print(f"synthetic-batch steps, same state and step: "
              f"{', '.join(f'{t:.2f}' for t in syn_ms)} ms; frames/s through "
              f"the CLI {cfg.batch_size * 1e3 / cli_ms:.2f} (median step "
              f"{cli_ms:.2f} ms), on the synthetic batch "
              f"{cfg.batch_size * 1e3 / syn:.2f} ({syn:.2f} ms)")
        if profile:
            it = trainer.train_loader.epoch(1)

            def trainer_step():
                host = next(it)
                b = batch_to_device(host, trainer.device)
                _, m = trainer.step_fn(trainer.state, b, 1.0,
                                       trainer.generator)
                float(m["loss"])
            trainer_step()        # the prefetch running, as in a loop
            print("a trainer step (loader, copy to the card, step, "
                  "metrics), profiled:")
            prof = idle_share(trainer_step)[2]
            print(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=20)[:4000])
            it.close()

        # the checkpoint, its reference-layout export, both evaluated in
        # exact fp32
        ckpt = os.path.join("ck", f"{cfg.model_name}_s2")
        ours = counted("cli_eval", ["eval", *common, "--ckpt", ckpt, "--set",
                                    "compute_dtype='float32'",
                                    "cv_mxu_precision='highest'"],
                       {"plane_sweep_diffs": val_batches})
        cli(["export-pth", "--ckpt", ckpt, "--out", "pth"])
        ref = counted("cli_eval_pth", ["eval", *common, "--ckpt", "pth"],
                      {"plane_sweep_diffs": val_batches})
        check(_finite(ours) and _finite(ref), "non-finite eval metrics")
        gap = abs(ours["abs_rel"] - ref["abs_rel"])
        print(f"eval abs_rel: checkpoint {ours['abs_rel']!r}, .pth export "
              f"{ref['abs_rel']!r} (difference {gap:.3e}, at most "
              f"{CLI_ABS_REL_ATOL})")
        check(gap <= CLI_ABS_REL_ATOL, "checkpoint and .pth export disagree")

        # the temporal hint with a segmenter from a .pkl
        t0 = time.perf_counter()
        seg = Mask2Former(generator=torch.Generator().manual_seed(1))
        export_mask2former_pkl(seg, "seg.pkl")
        del seg
        print(f"Swin-L Mask2Former .pkl written in "
              f"{time.perf_counter() - t0:.2f} s "
              f"({os.path.getsize('seg.pkl') / 2 ** 20:.0f} MiB)")
        steps = CLI_SPLITS["smoke_24"] // 12
        trainer = counted(
            "cli_temporal", ["train", "--data_path", paths["data_path"],
                             "--no_eval", "--seg_pkl", "seg.pkl", "--set",
                             "split='smoke_24'", "temporal=True",
                             "ins_threshold=0.0", "num_epochs=1",
                             "log_every=1", "ckpt_dir='ckt'"],
            {"plane_sweep_diffs": steps, "swin_attn_fused": 72 * steps,
             "swin_mlp_fused": 72 * steps, "ms_deform_attn_core": 18 * steps})
        check(trainer.step == steps, f"temporal train took {trainer.step} "
              f"steps, not {steps}")
        check(all(m["syn_items"] > 0 for _, m in trainer.logger.history),
              "a temporal step had no matched pair")
        online_ms = _steps_ms(trainer)
        print(f"cli temporal train: {online_ms}")
        del trainer

        # the instance cache of the same split: exported in the preset's
        # exact fp32 (K4 and K5 in each forward of batch 12), a rerun that
        # finds every file, then the hint trained from the cache
        with open(os.path.join("splits", "smoke_24", "train_files.txt")) as f:
            files = 2 * len({line.strip() for line in f if line.strip()})
        forwards = -(-files // 12)
        export = ["export-seg", "--data_path", paths["data_path"],
                  "--seg_pkl", "seg.pkl", "--out", "segcache", "--set",
                  "split='smoke_24'"]
        t0 = time.perf_counter()
        n = counted("cli_export_seg", export,
                    {"window_attention": 24 * forwards,
                     "ms_deform_attn_core": 6 * forwards})
        export_s = time.perf_counter() - t0
        check(n == files == len(os.listdir("segcache")),
              f"export-seg wrote {n} files, not {files}")
        t0 = time.perf_counter()
        n = counted("cli_export_seg_again", export, {})
        again_s = time.perf_counter() - t0
        check(n == 0, f"the rerun of export-seg wrote {n} files")
        print(f"cli export-seg, fp32, Swin-L, batch 12: {files} files in "
              f"{forwards} forwards, {export_s:.2f} s; the rerun (loading "
              f"the segmenter, writing nothing) {again_s:.2f} s; "
              f"{(export_s - again_s) / files:.4f} s a frame and orientation "
              f"beyond the load ({card_line()})")
        trainer = counted(
            "cli_cached", ["train", "--data_path", paths["data_path"],
                           "--no_eval", "--seg_pkl", "seg.pkl", "--set",
                           "split='smoke_24'", "temporal=True",
                           "ins_threshold=0.0", "seg_cache_root='segcache'",
                           "num_epochs=1", "log_every=1", "ckpt_dir='ckc'"],
            {"plane_sweep_diffs": steps, "swin_attn_fused": 48 * steps,
             "swin_mlp_fused": 48 * steps, "ms_deform_attn_core": 12 * steps})
        check(trainer.step == steps, f"cached temporal train took "
              f"{trainer.step} steps, not {steps}")
        check(all(m["syn_items"] > 0 for _, m in trainer.logger.history),
              "a cached temporal step had no matched pair")
        print(f"cli cached temporal train: {_steps_ms(trainer)}; beside the "
              f"online hint's: {online_ms} ({card_line()})")
        del trainer

        # DynamicDepth at its benchmark configuration, then eval with masks
        steps = CLI_SPLITS["smoke_28"] // 14
        trainer = counted(
            "cli_dynamic", ["train", *common, "--set", "split='smoke_28'",
                            *DYN_CLI, "num_epochs=1", "validate_every=1",
                            "validate_from=0", "save_until=0",
                            "log_every=1", "ckpt_dir='ckd'"],
            {"plane_sweep_diffs_occ": steps + CLI_TEST_LINES})
        check(trainer.step == steps, f"dynamic train took {trainer.step} "
              f"steps, not {steps}")
        print(f"cli dynamic train: {_steps_ms(trainer)}")
        del trainer
        dyn = counted("cli_dynamic_eval",
                      ["eval", *common, "--ckpt",
                       os.path.join("ckd", f"{cfg.model_name}_s1"),
                       "--doj_root", "doj"],
                      {"plane_sweep_diffs_occ": CLI_TEST_LINES})
        check(_finite(dyn) and dyn["doj_batches"] > 0,
              f"dynamic eval metrics {dyn}")
        print(f"dynamic eval: abs_rel {dyn['abs_rel']!r}, doj/abs_rel "
              f"{dyn['doj/abs_rel']!r}, mono_doj/abs_rel "
              f"{dyn['mono_doj/abs_rel']!r}, {dyn['doj_batches']:.0f} images "
              f"with doj pixels")

        # DynamicDepth with the online masks of the .pkl's segmenter (fast
        # mode: K2 / K3 / K5 in each of a step's three forwards)
        forwards = 3 * steps
        trainer = counted(
            "cli_online_doj", ["train", "--data_path", paths["data_path"],
                               "--no_eval", "--seg_pkl", "seg.pkl", "--set",
                               "split='smoke_28'", *DYN_CLI,
                               "online_doj=True", "ins_threshold=0.0",
                               "num_epochs=1", "log_every=1",
                               "ckpt_dir='ckj'"],
            {"plane_sweep_diffs_occ": steps,
             "swin_attn_fused": 24 * forwards,
             "swin_mlp_fused": 24 * forwards,
             "ms_deform_attn_core": 6 * forwards})
        check(trainer.step == steps, f"online doj train took {trainer.step} "
              f"steps, not {steps}")
        print(f"cli online doj train: {_steps_ms(trainer)} ({card_line()})")
        del trainer

        # a one-process NCCL group through the data-parallel flags, beside
        # the same command without them: the flags and the group's set-up
        # only, since at world 1 every reduction is the plain operation and
        # no collective runs (counted here)
        import torch.distributed as dist

        plain = {"all_reduce": dist.all_reduce, "broadcast": dist.broadcast}
        collectives = [0]

        def tally(op):
            def run(*args, **kwargs):
                collectives[0] += 1
                return op(*args, **kwargs)
            return run

        runs = {}
        for name, flags in (
                ("cli_nccl_1", ["--coordinator", f"127.0.0.1:{_free_port()}",
                                "--num_hosts", "1", "--host_id", "0"]),
                ("cli_no_group", [])):
            for op_name, op in plain.items():
                setattr(dist, op_name, tally(op))
            try:
                trainer = counted(
                    name, ["train", "--data_path", paths["data_path"],
                           "--no_eval", *flags, "--set", "num_epochs=1",
                           "log_every=1", "ckpt_dir='ckn'"],
                    {"plane_sweep_diffs": 3})
            finally:
                for op_name, op in plain.items():
                    setattr(dist, op_name, op)
            check(trainer.step == 3, f"{name} took {trainer.step} steps")
            runs[name] = _steps_ms(trainer)
            del trainer
        check(collectives[0] == 0, f"{collectives[0]} collectives at world 1")
        print(f"cli train, 3 steps at the recipe: in a 1-process NCCL group "
              f"(0 collectives) {runs['cli_nccl_1']}; without the flags "
              f"{runs['cli_no_group']} ({card_line()})")

        # DualRefine at the recipe's width (fast mode by the CLI's
        # default): 2 steps, one validation, the end-of-epoch checkpoint
        # only (`save_until` past the run), then eval of it in fp32, its
        # depth_pose.pth and eval of that; no kernel on any of these
        steps = CLI_SPLITS["smoke_24"] // 12
        trainer = counted(
            "cli_dualref", ["train", *common, "--set", "split='smoke_24'",
                            "method='dualrefine'", "num_epochs=1",
                            "validate_every=1", "validate_from=0",
                            "save_until=100", "log_every=1",
                            "ckpt_dir='ckr'"], {})
        check(trainer.step == steps, f"dualrefine train took {trainer.step} "
              f"steps, not {steps}")
        losses = [m for _, m in trainer.logger.history if "loss" in m]
        check(len(losses) == steps and all(_finite(m) for m in losses),
              f"dualrefine train metrics {losses}")
        val = {k: v for _, m in trainer.logger.history for k, v in m.items()
               if k.startswith("val/")}
        check(len(val) >= 7 and _finite(val), f"dualrefine validation {val}")
        check(sorted(os.listdir("ckr")) == ["mal_e0", "metrics.jsonl"],
              f"dualrefine checkpoints {sorted(os.listdir('ckr'))}")
        print(f"cli dualrefine train: {_steps_ms(trainer)}; validation "
              f"abs_rel {val['val/abs_rel']!r}")
        del trainer
        ckpt = os.path.join("ckr", f"{cfg.model_name}_e0")
        ours = counted("cli_dualref_eval",
                       ["eval", *common, "--ckpt", ckpt, "--set",
                        "compute_dtype='float32'"], {})
        cli(["export-pth", "--ckpt", ckpt, "--out", "pthr"])
        check(os.listdir("pthr") == ["depth_pose.pth"],
              f"dualrefine export wrote {os.listdir('pthr')}")
        ref = counted("cli_dualref_eval_pth",
                      ["eval", *common, "--ckpt", "pthr", "--set",
                       "method='dualrefine'"], {})
        check(_finite(ours) and _finite(ref), "non-finite dualrefine eval")
        gap = abs(ours["abs_rel"] - ref["abs_rel"])
        print(f"dualrefine eval abs_rel: checkpoint {ours['abs_rel']!r}, "
              f"depth_pose.pth {ref['abs_rel']!r} (difference {gap:.3e}, at "
              f"most {CLI_ABS_REL_ATOL})")
        check(gap <= CLI_ABS_REL_ATOL,
              "dualrefine checkpoint and depth_pose.pth disagree")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    print(f"CLI phase wall time {time.perf_counter() - t_phase:.2f} s")
    return by_path


# segmenter fine-tuning and inference (the `finetune-seg` path)
SEG_FT_LOSS_RTOL = 1e-3   # the small Swin-T train loss, GPU against CPU
# the full-width fine-tuning run: `finetune-seg`'s defaults at Swin-L
FT_IMAGES, FT_BATCH, FT_QUERIES, FT_INSTANCES = 6, 2, 100, 16
FT_HEIGHT, FT_WIDTH = 256, 448
FT_STEPS = FT_IMAGES // FT_BATCH
# a Swin-L Mask2Former forward: 24 blocks (K4 each) and 6 deformable
# encoder layers (K5 each)
K4_A_FORWARD, K5_A_FORWARD = 24, 6
TTA_SCALES = (0.75, 1.0, 1.25)


def _stacked_draws(layers: int, B: int, T: int, num_points: int, seed: int):
    import torch

    from mal_tpu_torch.segment.criterion import CriterionConfig, draw_points

    return draw_points(CriterionConfig(num_points=num_points), layers, B, T,
                       torch.Generator().manual_seed(seed))


def small_finetune_reference_phase(every: list) -> None:
    """The fine-tuning loss of a Swin-T Mask2Former (5 classes, 8 queries,
    64x96, batch 2, 3 targets with one padded, 64 points, drop-path 0) on
    the card against the port on the CPU: the same weights, batch and
    injected points; every loss term within `SEG_FT_LOSS_RTOL`, every
    kernel count 0 in the training forward (the `train` flag takes the
    plain versions)."""
    import torch

    from mal_tpu_torch.segment.criterion import CriterionConfig
    from mal_tpu_torch.segment.mask2former import (Mask2Former,
                                                   mask2former_train_loss)

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(7)
    B, T, H, W, K, P = 2, 3, 64, 96, 5, 64
    images = torch.rand((B, H, W, 3), generator=g)
    labels = torch.randint(0, K, (B, T), generator=g)
    masks = torch.zeros((B, T, H, W))
    for b in range(B):
        for t in range(T):
            y, x = 8 * (b + t), 10 * (t + 1)
            masks[b, t, y:y + 16 + 4 * t, x:x + 20] = 1.0
    valid = torch.tensor([[True, True, True], [True, True, False]])
    draws = _stacked_draws(10, B, T, P, 8)
    cfg = CriterionConfig(num_classes=K, num_points=P)
    res = {}
    for dev in ("cpu", "cuda"):
        model = Mask2Former(num_classes=K, swin_size="tiny", num_queries=8,
                            device=dev, generator=torch.Generator()
                            .manual_seed(1), bgr_input=False,
                            drop_path_rate=0.0).requires_grad_(True)
        for fn in every:
            fn.launches = 0
        total, losses = mask2former_train_loss(
            model, images.to(dev), labels.to(dev), masks.to(dev),
            valid.to(dev), cfg,
            draws=[{k: v.to(dev) for k, v in d.items()} for d in draws])
        total.backward()
        launches = {fn.__name__: fn.launches for fn in every}
        check(not any(launches.values()),
              f"the training forward launched kernels: {launches}")
        res[dev] = {k: v.item() for k, v in losses.items()}
        res[dev]["total"] = total.item()
    worst = max(abs(res["cuda"][k] - v) / abs(v) for k, v in res["cpu"].items())
    print(f"small fine-tuning reference (Swin-T, 64x96, B=2, Q=8, 10 layers "
          f"of losses): total cpu {res['cpu']['total']:.6f} gpu "
          f"{res['cuda']['total']:.6f}; largest relative difference of the "
          f"{len(res['cpu'])} terms {worst:.2e} (rtol {SEG_FT_LOSS_RTOL}); "
          f"no kernel launched; {time.perf_counter() - t_phase:.2f} s")
    check(worst <= SEG_FT_LOSS_RTOL, "GPU fine-tuning loss != CPU loss")


def finetune_phase(every: list) -> dict[str, dict[str, int]]:
    """`finetune-seg` through `mal_tpu_torch.cli.main` at Swin-L: a fake
    COCO tree of 6 seeded 640x480 JPEGs with COCO's 80 sparse category ids
    and 2-12 instances each (RLE and polygons) under
    `build/chip_smoke_finetune`, `--size large --height 256 --width 448
    --batch_size 2 --num_queries 100 --max_instances 16` (the defaults:
    12,544 points, AdamW 1e-4 / 0.05), 3 steps, the mask-AP pass and the
    `.pkl`. Counted: every kernel 0 in the steps (the step function is
    wrapped to read the counts around each call), K4 = 24 and K5 = 6 a
    forward in the AP pass (3 forwards). Prints each step's ms and the
    matching's host ms, the peak memory, the AP pass's ms a forward."""
    import shutil

    import torch

    import mal_tpu_torch.segment.finetune as finetune
    from mal_tpu_torch.cli import main as cli
    from mal_tpu_torch.convert.mask2former import load_mask2former_pkl
    from mal_tpu_torch.data.synthetic import write_fake_coco
    from mal_tpu_torch.segment.mask2former import Mask2Former

    t_phase = time.perf_counter()
    root = os.path.abspath(os.path.join("build", "chip_smoke_finetune"))
    shutil.rmtree(root, ignore_errors=True)
    paths = write_fake_coco(root, n_images=FT_IMAGES, seed=0)
    in_steps = {fn.__name__: 0 for fn in every}
    make_step = finetune.make_seg_finetune_step

    def counting_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted_step(*a, **k):
            before = {fn.__name__: fn.launches for fn in every}
            out = step(*a, **k)
            for fn in every:
                in_steps[fn.__name__] += fn.launches - before[fn.__name__]
            return out

        return counted_step

    for fn in every:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    finetune.make_seg_finetune_step = counting_make_step
    try:
        got = cli(["finetune-seg", "--images", paths["images"],
                   "--annotations", paths["annotations"], "--size", "large",
                   "--height", str(FT_HEIGHT), "--width", str(FT_WIDTH),
                   "--batch_size", str(FT_BATCH), "--num_queries",
                   str(FT_QUERIES), "--max_instances", str(FT_INSTANCES),
                   "--out", os.path.join(root, "out")])
    finally:
        finetune.make_seg_finetune_step = make_step
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = {fn.__name__: fn.launches for fn in every}
    ap_pass = {k: total[k] - in_steps[k] for k in total}
    steps = got["steps"]
    print(f"finetune-seg (Swin-L, {FT_HEIGHT}x{FT_WIDTH}, batch {FT_BATCH}, "
          f"{FT_QUERIES} queries, 81-way head, {FT_INSTANCES} targets, "
          f"12544 points): launches in the {len(steps)} steps {in_steps}; "
          f"in the AP pass ({len(got['eval_ms'])} forwards) {ap_pass}")
    check(len(steps) == FT_STEPS, f"{len(steps)} fine-tuning steps, not "
          f"{FT_STEPS}")
    check(all(_finite(m) for m in steps), f"fine-tuning metrics {steps}")
    check(not any(in_steps.values()),
          f"the fine-tuning steps launched kernels: {in_steps}")
    forwards = len(got["eval_ms"])
    want = {"window_attention": K4_A_FORWARD * forwards,
            "ms_deform_attn_core": K5_A_FORWARD * forwards}
    for k, n in ap_pass.items():
        check(n == want.get(k, 0), f"AP pass: {k} launched {n} times, not "
              f"{want.get(k, 0)}")
    ms = [m["ms"] for m in steps]
    copy_ms = [m["match_copy_ms"] for m in steps]
    solve_ms = [m["match_solve_ms"] for m in steps]
    print(f"finetune-seg step ms (host clock, synchronized) "
          f"{', '.join(f'{t:.2f}' for t in ms)}; median after the first "
          f"{statistics.median(ms[1:]):.2f}; the matching's host ms, after a "
          f"synchronize, of the copy of 10 x {FT_BATCH} cost matrices "
          f"{', '.join(f'{t:.2f}' for t in copy_ms)} and of their solve "
          f"{', '.join(f'{t:.2f}' for t in solve_ms)}; peak memory "
          f"{peak:.2f} GiB; AP pass ms a forward "
          f"{', '.join(f'{t:.2f}' for t in got['eval_ms'])}; AP {got['AP']}; "
          f"losses {[round(m['loss'], 4) for m in steps]}")
    # the written .pkl loads strictly into the segmenter, finite
    frozen = Mask2Former(device="cpu", init_weights=False)
    load_mask2former_pkl(frozen, got["saved"][1])
    check(all(torch.isfinite(v).all().item()
              for v in frozen.state_dict().values()), "model.pkl not finite")
    del frozen
    shutil.rmtree(root, ignore_errors=True)
    print(f"finetune-seg phase wall time {time.perf_counter() - t_phase:.2f} s")
    return {"finetune_seg_steps": in_steps, "finetune_seg_ap": ap_pass}


def _compare_kernels(records: list):
    """Context: while active, the segmenter's K4 / K5 calls also run their
    plain versions on the same inputs and record (kernel, shape, max abs
    error, largest plain value, route). The plain versions are not
    counted; the kernels' own counts move as usual."""
    import contextlib

    from mal_tpu_torch.ops.cuda.deform_sample import (
        ms_deform_attn_core_per_level, staged_channels)
    from mal_tpu_torch.ops.cuda.window_attention import (
        window_attention_reference, window_attention_route)
    from mal_tpu_torch.segment import msdeform, swin

    k4, k5 = swin.window_attention, msdeform.ms_deform_attn_core

    def k4_checked(qkv, table, mask, heads):
        out = k4(qkv, table, mask, heads)
        plain = window_attention_reference(qkv, table, mask, heads)
        records.append(("window_attention", tuple(qkv.shape),
                        (out - plain).abs().max().item(),
                        plain.abs().max().item(), window_attention_route(
                            int(round(qkv.shape[1] ** 0.5)))))
        return out

    def k5_checked(value, shapes, locs, aw):
        out = k5(value, shapes, locs, aw)
        plain = ms_deform_attn_core_per_level(value, shapes, locs, aw)
        records.append(("ms_deform_attn_core", tuple(shapes),
                        (out - plain).abs().max().item(),
                        plain.abs().max().item(),
                        "staged" if staged_channels(
                            value.shape[1], value.shape[3],
                            locs.shape[4]) else "gather"))
        return out

    @contextlib.contextmanager
    def active():
        swin.window_attention, msdeform.ms_deform_attn_core = (k4_checked,
                                                               k5_checked)
        try:
            yield
        finally:
            swin.window_attention, msdeform.ms_deform_attn_core = k4, k5

    return active()


def seg_inference_phase(kernels: list, every: list) -> dict[str, dict]:
    """The segmenter's inference surface at Swin-L (80 classes, 100
    queries, seeded weights, batch 2 at 256x448): first K4 and K5 against
    their plain versions inside one forward at each TTA scale (192x320,
    256x448, 320x576: every K4 and K5 call of the forward, at most K4_ATOL
    / K5_ATOL times the plain output's largest value, at least 1); then,
    counted, semantic and panoptic inference from one forward (K4 = 24, K5
    = 6) and `semantic_tta` at (0.75, 1, 1.25) with flip (6 forwards), each
    variant timed."""
    import torch

    from mal_tpu_torch.ops.interp import resize_bilinear
    from mal_tpu_torch.segment.inference import (panoptic_inference,
                                                 semantic_inference,
                                                 semantic_tta, snap32)
    from mal_tpu_torch.segment.mask2former import Mask2Former

    t_phase = time.perf_counter()
    model = Mask2Former(generator=torch.Generator().manual_seed(2))
    g = torch.Generator(device="cuda").manual_seed(9)
    images = torch.rand((FT_BATCH, FT_HEIGHT, FT_WIDTH, 3), generator=g,
                        device="cuda")
    records: list = []
    with torch.no_grad(), _compare_kernels(records):
        for s in TTA_SCALES:
            h, w = snap32(FT_HEIGHT * s), snap32(FT_WIDTH * s)
            n0 = len(records)
            model(resize_bilinear(images.permute(0, 3, 1, 2), h, w)
                  .permute(0, 2, 3, 1).contiguous())
            mine = records[n0:]
            for name, atol in (("window_attention", K4_ATOL),
                               ("ms_deform_attn_core", K5_ATOL)):
                rows = [r for r in mine if r[0] == name]
                worst = max(r[2] / max(1.0, r[3]) for r in rows)
                print(f"{name} inside the {h}x{w} forward: {len(rows)} "
                      f"calls at {sorted({r[1] for r in rows})} "
                      f"({', '.join(sorted({r[4] for r in rows}))}); largest "
                      f"error {max(r[2] for r in rows):.3e}, relative to "
                      f"max(1, |plain|) {worst:.3e} (atol {atol})")
                check(worst <= atol, f"{name} disagrees with its plain "
                      f"version at {h}x{w}: {worst}")
                for k in kernels:
                    if k["name"] == name:
                        k.setdefault("tta_max_abs_err", {})[f"{h}x{w}"] = max(
                            r[2] for r in rows)

    def counted(want_forwards: int, fn):
        for f in every:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {f.__name__: f.launches for f in every}
        want = {"window_attention": K4_A_FORWARD * want_forwards,
                "ms_deform_attn_core": K5_A_FORWARD * want_forwards}
        for k, n in got.items():
            check(n == want.get(k, 0), f"inference: {k} launched {n} times,"
                  f" not {want.get(k, 0)}")
        return out, got

    by_path = {}
    thing = torch.zeros(80, dtype=torch.bool, device="cuda")
    thing[:40] = True

    def semantic_and_panoptic():
        # random weights score every class ~1/81: keep every query
        logits, masks = model(images)
        return (semantic_inference(logits, masks),
                panoptic_inference(logits, masks, thing,
                                   object_mask_threshold=0.0))

    with torch.no_grad():
        t0 = time.perf_counter()
        (sem, pan), by_path["seg_semantic_panoptic"] = counted(
            1, semantic_and_panoptic)
        one_ms = 1e3 * (time.perf_counter() - t0)
        check(sem.shape == (FT_BATCH, 80, FT_HEIGHT // 4, FT_WIDTH // 4)
              and torch.isfinite(sem).all().item(), "semantic output")
        check(pan.seg.shape == (FT_BATCH, FT_HEIGHT // 4, FT_WIDTH // 4)
              and pan.seg.dtype == torch.int32
              and int(pan.seg.max()) <= int(pan.ids.max()),
              "panoptic output")
        variant_ms = []

        def timed(x):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = model(x)
            torch.cuda.synchronize()
            variant_ms.append(1e3 * (time.perf_counter() - t))
            return out

        tta, by_path["seg_tta"] = counted(
            2 * len(TTA_SCALES), lambda: semantic_tta(timed, images,
                                                      TTA_SCALES, True))
        check(tta.shape == (FT_BATCH, 80, FT_HEIGHT, FT_WIDTH)
              and torch.isfinite(tta).all().item(), "TTA output")
    names = [f"{snap32(FT_HEIGHT * s)}x{snap32(FT_WIDTH * s)}{f}"
             for s in TTA_SCALES for f in ("", " flipped")]
    print(f"segmenter inference (Swin-L, batch {FT_BATCH}): one forward with "
          f"semantic + panoptic {one_ms:.2f} ms ({int(pan.valid.sum())} "
          f"panoptic segments); TTA variants ms "
          + ", ".join(f"{n} {t:.2f}" for n, t in zip(names, variant_ms))
          + f"; launches {by_path}")
    del model
    print(f"segmenter inference phase wall time "
          f"{time.perf_counter() - t_phase:.2f} s")
    return by_path


# MaskFormer v1 at `mal_tpu`'s defaults (Swin-T, 100 queries, 80 classes,
# fp32), batch 2 at 256x448: stage -> (padded map, real map, C, heads,
# whether odd blocks shift) of its Swin-T (window 7; every stage's padded
# map exceeds one window, so every odd block shifts)
V1_BATCH, V1_HEIGHT, V1_WIDTH = 2, 256, 448
SWIN_T_STAGES = {0: ((70, 112), (64, 112), 96, 3, True),
                 1: ((35, 56), (32, 56), 192, 6, True),
                 2: ((21, 28), (16, 28), 384, 12, True),
                 3: ((14, 14), (8, 14), 768, 24, True)}
SWIN_T_WINDOW = 7
SWIN_T_LAUNCHES = {0: 2, 1: 2, 2: 6, 3: 2}   # blocks a stage, one forward
K4_V1_A_FORWARD = sum(SWIN_T_LAUNCHES.values())


def maskformer_v1_phase(kernels: list, every: list) -> dict[str, dict]:
    """MaskFormer v1 at `mal_tpu`'s defaults (Swin-T, 100 queries, 80
    classes, fp32, seeded weights), batch 2 at 256x448 (K4 at Swin-T's four
    stage shapes is timed in `k4_phase`): every K4 call of one forward
    against its plain version (at most K4_ATOL times the plain
    output's largest value, at least 1); then, counted, a forward (K4 = 12,
    every other kernel 0) with semantic and panoptic inference on its
    output, and `PerPixelBaselineHead` with the FPN and with the
    transformer-encoder pixel decoder on the backbone's features (no
    kernel), each forward timed."""
    import torch

    from mal_tpu_torch.segment.inference import (panoptic_inference,
                                                 semantic_inference)
    from mal_tpu_torch.segment.mask2former import preprocess_images
    from mal_tpu_torch.segment.maskformer_v1 import (MaskFormerV1,
                                                     PerPixelBaselineHead)

    t_phase = time.perf_counter()
    model = MaskFormerV1(generator=torch.Generator().manual_seed(3))
    g = torch.Generator(device="cuda").manual_seed(13)
    images = torch.rand((V1_BATCH, V1_HEIGHT, V1_WIDTH, 3), generator=g,
                        device="cuda")
    records: list = []
    with torch.no_grad(), _compare_kernels(records):
        model(images)
    rows = [r for r in records if r[0] == "window_attention"]
    check(len(rows) == len(records) == K4_V1_A_FORWARD,
          f"MaskFormer v1: {len(rows)} K4 calls of {len(records)} kernel "
          f"calls, not {K4_V1_A_FORWARD}")
    worst = max(r[2] / max(1.0, r[3]) for r in rows)
    print(f"window_attention inside the MaskFormer v1 forward: {len(rows)} "
          f"calls at {sorted({r[1] for r in rows})}; largest error "
          f"{max(r[2] for r in rows):.3e}, relative to max(1, |plain|) "
          f"{worst:.3e} (atol {K4_ATOL})")
    check(worst <= K4_ATOL, f"K4 disagrees with its plain version inside "
          f"MaskFormer v1: {worst}")
    check({r[4] for r in rows} == {"w7"}, f"MaskFormer v1's K4 calls took "
          f"the routes {sorted({r[4] for r in rows})}, not w7 alone")
    for k in kernels:
        if k["name"] == "window_attention":
            k["v1_max_abs_err"] = max(r[2] for r in rows)

    def counted(want: dict, fn):
        for f in every:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {f.__name__: f.launches for f in every}
        for k, n in got.items():
            check(n == want.get(k, 0), f"MaskFormer v1: {k} launched {n} "
                  f"times, not {want.get(k, 0)}")
        return out, got

    def timed_ms(fn, reps: int = 3) -> list[float]:
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t))
        return out

    by_path = {}
    thing = torch.zeros(80, dtype=torch.bool, device="cuda")
    thing[:40] = True

    def forward_and_inference():
        logits, masks = model(images)
        return (logits, masks, semantic_inference(logits, masks),
                panoptic_inference(logits, masks, thing,
                                   object_mask_threshold=0.0))

    h4, w4 = V1_HEIGHT // 4, V1_WIDTH // 4
    with torch.no_grad():
        (logits, masks, sem, pan), by_path["v1_forward"] = counted(
            {"window_attention": K4_V1_A_FORWARD}, forward_and_inference)
        check(logits.shape == (V1_BATCH, 100, 81)
              and masks.shape == (V1_BATCH, 100, h4, w4)
              and torch.isfinite(logits).all().item()
              and torch.isfinite(masks).all().item(), "v1 outputs")
        check(sem.shape == (V1_BATCH, 80, h4, w4)
              and torch.isfinite(sem).all().item(), "v1 semantic output")
        check(pan.seg.shape == (V1_BATCH, h4, w4)
              and pan.seg.dtype == torch.int32
              and int(pan.seg.max()) <= int(pan.ids.max()),
              "v1 panoptic output")
        forward_ms = timed_ms(lambda: model(images))
        feats = model.backbone(preprocess_images(
            images, model.bgr_input, mean=model.pixel_mean,
            std=model.pixel_std))
        head_ms, heads = {}, {}
        for enc in (False, True):
            name = "transformer_enc" if enc else "fpn"
            torch.manual_seed(4)      # torch's default initialisation
            head = PerPixelBaselineHead(
                {f"res{s + 2}": 96 * 2 ** s for s in range(4)},
                transformer_enc=enc).cuda().eval()
            out, by_path[f"v1_per_pixel_{name}"] = counted({}, lambda: head(
                feats))
            check(out.shape == (V1_BATCH, V1_HEIGHT, V1_WIDTH, 80)
                  and torch.isfinite(out).all().item(),
                  f"per-pixel head ({name}) output")
            head_ms[name] = timed_ms(lambda: head(feats))
            heads[name] = head
    print(f"MaskFormer v1 (Swin-T, batch {V1_BATCH}, {V1_HEIGHT}x{V1_WIDTH},"
          f" fp32): forward ms {', '.join(f'{t:.2f}' for t in forward_ms)} "
          f"({int(pan.valid.sum())} panoptic segments); per-pixel baseline "
          f"head ms on the backbone's features: "
          + "; ".join(f"{n} {', '.join(f'{t:.2f}' for t in v)}"
                      for n, v in head_ms.items())
          + f"; launches {by_path} ({card_line()})")
    del model, heads
    print(f"MaskFormer v1 phase wall time "
          f"{time.perf_counter() - t_phase:.2f} s")
    return by_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3,
                        help="training steps of each path")
    parser.add_argument("--profile", action="store_true",
                        help="profile one extra step after each path")
    parser.add_argument("--kernels-only", action="store_true",
                        help="build the kernels, hold each against its plain "
                             "version, print their line and stop: a quick "
                             "check of the kernels alone, with no result line")
    # a rank of the data-parallel phase, which spawns the script with these
    parser.add_argument("--dp-rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--dp-dir", default=None, help=argparse.SUPPRESS)
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
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, args.dp_dir)

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build_libraries(SOURCES)
    print(f"kernel build {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = [k1_phase(), k6_phase(), k2_phase(args.profile),
               k3_phase(args.profile), k4_phase(),
               k5_phase(), k5b_phase(), gauss_newton_phase()]
    if args.kernels_only:
        print(json.dumps({"kernels": kernels}))
        return 0
    small_reference_phase()
    small_temporal_reference_phase()
    small_temporal_reference_phase(fast=True)
    small_dynamic_reference_phase()
    small_dualref_reference_phase()

    every = _counted_wrappers()
    small_finetune_reference_phase(every)
    by_path = {"no_hint": main_path_phase(args.steps, args.profile)}
    by_path.update(options_phase(every))
    # the fp32 segmenter goes at once: a live one would add its 0.8 GiB to
    # every later path's peak memory
    by_path["temporal"] = temporal_path_phase(args.steps, args.profile,
                                              False)[0]
    by_path["fast"], seg_fn = temporal_path_phase(args.steps, args.profile,
                                                  True)
    by_path.update(cached_hint_phase(seg_fn, every))
    del seg_fn
    by_path["dynamic"] = dynamic_path_phase(args.steps, args.profile, False,
                                            every)
    by_path["dynamic_fast"] = dynamic_path_phase(args.steps, args.profile,
                                                 True, every)
    by_path["online_doj"] = online_doj_phase(args.steps, args.profile, False,
                                             every)
    by_path["online_doj_fast"] = online_doj_phase(args.steps, args.profile,
                                                  True, every)
    # one NCCL process a card where the global batch of 12 divides over
    # the cards, else two gloo processes on cuda:0
    cards = torch.cuda.device_count()
    if cards > 1 and 12 % cards == 0:
        by_path.update(data_parallel_phase(cards, nccl=True))
    else:
        by_path.update(data_parallel_phase())
    # one NCCL process a card as (cards / 2) data x 2 depth where the card
    # count is even and divides 24, else two gloo processes on cuda:0 as
    # 1 x 2
    if cards % 2 == 0 and 24 % cards == 0:
        depth_paths, k1_share = depth_axis_phase(cards, nccl=True)
    else:
        depth_paths, k1_share = depth_axis_phase()
    by_path.update(depth_paths)
    kernels[0]["depth_share"] = k1_share
    by_path.update(dualref_path_phase(args.steps, args.profile, False, every))
    by_path.update(dualref_path_phase(args.steps, args.profile, True, every))
    by_path.update(cli_phase(args.profile, every))
    t_seg = time.perf_counter()
    by_path.update(finetune_phase(every))
    by_path.update(seg_inference_phase(kernels, every))
    by_path.update(maskformer_v1_phase(kernels, every))
    print(f"fine-tuning, inference and MaskFormer v1 phases (10, 11, 12) "
          f"wall time {time.perf_counter() - t_seg:.2f} s")
    for k in kernels:
        k["launches_by_path"] = {path: counts.get(k["name"], 0)
                                 for path, counts in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        # K5b has no caller on any path, here as in mal_tpu (its
        # `segment/msdeform.py` calls only the v4 sampler): its phase above
        # is its launch
        check(k["launches"] > 0 or k["name"] == "deform_sample_fused",
              f"{k['name']} never launched on any path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
