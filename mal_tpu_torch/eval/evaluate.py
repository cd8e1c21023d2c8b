"""Depth evaluation protocol (the port's counterpart of
`mal_tpu.eval.evaluate`).

Reproduces `manydepth/evaluate_depth.py:66-288`: scaled-disparity inference
with the eval-time depth range [1e-3, 80], bilinear resize of the disparity
to GT resolution, the Garg / eigen crop or the CityScapes centre crop,
median scaling, clipping, and the mean of the seven metrics. Inference runs
the port's `MALModel.eval_forward` on the model's device under
`torch.inference_mode()`; the rest is numpy on the host.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np
import torch

from mal_tpu_torch import geometry
from mal_tpu_torch.config import Config
from mal_tpu_torch.device import batch_to_device, resolve_device
from mal_tpu_torch.eval.metrics import compute_depth_errors_np
from mal_tpu_torch.eval.postprocess import post_process_disparity
from mal_tpu_torch.ops.interp import resize_bilinear

# eval-time depth range (`manydepth/evaluate_depth.py:296-299`)
EVAL_MIN_DEPTH = 1e-3
EVAL_MAX_DEPTH = 80.0


def _resize_disp(disp: np.ndarray, gt_h: int, gt_w: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) equivalent (half-pixel bilinear)."""
    d = torch.from_numpy(np.asarray(disp, np.float32))[None, None]
    return resize_bilinear(d, gt_h, gt_w)[0, 0].numpy()


def prepare_gt_and_pred(gt_depth: np.ndarray, pred_disp: np.ndarray,
                        eval_split: str = "eigen",
                        min_depth: float = EVAL_MIN_DEPTH,
                        max_depth: float = EVAL_MAX_DEPTH,
                        median_scaling: bool = True,
                        pred_depth_scale_factor: float = 1.0):
    """One image: returns (masked_gt, masked_scaled_pred, ratio)."""
    if eval_split == "cityscapes":
        gt_height = int(round(gt_depth.shape[0] * 0.75))
        gt_depth = gt_depth[:gt_height]

    gt_h, gt_w = gt_depth.shape[:2]
    pred_depth = 1.0 / _resize_disp(pred_disp, gt_h, gt_w)

    if eval_split == "cityscapes":
        gt_depth = gt_depth[256:, 192:1856]
        pred_depth = pred_depth[256:, 192:1856]

    if eval_split == "eigen":
        mask = np.logical_and(gt_depth > min_depth, gt_depth < max_depth)
        crop = np.array([0.40810811 * gt_h, 0.99189189 * gt_h,
                         0.03594771 * gt_w, 0.96405229 * gt_w]).astype(np.int32)
        crop_mask = np.zeros_like(mask)
        crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
        mask = np.logical_and(mask, crop_mask)
    elif eval_split == "cityscapes":
        mask = np.logical_and(gt_depth > min_depth, gt_depth < max_depth)
    else:
        mask = gt_depth > 0

    gt = gt_depth[mask]
    pred = pred_depth[mask] * pred_depth_scale_factor

    ratio = 1.0
    if median_scaling:
        ratio = np.median(gt) / np.median(pred)
        pred = pred * ratio
    pred = np.clip(pred, min_depth, max_depth)
    return gt, pred, ratio


def evaluate_depth_maps(pred_disps: Sequence[np.ndarray],
                        gt_depths: Sequence[np.ndarray],
                        eval_split: str = "eigen",
                        median_scaling: bool = True,
                        pred_depth_scale_factor: float = 1.0) -> dict:
    """Mean 7-metric dict over the split, with the median-scaling ratio's
    statistics. `median_scaling=False` is `--disable_median_scaling`;
    `pred_depth_scale_factor` is `--pred_depth_scale_factor` (5.4 for
    stereo-trained models, `manydepth/evaluate_depth.py:245-247`)."""
    # DDAD evaluates to 200 m (`manydepth/trainer.py:669-670`)
    max_depth = 200.0 if eval_split == "ddad" else EVAL_MAX_DEPTH
    errors, ratios = [], []
    for pred_disp, gt in zip(pred_disps, gt_depths):
        g, p, r = prepare_gt_and_pred(
            gt, pred_disp, eval_split, max_depth=max_depth,
            median_scaling=median_scaling,
            pred_depth_scale_factor=pred_depth_scale_factor)
        errors.append(compute_depth_errors_np(g, p))
        ratios.append(r)
    mean = {k: float(np.mean([e[k] for e in errors])) for k in errors[0]}
    ratios = np.array(ratios)
    mean["med_ratio"] = float(np.median(ratios))
    mean["std_ratio"] = float(np.std(ratios / np.median(ratios)))
    return mean


def load_gt_depths(path: str):
    """GT depths: a KITTI-style `gt_depths.npz` (key "data"), or a directory
    of `NNN_depth.npy` files (the reference's CityScapes layout,
    `dynamicdepth/trainer.py:1177`)."""
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith("_depth.npy"))
        return [np.load(os.path.join(path, f)) for f in files]
    return np.load(path, fix_imports=True, encoding="latin1",
                   allow_pickle=True)["data"]


def check_model_device(model: torch.nn.Module,
                       device: str | torch.device | None) -> torch.device:
    """`device` resolved (None -> the GPU, raising if there is none), and
    the model's parameters on it."""
    device = resolve_device(device)
    where = next(model.parameters()).device
    if where != device:
        raise ValueError(f"the model is on {where}, the evaluation runs on "
                         f"{device}")
    return device


def infer_disparities(model, batches: Iterable[dict], cfg: Config,
                      eval_teacher: bool = False,
                      min_depth_bin: float = 0.1, max_depth_bin: float = 10.0,
                      zero_cost_volume: bool = False,
                      static_camera: bool = False,
                      post_process: bool = False,
                      device: str | torch.device | None = None) -> np.ndarray:
    """The eval forward of `model` (a port `MALModel` on `device`) over host
    batches of numpy arrays; returns the (N, H, W) scaled disparities.

    Behavioural probes (`mal_tpu/eval/evaluate.py:102-172`):
    `zero_cost_volume` zeroes the lookup poses; `static_camera` replaces
    every lookup frame with the current frame
    (`dualrefine/evaluate_depth.py:164-166`). `post_process` runs a second
    forward on mirrored inputs and blends (teacher only: the cost volume's
    epipolar geometry is not mirror-consistent).
    """
    del cfg   # the model carries its configuration
    device = check_model_device(model, device)
    if post_process and not eval_teacher:
        raise ValueError("post_process requires eval_teacher (flip "
                         "averaging is only defined for the mono network)")
    key = "mono_disp" if eval_teacher else "disp"
    min_d = torch.tensor(float(min_depth_bin), device=device)
    max_d = torch.tensor(float(max_depth_bin), device=device)

    def scaled(batch) -> torch.Tensor:
        out = model.eval_forward(batch, min_d, max_d,
                                 zero_cost_volume=zero_cost_volume)
        disp, _ = geometry.disp_to_depth(out[key], EVAL_MIN_DEPTH,
                                         EVAL_MAX_DEPTH)
        return disp[..., 0]

    disps = []
    with torch.inference_mode():
        for host in batches:
            batch = batch_to_device(host, device)
            if static_camera:
                color0 = batch["color"]["0"]
                batch = dict(batch, color={k: color0 for k in batch["color"]})
            disp = scaled(batch).cpu().numpy()
            if post_process:
                flipped = dict(batch, color={k: v.flip(2) for k, v in
                                             batch["color"].items()})
                disp_f = scaled(flipped).flip(2).cpu().numpy()
                disp = post_process_disparity(disp, disp_f)
            disps.append(disp)
    return np.concatenate(disps, axis=0)
