"""DynamicDepth's `--eval_mode` loop (`dynamicdepth/trainer.py:266-273,
756-905`), the port's counterpart of `mal_tpu.dynamic.evaluate`.

Per image (the reference indexes GT and the doj masks per *batch*, so this
is a batch-size-1 protocol, `trainer.py:1177,1228-1230`): poses, teacher,
DOMD warp (eval variant), occlusion-aware cost volume, student disparity;
then `compute_depth_losses` (`trainer.py:1158-1255`): depth (not
disparity) resized bilinearly to the GT, clamped to [1e-3, 80], the
CityScapes ego-car and centre crops, median scaling, the seven metrics over
the valid mask, and the same restricted to the valid dynamic-object
("doj") pixels. Image metrics average with equal weight; the doj metrics
average over the images that have any doj pixel.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np
import torch

from mal_tpu_torch import geometry
from mal_tpu_torch.config import Config
from mal_tpu_torch.device import batch_to_device
from mal_tpu_torch.eval.evaluate import (EVAL_MAX_DEPTH, EVAL_MIN_DEPTH,
                                         check_model_device, load_gt_depths)
from mal_tpu_torch.eval.metrics import compute_depth_errors_np
from mal_tpu_torch.ops.interp import resize_bilinear, resize_nearest

def _resize(fn, a: np.ndarray, h: int, w: int) -> np.ndarray:
    return fn(torch.from_numpy(np.asarray(a, np.float32))[None, None],
              h, w)[0, 0].numpy()


def _metrics_one(gt_depth: np.ndarray, depth_pred: np.ndarray,
                 doj_mask: np.ndarray, eval_split: str,
                 split: str) -> tuple[dict, dict, int]:
    """`compute_depth_losses` for one image. Returns (metrics, doj_metrics,
    has_doj)."""
    if split == "cityscapes_preprocessed":
        gt_h = int(round(gt_depth.shape[0] * 0.75))
        gt_depth = gt_depth[:gt_h]
    gt_h, gt_w = gt_depth.shape[:2]

    pred = _resize(resize_bilinear, depth_pred, gt_h, gt_w)
    pred = np.clip(pred, EVAL_MIN_DEPTH, EVAL_MAX_DEPTH)
    doj = _resize(resize_nearest, doj_mask, gt_h, gt_w)

    if split == "cityscapes_preprocessed":
        gt_depth = gt_depth[256:, 192:1856]
        pred = pred[256:, 192:1856]
        doj = doj[256:, 192:1856]

    mask = np.logical_and(gt_depth > EVAL_MIN_DEPTH, gt_depth < EVAL_MAX_DEPTH)
    if eval_split in ("eigen", "eigen_benchmark"):
        h, w = gt_depth.shape[:2]
        crop = np.array([0.40810811 * h, 0.99189189 * h,
                         0.03594771 * w, 0.96405229 * w]).astype(np.int32)
        crop_mask = np.zeros_like(mask)
        crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
        mask = np.logical_and(mask, crop_mask)

    pred = pred * (np.median(gt_depth[mask]) / np.median(pred[mask]))
    pred = np.clip(pred, EVAL_MIN_DEPTH, EVAL_MAX_DEPTH)

    doj_sel = mask & (doj > 0.5)
    errors = compute_depth_errors_np(gt_depth[mask], pred[mask])
    has_doj = int(doj_sel.sum() > 0)
    doj_errors = (compute_depth_errors_np(gt_depth[doj_sel], pred[doj_sel])
                  if has_doj else {k: 0.0 for k in errors})
    return errors, doj_errors, has_doj


def evaluate_dynamic(cfg: Config, model, batches: Iterable[dict], gt_depths,
                     min_depth_bin: float = 0.1, max_depth_bin: float = 10.0,
                     mono_eval: bool = True,
                     device: str | torch.device | None = None) -> dict:
    """The eval loop of `model` (a port `DynDepthModel` on `device`) over
    host batches of numpy arrays; returns {"<m>", "doj/<m>", "mono/<m>",
    "mono_doj/<m>", "doj_batches", "n_images"}."""
    device = check_model_device(model, device)
    min_d = torch.tensor(float(min_depth_bin), device=device)
    max_d = torch.tensor(float(max_depth_bin), device=device)

    sums: dict[str, float] = {}
    n_batches = 0
    n_doj = 0
    idx = 0
    with torch.inference_mode():
        for host in batches:
            out = model.eval_forward(batch_to_device(host, device), min_d,
                                     max_d)
            _, depth = geometry.disp_to_depth(out["disp"], cfg.min_depth,
                                              cfg.max_depth)
            _, mono_depth = geometry.disp_to_depth(
                out["mono_disp"], cfg.min_depth, cfg.max_depth)
            depth = depth[..., 0].cpu().numpy()
            mono_depth = mono_depth[..., 0].cpu().numpy()
            for b in range(depth.shape[0]):
                gt = gt_depths[idx]
                doj = (np.asarray(host["doj_mask"][b]) if "doj_mask" in host
                       else np.zeros(depth.shape[1:3], np.float32))
                err, doj_err, has = _metrics_one(gt, depth[b], doj,
                                                 cfg.eval_split, cfg.split)
                streams = [("", err), ("doj/", doj_err)]
                if mono_eval:
                    merr, mdoj, _ = _metrics_one(gt, mono_depth[b], doj,
                                                 cfg.eval_split, cfg.split)
                    streams += [("mono/", merr), ("mono_doj/", mdoj)]
                for pre, e in streams:
                    for k, v in e.items():
                        sums[pre + k] = sums.get(pre + k, 0.0) + float(v)
                n_batches += 1
                n_doj += has
                idx += 1

    out = {}
    for k, v in sums.items():
        denom = n_doj if ("doj/" in k and n_doj > 0) else n_batches
        out[k] = v / max(denom, 1)
    out["doj_batches"] = float(n_doj)
    out["n_images"] = float(n_batches)
    return out


def run_dynamic_eval(cfg: Config, ckpt: str, loader, gt_path: str,
                     device: str | torch.device | None = None) -> dict:
    """The CLI's entry: a `DynDepthModel` on `device` filled from the
    reference-layout `.pth` directory `ckpt` (or the directory of the file
    `ckpt`), its depth bins, the GT depths, and the loop."""
    from mal_tpu_torch.dynamic.model import DynDepthModel
    from mal_tpu_torch.train.state import DepthBinTracker
    from mal_tpu_torch.utils.checkpoint import load_pretrained

    folder = ckpt if os.path.isdir(ckpt) else os.path.dirname(ckpt)
    model = DynDepthModel(cfg, device=device, init_weights=False)
    bins = DepthBinTracker.create()
    load_pretrained(model, folder, bins=bins)
    return evaluate_dynamic(
        cfg, model, iter(loader), load_gt_depths(gt_path),
        min_depth_bin=float(bins.min_depth), max_depth_bin=float(bins.max_depth),
        device=device)
