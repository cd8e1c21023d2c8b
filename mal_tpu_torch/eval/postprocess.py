"""Eval-time disparity post-processing and prediction I/O (the port's copy
of `mal_tpu.eval.postprocess`; reference `manydepth/evaluate_depth.py`,
`dualrefine/evaluate_depth.py:150-233`):

- `--post_process`: Monodepth-v1 flip averaging;
- `--save_pred_disps` / `--ext_disp_to_eval`: save the predicted disparity
  stack to `<ckpt>/<tag>_<split>_split.npy`, or evaluate a saved stack;
- `--eval_split benchmark`: uint16 PNG depth maps at 1216x352 scaled by 256.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mal_tpu_torch.eval.metrics import STEREO_SCALE_FACTOR  # noqa: F401
from mal_tpu_torch.ops.interp import resize_bilinear


def post_process_disparity(disp: np.ndarray,
                           disp_flipped: np.ndarray) -> np.ndarray:
    """Monodepth-v1 flip averaging over a (N, H, W) disparity batch.

    `disp` is the prediction on the original images, `disp_flipped` the
    prediction on mirrored inputs, already mirrored back. Near the left
    border the mirrored prediction is trusted, near the right border the
    direct one, in between their mean (`manydepth/evaluate_depth.py:56-63`).
    """
    n, h, w = disp.shape
    ramp = np.clip(20.0 * (np.linspace(0.0, 1.0, w) - 0.05), 0.0, 1.0)
    weight_flipped = (1.0 - ramp)[None, None, :]          # ->1 at left edge
    weight_direct = weight_flipped[:, :, ::-1]            # ->1 at right edge
    mean = 0.5 * (disp + disp_flipped)
    return (weight_direct * disp + weight_flipped * disp_flipped
            + (1.0 - weight_direct - weight_flipped) * mean)


def pred_disps_path(ckpt_dir: str, eval_split: str, eval_teacher: bool = False,
                    zero_cost_volume: bool = False) -> str:
    """Tagged save path (`dualrefine/evaluate_depth.py:202-212`)."""
    tag = ("zero_cv" if zero_cost_volume
           else "teacher" if eval_teacher else "multi")
    return os.path.join(ckpt_dir, f"{tag}_{eval_split}_split.npy")


def save_pred_disps(disps: np.ndarray, ckpt_dir: str, eval_split: str,
                    eval_teacher: bool = False,
                    zero_cost_volume: bool = False) -> str:
    path = pred_disps_path(ckpt_dir, eval_split, eval_teacher,
                           zero_cost_volume)
    np.save(path, np.asarray(disps))
    return path


def load_ext_disps(path: str, eigen_to_benchmark_ids: str | None = None
                   ) -> np.ndarray:
    """`--ext_disp_to_eval`, with the optional `--eval_eigen_to_benchmark`
    re-indexing (`dualrefine/evaluate_depth.py:193-200`)."""
    disps = np.load(path)
    if eigen_to_benchmark_ids is not None:
        disps = disps[np.load(eigen_to_benchmark_ids)]
    return disps


def export_benchmark_predictions(disps: np.ndarray, out_dir: str) -> int:
    """KITTI-benchmark uint16 PNG export (`dualrefine/evaluate_depth.py:
    218-233`): each disparity resized to 1216x352, depth = 5.4 / disp
    clipped to [0, 80], stored as uint16 depth * 256."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for idx in range(disps.shape[0]):
        d = torch.from_numpy(np.asarray(disps[idx], np.float32))[None, None]
        resized = resize_bilinear(d, 352, 1216)[0, 0].numpy()
        depth = np.clip(STEREO_SCALE_FACTOR / np.maximum(resized, 1e-8),
                        0.0, 80.0)
        arr = (depth * 256.0).astype(np.uint16)
        Image.fromarray(arr, mode="I;16").save(
            os.path.join(out_dir, f"{idx:010d}.png"))
    return int(disps.shape[0])
