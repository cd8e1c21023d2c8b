"""Depth evaluation metrics (the port's copy of the numpy part of
`mal_tpu.eval.metrics`): the seven standard metrics of
`manydepth/evaluate_depth.py:35-53` and the protocol's constants."""

from __future__ import annotations

import numpy as np

# Eval protocol constants (`manydepth/evaluate_depth.py:32,296-297`).
MIN_DEPTH = 1e-3
MAX_DEPTH_KITTI = 80.0
MAX_DEPTH_DDAD = 200.0
STEREO_SCALE_FACTOR = 5.4

# Garg/eigen crop as fractions of (H, W) (`manydepth/evaluate_depth.py:230-237`)
EVAL_CROPS = {
    "eigen": (0.40810811, 0.99189189, 0.03594771, 0.96405229),
    # CityScapes center crop [256:, 192:1856] on 1024x2048 after 75% pre-crop
    "cityscapes": None,
}


def compute_depth_errors_np(gt: np.ndarray, pred: np.ndarray) -> dict:
    """The 7 metrics over flat, already-masked gt / pred vectors."""
    thresh = np.maximum(gt / pred, pred / gt)
    return dict(
        abs_rel=float(np.mean(np.abs(gt - pred) / gt)),
        sq_rel=float(np.mean((gt - pred) ** 2 / gt)),
        rmse=float(np.sqrt(np.mean((gt - pred) ** 2))),
        rmse_log=float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2))),
        a1=float(np.mean(thresh < 1.25)),
        a2=float(np.mean(thresh < 1.25 ** 2)),
        a3=float(np.mean(thresh < 1.25 ** 3)),
    )
