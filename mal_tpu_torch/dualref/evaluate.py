"""DualRefine evaluation (PyTorch).

Counterpart of `mal_tpu.dualref.evaluate`, the protocol of
`dualrefine/evaluate_depth.py:67-317`: `DEQDepthPose` on [frame 0,
frame -1] with invert=True and side 0 (`:177-178`), for
int(deq_iters * deq_eval_factor) iterations, blending through the
consistency mask; the refined full-resolution disparity `disp_0_1`, or the
initial `disp_0_0` where the lookup frame is the all-zero dummy
(`:169-181`), converted with the training depth range (`:183`). The crop,
median scaling and metrics are those of `mal_tpu_torch.eval.evaluate`.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from mal_tpu_torch import geometry
from mal_tpu_torch.config import Config
from mal_tpu_torch.device import batch_to_device
from mal_tpu_torch.eval.evaluate import check_model_device
from mal_tpu_torch.models.mal_model import to_nchw


def infer_disparities_dualref(model, batches: Iterable[dict], cfg: Config,
                              device: str | torch.device | None = None
                              ) -> np.ndarray:
    """The eval forward of `model` (a port `DEQDepthPose` on `device`) over
    host batches of numpy arrays; returns the (N, H, W) scaled
    disparities."""
    device = check_model_device(model, device)
    disps = []
    with torch.inference_mode():
        for host in batches:
            batch = batch_to_device(host, device)
            color = to_nchw(batch)["color"]
            out, _ = model(color["0"], color["-1"], batch["K"], invert=True,
                           train=False)
            zero_lookup = color["-1"].sum(dim=(1, 2, 3)) == 0
            disp = torch.where(zero_lookup[:, None, None, None],
                               out["disp_0_0"], out["disp_0_1"])
            scaled, _ = geometry.disp_to_depth(disp, cfg.min_depth,
                                               cfg.max_depth)
            disps.append(scaled[:, 0].cpu().numpy())
    return np.concatenate(disps, axis=0)
