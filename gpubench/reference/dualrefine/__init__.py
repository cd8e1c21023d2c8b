"""The plain reference of DualRefine's training step (Bangunharcana et al.,
CVPR 2023, github.com/antabangun/DualRefine), a frozen copy of the port's
`mal_tpu_torch/dualref/` (`model.py`, `hrnet.py`, `hr_decoder.py`,
`corr.py`, `reprojections.py`, `pose_update.py`, `update.py`, the Anderson
solve of `solvers.py`, `step.py`), of the parts of its `geometry.py`
(`geometry.py` here) and `train/state.py` (`state.py`: the depth bins with
the mean and median EMAs) that they reach, on the ManyDepth reference's
modules (`models/resnet.py`, `models/depth_decoder.py`, `geometry`,
`losses`, `ops/`, `train/`). It imports nothing of the port, of JAX or of
the JAX package. `runner.py` finds it by the configuration's `method` and
calls `build` and `make_train_step`.

Where it departs from the port:

- float32 only, and TF32 off (`runner.readings` turns it off);
- one process on the global batch: the port's data-parallel reductions
  (`parallel/mesh.py`) are plain means and norms here;
- the automask noise is the step's one draw, `draws["automask_noise"]`;
  no generator draws it;
- not copied, and refused by `build`: the implicit-function-theorem
  backward (`deq_ift`), the Barron-weighted Gauss-Newton step
  (`robust_pose_loss`), a solver other than Anderson or plain iteration
  (the port's Broyden solve has no caller in its model either), the bf16
  fast mode;
- the weights start from torch's default initialisation, and the
  benchmark sets every one from the seed (`traffic.fill_weights`).
"""

from __future__ import annotations

import torch

from gpubench import traffic
from gpubench.reference.dualrefine.config import Config
from gpubench.reference.dualrefine.model import DEQDepthPose
from gpubench.reference.dualrefine.state import DepthBinTracker
from gpubench.reference.dualrefine.step import make_train_step
from gpubench.reference.losses import LossBalancerState
from gpubench.reference.train.state import TrainState, make_optimizer

__all__ = ["build", "make_train_step"]

NOT_COPIED = ("deq_ift", "robust_pose_loss")
SOLVERS = ("anderson", "iteration")


def build(config: dict, seed: int, device: torch.device, batch: int):
    """(cfg, state, segmenter, seg_fn, names) of the reference at `batch`
    items, with the seed's weights; DualRefine has no segmenter."""
    port = {**config["port_config"], "batch_size": batch}
    refused = sorted(k for k in NOT_COPIED if port.get(k))
    if port.get("deq_solver", "anderson") not in SOLVERS:
        refused.append(f"deq_solver={port['deq_solver']!r}")
    if port.get("compute_dtype", "float32") != "float32":
        refused.append(f"compute_dtype={port['compute_dtype']!r}")
    if refused:
        raise NotImplementedError(f"the DualRefine reference does not copy "
                                  f"{refused}")
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in port.items()})
    with torch.device(device):
        model = DEQDepthPose(cfg, device=device)
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(cfg, model),
                           bins=DepthBinTracker.create(device=device),
                           balancer=LossBalancerState.create(device=device))
    names = traffic.fill_weights([("model", model)], seed, device)
    return cfg, state, None, None, names
