"""The plain reference of DynamicDepth's training step (Feng et al., ECCV
2022, github.com/AutoAILab/DynamicDepth), a frozen copy of the port's
`mal_tpu_torch/dynamic/` (`model.py`, `domd.py`, `warp.py`,
`cost_volume.py`, `step.py`) and of the parts of its `losses.py` and
`train/step.py` that they reach, on the ManyDepth reference's modules
(`models/`, `geometry`, `ops/`, `train/state.py`). It imports nothing of
the port, of JAX or of the JAX package. `runner.py` finds it by the
configuration's `method` and calls `build` and `make_train_step`.

Where it departs from the port:

- the occlusion-aware cost volume is the port's plain twin
  (`occlusion_aware_cost_volume`, `F.grid_sample` bilinear sampling) where
  the port launches kernel K6 (`plane_sweep_diffs_occ`) for `cv_set_1`
  and K1 otherwise, over all planes in one process;
- one process on the global batch: the port's data-parallel reductions
  (`parallel/mesh.py`) are plain means here;
- the step's draws (the matching augmentation's uniform, the automask
  noise) must come in `draws`; no generator draws them;
- not copied, and refused by `build`: the dilated splat
  (`domd_splat_dilate`), the feature-metric loss (`feat_loss`), online
  masks (`online_doj`), teacher-only training (`train_teacher_only`) and
  the evaluation forward;
- the weights start from torch's default initialisation, and the
  benchmark sets every one from the seed (`traffic.fill_weights`).
"""

from __future__ import annotations

import torch

from gpubench import traffic
from gpubench.reference.dynamicdepth.config import Config
from gpubench.reference.dynamicdepth.model import DynDepthModel
from gpubench.reference.dynamicdepth.step import make_train_step
from gpubench.reference.losses import LossBalancerState
from gpubench.reference.train.state import (DepthBinTracker, TrainState,
                                            make_optimizer)

__all__ = ["build", "make_train_step"]

NOT_COPIED = ("domd_splat_dilate", "feat_loss", "online_doj",
              "train_teacher_only")


def build(config: dict, seed: int, device: torch.device, batch: int):
    """(cfg, state, segmenter, seg_fn, names) of the reference at `batch`
    items, with the seed's weights; DynamicDepth has no segmenter."""
    port = {**config["port_config"], "batch_size": batch}
    refused = sorted(k for k in NOT_COPIED if port.get(k))
    if refused:
        raise NotImplementedError(f"the DynamicDepth reference does not copy "
                                  f"{refused}")
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in port.items()})
    with torch.device(device):
        model = DynDepthModel(cfg, device=device)
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(cfg, model),
                           bins=DepthBinTracker.create(device=device),
                           balancer=LossBalancerState.create(device=device))
    names = traffic.fill_weights([("model", model)], seed, device)
    return cfg, state, None, None, names
