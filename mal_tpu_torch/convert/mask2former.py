"""detectron2 Mask2Former checkpoints (`.pkl`) both ways, for the port's
`Mask2Former`.

The reference builds its frozen segmenter from
`maskformer2_swin_large_IN21k_384_bs16_90k.yaml` and COCO-instance weights
(`manydepth/options.py:288-295`). A detectron2 checkpoint is a pickled
`{"model": {key: np.ndarray}, ...}`; the port's `Mask2Former` carries
detectron2's module names, so its state dict has exactly those keys and
loading is a strict copy. Counterpart of `mal_tpu/convert/mask2former.py`
(`load_pkl`, `convert_mask2former_pkl`, `export_mask2former_pkl`).
"""

from __future__ import annotations

import pickle
from typing import Mapping

import numpy as np
import torch

# keys of a detectron2 checkpoint that belong to training, not to the
# segmenter: the criterion's class weights
TRAINING_KEYS = ("criterion.empty_weight",)


def load_pkl(path: str) -> dict[str, np.ndarray]:
    """detectron2 .pkl checkpoint -> flat {key: np.ndarray}. Unpickling runs
    code: open only checkpoints from a source you trust."""
    with open(path, "rb") as f:
        obj = pickle.load(f, encoding="latin1")
    model = obj.get("model", obj)
    out = {}
    for k, v in model.items():
        if hasattr(v, "numpy"):
            v = v.numpy()
        out[k] = np.asarray(v)
    return out


def load_mask2former_state(model: torch.nn.Module,
                           sd: Mapping[str, np.ndarray]) -> None:
    """Fill `model` (a port `Mask2Former`) from a flat detectron2 state
    dict, strictly: every tensor of the model assigned, no key of `sd` left
    over but the training-only ones, every shape equal."""
    target = model.state_dict()
    missing = sorted(set(target) - set(sd))
    unused = sorted(set(sd) - set(target) - set(TRAINING_KEYS))
    if missing or unused:
        raise KeyError(f"Mask2Former tensors without a checkpoint key: "
                       f"{missing}; checkpoint keys without a tensor: {unused}")
    with torch.no_grad():
        for key, dst in target.items():
            src = torch.from_numpy(np.ascontiguousarray(sd[key]))
            if src.shape != dst.shape:
                raise ValueError(f"{key}: checkpoint {tuple(src.shape)} vs "
                                 f"model {tuple(dst.shape)}")
            dst.copy_(src)


def load_mask2former_pkl(model: torch.nn.Module, path: str) -> None:
    """Fill `model` from the detectron2 `.pkl` at `path`."""
    load_mask2former_state(model, load_pkl(path))


def export_mask2former_pkl(model: torch.nn.Module, path: str) -> str:
    """Write `model`'s weights as a detectron2-format `.pkl`
    ({"model": {key: np.ndarray}, "__author__": ...})."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "mal_tpu_torch"}, f)
    return path
