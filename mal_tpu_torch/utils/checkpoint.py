"""Checkpoints: the port's resumable training state, and the reference's
per-net `.pth` layout both ways.

The resumable checkpoint takes the place of `mal_tpu`'s orbax pytree
(`mal_tpu/utils/checkpoint.py`): one `torch.save` of the model's state
dict, Adam's state, the depth-bin tracker, the loss balancer and the step,
in `<ckpt_dir>/step_NNNNNNNN/state.pt`, with the run's `config.json` in
`<ckpt_dir>`.

The reference layout is one file per sub-net (`encoder.pth` with the depth
bins and the training size, `depth.pth`, `mono_encoder.pth`,
`mono_depth.pth`, `pose_encoder.pth`, `pose.pth`;
`manydepth/networks/repdepth.py:76-99`, `manydepth/trainer.py:1605-1636`).
The port's sub-nets carry the reference's module names
(`mal_tpu_torch/convert/jax_params.py`), so each file is its sub-net's
state dict plus a few known extras, and loading is a strict
`load_state_dict` once those extras are set aside. `DynDepthModel` has the
same sub-nets and uses the same files.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from mal_tpu_torch.config import Config
from mal_tpu_torch.losses import LossBalancerState
from mal_tpu_torch.models.encoders import ResnetEncoder
from mal_tpu_torch.train.state import (DepthBinTracker, TrainState, adam,
                                       student_parameters)

STATE_FILE = "state.pt"
NETS = ("encoder", "depth", "mono_encoder", "mono_depth", "pose_encoder",
        "pose")
# keys a reference file may hold beside its sub-net's state dict: the depth
# bins and the training size in `encoder.pth`, and torchvision's classifier
# head in the ResNet encoders' files, which the reference freezes and never
# runs (`resnet_encoder.py:381-383`) but loads strictly
EXTRAS = {"encoder": ("min_depth_bin", "max_depth_bin", "height", "width"),
          "mono_encoder": ("encoder.fc.weight", "encoder.fc.bias"),
          "pose_encoder": ("encoder.fc.weight", "encoder.fc.bias")}


# ---------------------------------------------------------------------------
# The resumable training state
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: Config,
                    step: int | None = None) -> str:
    """Write `state` to `<ckpt_dir>/step_NNNNNNNN` (`step` defaults to
    `state.step`) and `cfg` to `<ckpt_dir>/config.json`. Returns the step
    directory."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{state.step if step is None else step:08d}")
    os.makedirs(path, exist_ok=True)
    torch.save({"step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "bins": dataclasses.asdict(state.bins),
                "frozen_backbone": state.frozen_backbone,
                "balancer": dataclasses.asdict(state.balancer)},
               os.path.join(path, STATE_FILE))
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Fill `state` (built for the same configuration) from the step
    directory `path`, in place, on the model's device; returns it."""
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    if saved.get("frozen_backbone", False):
        # DualRefine past its freeze epoch: the student's optimizer
        state.optimizer = adam(student_parameters(state.model), 0.0)
        state.frozen_backbone = True
    state.optimizer.load_state_dict(saved["optimizer"])
    # a checkpoint from before the mean / median EMAs keeps their start
    bins = dataclasses.asdict(DepthBinTracker.create(device=device))
    bins.update(saved["bins"])
    state.bins = DepthBinTracker(**bins)
    state.balancer = LossBalancerState(**saved["balancer"])
    state.step = int(saved["step"])
    return state


def load_config(ckpt_dir: str) -> Config:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return Config.from_json(f.read())


# ---------------------------------------------------------------------------
# The reference's per-net layout
# ---------------------------------------------------------------------------

def export_checkpoint_dir(model: torch.nn.Module, folder: str,
                          min_depth_bin: float, max_depth_bin: float,
                          height: int, width: int) -> list[str]:
    """`model` (a `MALModel` or a `DynDepthModel`) as the reference's
    per-net `.pth` files in `folder`, as `mal_tpu/convert/export_pth.py`
    writes them. The bins stay Python floats: DynamicDepth's bin restore does
    numpy arithmetic on them (`dynamicdepth/trainer.py:1410-1416`). Returns
    the written paths."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for name in NETS:
        module = getattr(model, name)
        if module is None:     # PoseCNN: no separate pose decoder
            continue
        sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
        if name == "encoder":
            sd.update(min_depth_bin=float(min_depth_bin),
                      max_depth_bin=float(max_depth_bin),
                      height=int(height), width=int(width))
        elif isinstance(module, ResnetEncoder):
            # zero placeholders for the classifier head that the reference
            # loads strictly (`mal_tpu/convert/export_pth.py:166-175`)
            sd["encoder.fc.weight"] = torch.zeros(1000, 512)
            sd["encoder.fc.bias"] = torch.zeros(1000)
        path = os.path.join(folder, f"{name}.pth")
        torch.save(sd, path)
        paths.append(path)
    return paths


def _load_into(module: torch.nn.Module, sd: dict, what: str) -> None:
    """`load_state_dict` that lets only BatchNorm's `num_batches_tracked`
    be absent, and no key be left over."""
    missing, unexpected = module.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{what}: missing {missing}, unexpected {unexpected}")


def load_pretrained(model: torch.nn.Module, folder: str,
                    models_to_load: tuple[str, ...] | None = None,
                    bins: DepthBinTracker | None = None) -> list[str]:
    """Fill `model`'s sub-nets from a reference-layout checkpoint directory:
    the per-net files, or one whole-model `model.pth` with `<net>.`
    prefixes. `models_to_load` names a subset (the `--models_to_load` /
    `--mono_weights_folder` filter, `manydepth/trainer.py:1638-1655`); the
    files of other nets are never opened. With `bins`, the depth bins of
    `encoder.pth` (or of `track.pth`, which takes precedence, as
    `mal_tpu/convert/torch_weights.py:252-254` reads it) are loaded into the
    tracker, in place. Returns the names of the loaded nets."""
    wanted = [n for n in NETS if getattr(model, n, None) is not None
              and (models_to_load is None or n in models_to_load)]
    whole = os.path.join(folder, "model.pth")
    if os.path.exists(whole):
        sd = torch.load(whole, map_location="cpu", weights_only=True)
        nets = {n: {k[len(n) + 1:]: v for k, v in sd.items()
                    if k.startswith(n + ".")} for n in wanted}
    else:
        nets = {n: torch.load(os.path.join(folder, f"{n}.pth"),
                              map_location="cpu", weights_only=True)
                for n in wanted}
    found: dict = {}
    for name, sd in nets.items():
        sd = dict(sd)
        for key in EXTRAS.get(name, ()):
            if key in sd:
                found[key] = sd.pop(key)
        _load_into(getattr(model, name), sd, f"{folder}: {name}")
    track = os.path.join(folder, "track.pth")
    if os.path.exists(track):
        found.update(torch.load(track, map_location="cpu", weights_only=True))
    if bins is not None and "min_depth_bin" in found:
        bins.load(found)
    return list(nets)


def _matching_key(key: str) -> str:
    """torchvision ResNet key -> the matching encoder's Sequential layout
    (`resnet_encoder.py:106-110`)."""
    for tv, port in (("conv1.", "layer0.0."), ("bn1.", "layer0.1."),
                     ("layer1.", "layer1.1.")):
        if key.startswith(tv):
            return port + key[len(tv):]
    return key


def load_imagenet_trunks(model: torch.nn.Module, sd: dict,
                         pose_cnn: bool = False) -> None:
    """`--weights_init pretrained`: the ResNet-18 trunks of `model` from a
    torchvision ImageNet state dict `sd` (`manydepth/networks/
    resnet_encoder.py:377`). The two-image pose encoder tiles `conv1` over
    the stacked images and divides by their count (`resnet_encoder.py:
    63-67`); `fc.*` is not used; the decoders and `reduce_conv` keep their
    weights."""
    trunk = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    targets = [(model.encoder, _matching_key, 1),
               (model.mono_encoder, lambda k: "encoder." + k, 1)]
    if not pose_cnn:
        targets.append((model.pose_encoder, lambda k: "encoder." + k, 2))
    for module, rename, n_images in targets:
        mapped = {rename(k): v for k, v in trunk.items()}
        if n_images > 1:
            key = rename("conv1.weight")
            mapped[key] = torch.cat([mapped[key]] * n_images, 1) / n_images
        target = module.state_dict()
        unexpected = sorted(set(mapped) - set(target))
        missing = [k for k in target if k not in mapped
                   and not k.startswith("reduce_conv.")
                   and not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise KeyError(f"ImageNet trunk: missing {missing}, unexpected "
                           f"{unexpected}")
        with torch.no_grad():
            for k, v in mapped.items():
                if v.shape != target[k].shape:
                    raise ValueError(f"{k}: {tuple(v.shape)} vs "
                                     f"{tuple(target[k].shape)}")
                target[k].copy_(v)
