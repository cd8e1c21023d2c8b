"""DualRefine weights: `mal_tpu`'s flax trees and the reference's
`depth_pose.pth`, both into and out of the port's `DEQDepthPose`.

The port's modules carry the reference's names (`dualref/model.py`), so
its state dict is `depth_pose.pth` less the keys that file holds beyond
the model's:
- the extras: the four depth-bin statistics and the training size
  (`dualrefine/evaluate_depth.py:105-125`);
- modules the reference owns but never runs, which an export fills with
  shape-correct placeholders (`PLACEHOLDER_PREFIXES`): the dead pose MLP
  `update_block.encoder.convp{1,2}` (`update.py:97-98`), `pose_update.feats`
  and the orphan `pose_update.norm1` (`utils/utils.py:265,276-278`), and
  torchvision's classifier head in each pose trunk, `pnets.{s}.0.fc`.
A reference file therefore loads with a strict `load_state_dict` once
those are set aside (`load_dualrefine_checkpoint_dir`), and
`export_dualrefine_checkpoint_dir` writes them back.

`load_jax_dualref_variables(model, params, batch_stats)` carries
`mal_tpu`'s trees over: `export_depth_pose`, the port's copy of the numpy
`mal_tpu/convert/export_dualref.py:export_depth_pose` (with
`export_pth._conv_inv` and `export_resnet_trunk`), writes them in the
`depth_pose.pth` layout, and the load is strict both ways: every port
tensor assigned, every flax leaf read.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from mal_tpu_torch.dualref.hr_decoder import ALIAS_ORDER

EXTRA_KEYS = ("min_depth_bin", "max_depth_bin", "mean_depth_bin",
              "median_depth_bin", "height", "width")
PLACEHOLDER_PREFIXES = ("update_block.encoder.convp1.",
                        "update_block.encoder.convp2.",
                        "pose_update.norm1.", "pose_update.feats.",
                        "pnets.0.0.fc.", "pnets.1.0.fc.", "pnets.2.0.fc.")
_STAGE_LAYOUT = {2: (1, 2), 3: (4, 3), 4: (3, 4)}  # stage: (modules, branches)
_LAYER_BLOCKS = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3)}


# ---------------------------------------------------------------------------
# flax trees -> the `depth_pose.pth` layout (numpy)
# ---------------------------------------------------------------------------

def _conv_inv(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _linear_inv(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (1, 0))


def _put_bn(sd: dict, prefix: str, p: Mapping, s: Mapping):
    sd[prefix + ".weight"] = np.asarray(p["scale"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])
    sd[prefix + ".running_mean"] = np.asarray(s["mean"])
    sd[prefix + ".running_var"] = np.asarray(s["var"])
    sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _put_conv(sd: dict, prefix: str, p: Mapping, bias: bool = True):
    sd[prefix + ".weight"] = _conv_inv(p["kernel"])
    if bias:
        sd[prefix + ".bias"] = np.asarray(p["bias"])


def _put_convbn(sd: dict, conv_key: str, bn_key: str, p: Mapping,
                s: Mapping):
    sd[conv_key + ".weight"] = _conv_inv(p["conv"]["kernel"])
    _put_bn(sd, bn_key, p["bn"], s["bn"])


def _put_block(sd: dict, prefix: str, p: Mapping, s: Mapping, n_convs: int):
    """BasicBlock (2 convs) / Bottleneck (3 convs): bias-free convs + BN."""
    for ci in range(1, n_convs + 1):
        sd[f"{prefix}.conv{ci}.weight"] = _conv_inv(p[f"conv{ci}"]["kernel"])
        _put_bn(sd, f"{prefix}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
    if "downsample_conv" in p:
        sd[f"{prefix}.downsample.0.weight"] = _conv_inv(
            p["downsample_conv"]["kernel"])
        _put_bn(sd, f"{prefix}.downsample.1", p["downsample_bn"],
                s["downsample_bn"])


def _put_wnconv(sd: dict, prefix: str, p: Mapping):
    """WNConv {v, g, bias} -> torch weight_norm(dim=0) keys; without
    weight norm ({v, bias}) a plain `weight`."""
    if "g" in p:
        sd[prefix + ".weight_v"] = _conv_inv(p["v"])
        sd[prefix + ".weight_g"] = np.asarray(p["g"]).reshape(-1, 1, 1, 1)
    else:
        sd[prefix + ".weight"] = _conv_inv(p["v"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def export_hrnet_trunk(p: Mapping, s: Mapping,
                       prefix: str = "cnet_") -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    _put_convbn(sd, f"{prefix}layer0a.0", f"{prefix}layer0a.1",
                p["stem1"], s["stem1"])
    _put_convbn(sd, f"{prefix}layer0b.0", f"{prefix}layer0b.1",
                p["stem2"], s["stem2"])
    for b in range(4):
        _put_block(sd, f"{prefix}layer1.{b}", p[f"layer1_{b}"],
                   s[f"layer1_{b}"], n_convs=3)
    _put_convbn(sd, f"{prefix}transition1.0.0", f"{prefix}transition1.0.1",
                p["trans1_0"], s["trans1_0"])
    _put_convbn(sd, f"{prefix}transition1.1.0.0",
                f"{prefix}transition1.1.0.1", p["trans1_1"], s["trans1_1"])
    _put_convbn(sd, f"{prefix}transition2.2.0.0",
                f"{prefix}transition2.2.0.1", p["trans2_2"], s["trans2_2"])
    _put_convbn(sd, f"{prefix}transition3.3.0.0",
                f"{prefix}transition3.3.0.1", p["trans3_3"], s["trans3_3"])
    for stage, (n_mod, n_br) in _STAGE_LAYOUT.items():
        for m in range(n_mod):
            mp, ms = p[f"stage{stage}_m{m}"], s[f"stage{stage}_m{m}"]
            base = f"{prefix}stage{stage}.{m}"
            for i in range(n_br):
                for b in range(4):
                    _put_block(sd, f"{base}.branches.{i}.{b}",
                               mp[f"branch{i}_block{b}"],
                               ms[f"branch{i}_block{b}"], n_convs=2)
            for i in range(n_br):
                for j in range(n_br):
                    if j > i:
                        _put_convbn(sd, f"{base}.fuse_layers.{i}.{j}.0",
                                    f"{base}.fuse_layers.{i}.{j}.1",
                                    mp[f"fuse{i}_{j}"], ms[f"fuse{i}_{j}"])
                    elif j < i:
                        for k in range(i - j):
                            _put_convbn(
                                sd, f"{base}.fuse_layers.{i}.{j}.{k}.0",
                                f"{base}.fuse_layers.{i}.{j}.{k}.1",
                                mp[f"fuse{i}_{j}_{k}"], ms[f"fuse{i}_{j}_{k}"])
    return sd


def export_hr_decoder(p: Mapping,
                      prefix: str = "decoder.") -> dict[str, np.ndarray]:
    """The `convs` ModuleDict's keys, and the same tensors again under the
    `decoder` ModuleList's (`hr_depth_decoder.py:42`)."""
    sd: dict[str, np.ndarray] = {}
    c = prefix + "convs."
    for tag, name in (("72", "att72"), ("36", "att36"), ("18", "att18"),
                      ("9", "att9")):
        sd[f"{c}{tag}.ca.fc.0.weight"] = _linear_inv(
            p[name]["ca"]["fc1"]["kernel"])
        sd[f"{c}{tag}.ca.fc.2.weight"] = _linear_inv(
            p[name]["ca"]["fc2"]["kernel"])
        _put_conv(sd, f"{c}{tag}.conv_se", p[name]["conv_se"])
    for name in ("up_x9_0", "up_x9_1"):
        _put_conv(sd, f"{c}{name}.conv.conv", p[name]["conv"])
    for i in range(4):
        _put_conv(sd, f"{c}dispConvScale{i}.conv",
                  p[f"dispConvScale{i}"]["conv"])
    for n, tag in enumerate(ALIAS_ORDER):
        for k, v in list(sd.items()):
            if k.startswith(f"{c}{tag}."):
                sd[f"{prefix}decoder.{n}." + k[len(f"{c}{tag}."):]] = v
    return sd


def export_update_block(p: Mapping,
                        prefix: str = "update_block.") -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _put_wnconv(sd, f"{prefix}encoder.{name}", p["encoder"][name])
    for name in ("conv_net", "conv_inp", "w", "convz_glo", "convr_glo",
                 "convq_glo", "convq"):
        _put_wnconv(sd, f"{prefix}gru.{name}", p["gru"][name])
    _put_wnconv(sd, f"{prefix}conv_head.conv1", p["head_conv1"])
    _put_wnconv(sd, f"{prefix}conv_head.conv2", p["head_conv2"])
    _put_conv(sd, f"{prefix}mask.0", p["mask_conv1"])
    _put_conv(sd, f"{prefix}mask.2", p["mask_conv2"])
    if "weight_conv1" in p:
        _put_conv(sd, f"{prefix}weight.0", p["weight_conv1"])
        _put_conv(sd, f"{prefix}weight.2", p["weight_conv2"])
    return sd


def export_pose_weights(p: Mapping, s: Mapping,
                        prefix: str = "pose_update.") -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    for blk, tp in (("blk1", f"{prefix}weights.0.0"),
                    ("blk2", f"{prefix}weights.0.1")):
        for ci in (1, 2):
            _put_conv(sd, f"{tp}.conv{ci}", p[blk][f"conv{ci}"])
            _put_bn(sd, f"{tp}.norm{ci}", p[blk][f"norm{ci}"],
                    s[blk][f"norm{ci}"])
    sd[f"{prefix}weights.1.weight"] = _conv_inv(p["out"]["kernel"])
    return sd


def export_resnet_trunk(params: Mapping, stats: Mapping,
                        num_layers: int = 18,
                        prefix: str = "") -> dict[str, np.ndarray]:
    """`ResNetFeatures` params -> torchvision resnet state-dict keys."""
    sd: dict[str, np.ndarray] = {}
    sd[prefix + "conv1.weight"] = _conv_inv(params["conv1"]["kernel"])
    _put_bn(sd, prefix + "bn1", params["bn1"], stats["bn1"])
    n_convs = 3 if num_layers >= 50 else 2
    for layer in range(1, 5):
        for block in range(_LAYER_BLOCKS[num_layers][layer - 1]):
            name = f"layer{layer}_{block}"
            _put_block(sd, f"{prefix}layer{layer}.{block}", params[name],
                       stats[name], n_convs)
    return sd


def export_depth_pose(params: Mapping, stats: Mapping,
                      extras: Mapping | None = None) -> dict[str, np.ndarray]:
    """`mal_tpu`'s DEQDepthPose trees -> the model keys of
    `depth_pose.pth` (numpy), the decoder's ModuleList aliases included,
    plus `extras` (`EXTRA_KEYS`); the placeholders are not written here."""
    sd: dict[str, np.ndarray] = {}
    sd.update(export_hrnet_trunk(params["cnet"], stats["cnet"]))
    sd.update(export_hr_decoder(params["decoder"]))
    for name in ("conv2", "context", "hidden"):
        p = params[name]
        _put_conv(sd, name + ".0.conv1", p["res"]["conv1"])
        _put_conv(sd, name + ".0.conv2", p["res"]["conv2"])
        _put_conv(sd, name + ".1", p["out"])
    sd.update(export_update_block(params["update_block"]))
    sd.update(export_pose_weights(params["pose_weights"],
                                  stats["pose_weights"]))
    for name in ("delta", "delta_p"):
        if name in params["reproject_2"]:
            sd[f"reproject_2.{name}"] = np.asarray(params["reproject_2"][name])
    for side in range(3):
        sd.update(export_resnet_trunk(params[f"pose_trunk_{side}"],
                                      stats[f"pose_trunk_{side}"], 18,
                                      prefix=f"pnets.{side}.0."))
        head = params[f"pose_head_{side}"]
        for ours, ref in (("squeeze", "squeeze"), ("pose_0", "pose0"),
                          ("pose_1", "pose1"), ("pose_2", "pose2")):
            _put_conv(sd, f"pnets.{side}.1.{ref}", head[ours])
    for k in EXTRA_KEYS:
        if extras and k in extras:
            sd[k] = np.asarray(extras[k])
    return sd


class _Tracked(Mapping):
    """A read-only view of a nested dict that records every leaf read."""

    def __init__(self, tree: Mapping, seen: set, path: tuple = ()):
        self._tree, self._seen, self._path = tree, seen, path

    def __getitem__(self, key):
        v = self._tree[key]
        if isinstance(v, Mapping):
            return _Tracked(v, self._seen, self._path + (key,))
        self._seen.add(self._path + (key,))
        return v

    def __iter__(self) -> Iterator:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def _leaf_paths(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _model_keys(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def assign_strict(model: torch.nn.Module, sd: Mapping[str, Any],
                  what: str) -> None:
    """Copy `sd` into `model` (a `DEQDepthPose` or one of its modules):
    every model tensor (BN step counters aside) must be there, and no key
    of `sd` left over."""
    target = _model_keys(model)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    missing = sorted(set(target) - set(sd))
    unused = sorted(set(sd) - set(target))
    if missing or unused:
        raise KeyError(f"{what}: model tensors without a source: {missing}; "
                       f"source keys without a model tensor: {unused}")
    with torch.no_grad():
        for key, dst in target.items():
            src = torch.as_tensor(np.asarray(sd[key]))
            if src.shape != dst.shape:
                raise ValueError(f"{key}: source {tuple(src.shape)} vs model "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)


def load_jax_dualref_variables(model: torch.nn.Module, params: Mapping,
                               batch_stats: Mapping) -> None:
    """Fill `model` (a port `DEQDepthPose`) from `mal_tpu`'s DEQDepthPose
    `params` / `batch_stats` (nested dicts of arrays)."""
    seen: set = set()
    sd = export_depth_pose(_Tracked(params, seen, ("params",)),
                           _Tracked(batch_stats, seen, ("batch_stats",)))
    unread = (set(_leaf_paths(params, ("params",)))
              | set(_leaf_paths(batch_stats, ("batch_stats",)))) - seen
    if unread:
        raise KeyError(f"flax leaves without a port tensor: "
                       f"{sorted('/'.join(p) for p in unread)}")
    assign_strict(model, sd, "mal_tpu variables")


# ---------------------------------------------------------------------------
# `depth_pose.pth` both ways
# ---------------------------------------------------------------------------

def _placeholders(ch: int = 64) -> dict[str, torch.Tensor]:
    """Shape-correct stand-ins for the modules the reference owns and never
    runs, as `mal_tpu/convert/export_dualref.py` writes them: zeros, unit
    weight-norm gains, identity BNs."""
    sd: dict[str, torch.Tensor] = {}

    def identity_bn(prefix: str):
        sd[prefix + "weight"] = torch.ones(ch)
        sd[prefix + "bias"] = torch.zeros(ch)
        sd[prefix + "running_mean"] = torch.zeros(ch)
        sd[prefix + "running_var"] = torch.ones(ch)
        sd[prefix + "num_batches_tracked"] = torch.tensor(0)

    for name, (o, i) in (("convp1", (128, 6)), ("convp2", (128, 128))):
        p = f"update_block.encoder.{name}."
        sd[p + "weight_v"] = torch.zeros(o, i)
        sd[p + "weight_g"] = torch.ones(o, 1)
        sd[p + "bias"] = torch.zeros(o)
    identity_bn("pose_update.norm1.")
    for tp in ("pose_update.feats.0.0.", "pose_update.feats.0.1."):
        for ci in (1, 2):
            sd[f"{tp}conv{ci}.weight"] = torch.zeros(ch, ch, 3, 3)
            sd[f"{tp}conv{ci}.bias"] = torch.zeros(ch)
            identity_bn(f"{tp}norm{ci}.")
    sd["pose_update.feats.1.weight"] = torch.zeros(16, ch, 1, 1)
    for side in range(3):
        sd[f"pnets.{side}.0.fc.weight"] = torch.zeros(1000, 512)
        sd[f"pnets.{side}.0.fc.bias"] = torch.zeros(1000)
    return sd


def export_dualrefine_checkpoint_dir(model: torch.nn.Module, folder: str,
                                     extras: Mapping[str, float]) -> str:
    """Write `model` (a port `DEQDepthPose`) as the reference's
    `depth_pose.pth` in `folder`, with the placeholders and `extras` (the
    bins' four statistics, height and width, stored as
    `mal_tpu/cli.py:cmd_export_pth` stores them). Returns the path."""
    os.makedirs(folder, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    sd.update(_placeholders())
    for k in EXTRA_KEYS:
        if k in extras:
            sd[k] = torch.from_numpy(np.asarray(extras[k]))
    path = os.path.join(folder, "depth_pose.pth")
    torch.save(sd, path)
    return path


def load_dualrefine_checkpoint_dir(model: torch.nn.Module,
                                   folder: str) -> dict[str, float]:
    """Fill `model` from `folder`'s `depth_pose.pth` (a reference file, or
    one `export_dualrefine_checkpoint_dir` wrote), strictly once the extras
    and the placeholders are set aside. Returns the extras, as numbers."""
    sd = torch.load(os.path.join(folder, "depth_pose.pth"), map_location="cpu",
                    weights_only=True)
    extras = {k: sd.pop(k).item() for k in EXTRA_KEYS if k in sd}
    sd = {k: v for k, v in sd.items() if not k.startswith(PLACEHOLDER_PREFIXES)}
    assign_strict(model, sd, os.path.join(folder, "depth_pose.pth"))
    return extras
