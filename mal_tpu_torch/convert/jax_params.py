"""Carry `mal_tpu`'s flax weights into the port's `MALModel`.

`load_jax_variables(model, params, batch_stats)` takes the flax trees as
nested dicts of numpy arrays and fills the model strictly: every port tensor
is assigned and every flax leaf is consumed, or it raises. Layouts:
- conv kernel (kh, kw, I, O) -> (O, I, kh, kw); Dense kernel (I, O) -> (O, I)
- BatchNorm scale / bias -> weight / bias; batch_stats mean / var ->
  running_mean / running_var
- names -> the reference torch layout that the port's modules carry
  (torchvision `conv1` / `bn1` / `layerN.M.*`; the matching encoder's
  `layer0.0` / `layer0.1` / `layer1.1.*`; the decoders' `decoder.{i}`; the
  pose heads' `net.{i}`), as `mal_tpu/convert/export_pth.py` names them.
`port_name` exposes the name mapping, so a test can line up `mal_tpu`'s
gradients with `named_parameters()`. `load_jax_dynamic_variables` does the
same for the port's `DynDepthModel`, whose flax tree hoists the matching
encoder's trunk and `reduce_conv` to the top level.

`load_jax_mask2former(model, variables)` does the same for the frozen
segmenter: `mask2former_state_dict` turns `mal_tpu`'s Mask2Former variables
into the detectron2 keys that `mal_tpu/convert/mask2former.py:
export_mask2former_state` writes and the port's `Mask2Former` carries,
splitting each Swin stage's `nn.scan`-stacked block parameters per block.
`load_jax_maskformer_v1` fills the port's `MaskFormerV1` the same way
(the Swin as for Mask2Former; the v1 pixel decoder and standard decoder
under detectron2's names), and `load_jax_v1_module` any one of v1's
modules (a pixel decoder, the standard decoder, `PerPixelBaselineHead`).
`mal_tpu` reads no detectron2 file for v1, and neither does the port.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var"}
_POSE_HEAD = {"squeeze": 0, "pose_0": 1, "pose_1": 2, "pose_2": 3}


def _trunk(mods: tuple[str, ...]) -> str:
    """`ResNetFeatures` module path -> torchvision name."""
    if mods in (("conv1",), ("bn1",)):
        return mods[0]
    layer, block = re.fullmatch(r"layer(\d)_(\d+)", mods[0]).groups()
    sub = {"downsample_conv": "downsample.0",
           "downsample_bn": "downsample.1"}.get(mods[1], mods[1])
    return f"layer{layer}.{block}.{sub}"


def _matching(mods: tuple[str, ...]) -> str:
    """Matching-encoder path -> the reference's Sequential layout
    (`resnet_encoder.py:106-110`)."""
    if mods[0] == "reduce_conv":
        return "reduce_conv.0"
    name = _trunk(mods[1:])
    if name in ("conv1", "bn1"):
        return {"conv1": "layer0.0", "bn1": "layer0.1"}[name]
    if name.startswith("layer1."):
        return "layer1.1." + name[len("layer1."):]
    return name


def _decoder(mods: tuple[str, ...]) -> str:
    if mods[0] == "dispconv_0":
        return "decoder.10.conv"
    i, j = map(int, re.fullmatch(r"upconv_(\d)_(\d)", mods[0]).groups())
    return f"decoder.{2 * (4 - i) + j}.conv.conv"


def port_name(path: tuple[str, ...], pose_cnn: bool = False) -> str:
    """A flax leaf path (top-level net first, leaf name last) -> the port's
    state-dict key."""
    top, mods, leaf = path[0], tuple(path[1:-1]), path[-1]
    if top == "encoder":
        name = _matching(mods)
    elif top in ("depth", "mono_depth"):
        name = _decoder(mods)
    elif top == "pose":
        name = f"net.{_POSE_HEAD[mods[0]]}"
    elif top == "pose_encoder" and pose_cnn:
        name = ("pose_conv" if mods[0] == "pose_conv"
                else "net." + mods[0][len("conv_"):])
    elif top in ("mono_encoder", "pose_encoder") and mods[0] == "encoder":
        name = "encoder." + _trunk(mods[1:])
    else:
        raise KeyError(f"no port counterpart for {'/'.join(path)}")
    return f"{top}.{name}.{_LEAF[leaf]}"


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(params: Mapping, batch_stats: Mapping,
                       pose_cnn: bool = False) -> dict[str, np.ndarray]:
    """The flax trees as a flat state dict in the port's names and layouts."""
    sd: dict[str, np.ndarray] = {}
    for tree in (params, batch_stats):
        for path, arr in _leaves(tree):
            key = port_name(path, pose_cnn)
            if key in sd:
                raise KeyError(f"two flax leaves map to {key}")
            sd[key] = np.ascontiguousarray(
                _to_torch_layout(np.asarray(arr), path[-1]))
    return sd


def load_jax_variables(model: torch.nn.Module, params: Mapping,
                       batch_stats: Mapping) -> None:
    """Fill `model` (a port `MALModel`) from flax `params` / `batch_stats`."""
    _load_strict(model, flax_to_state_dict(params, batch_stats,
                                           model.cfg.pose_cnn))


def nest_dynamic_tree(params: Mapping, batch_stats: Mapping):
    """`mal_tpu`'s `DynDepthModel` trees in `MALModel`'s nesting: the bare
    trunk (top-level `encoder`) and `reduce_conv` under `encoder`, as
    `mal_tpu/convert/export_pth.py:export_dynamic_checkpoint_dir` re-nests
    them."""
    params, batch_stats = dict(params), dict(batch_stats)
    params["encoder"] = {"encoder": params.pop("encoder"),
                         "reduce_conv": params.pop("reduce_conv")}
    if "encoder" in batch_stats:
        batch_stats["encoder"] = {"encoder": batch_stats["encoder"]}
    return params, batch_stats


def load_jax_dynamic_variables(model: torch.nn.Module, params: Mapping,
                               batch_stats: Mapping) -> None:
    """Fill `model` (a port `DynDepthModel`) from `mal_tpu`'s DynDepthModel
    `params` / `batch_stats`, strictly: every tensor assigned, every leaf
    consumed."""
    _load_strict(model, flax_to_state_dict(*nest_dynamic_tree(params,
                                                              batch_stats)))


def _load_strict(model: torch.nn.Module, sd: dict[str, np.ndarray]) -> None:
    target = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    missing = sorted(set(target) - set(sd))
    unused = sorted(set(sd) - set(target))
    if missing or unused:
        raise KeyError(f"port tensors without a flax leaf: {missing}; "
                       f"flax leaves without a port tensor: {unused}")
    with torch.no_grad():
        for key, dst in target.items():
            src = torch.tensor(sd[key])
            if src.shape != dst.shape:
                raise ValueError(f"{key}: flax {tuple(src.shape)} vs port "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)


# ---------------------------------------------------------------------------
# The frozen Mask2Former segmenter
# ---------------------------------------------------------------------------

class _Leaves:
    """A flax tree's leaves by path, each taken at most once."""

    def __init__(self, tree: Mapping):
        self.left = {path: np.asarray(v) for path, v in _leaves(tree)}

    def take(self, *path: str) -> np.ndarray:
        try:
            return self.left.pop(path)
        except KeyError:
            raise KeyError(f"no flax leaf {'/'.join(path)}") from None

    def dense(self, sd: dict, key: str, *path: str, bias: bool = True):
        sd[key + ".weight"] = self.take(*path, "kernel").T
        if bias:
            sd[key + ".bias"] = self.take(*path, "bias")

    def conv(self, sd: dict, key: str, *path: str, bias: bool = True):
        sd[key + ".weight"] = self.take(*path, "kernel").transpose(3, 2, 0, 1)
        if bias:
            sd[key + ".bias"] = self.take(*path, "bias")

    def norm(self, sd: dict, key: str, *path: str):
        sd[key + ".weight"] = self.take(*path, "scale")
        sd[key + ".bias"] = self.take(*path, "bias")


def _swin_state(lv: _Leaves, size: str, sd: dict) -> None:
    from mal_tpu_torch.ops.cuda.window_attention import relative_position_index
    from mal_tpu_torch.segment.swin import CONFIGS

    _, depths, _, ws = CONFIGS[size]
    p = "backbone."
    lv.conv(sd, p + "patch_embed.proj", "backbone", "patch_embed")
    lv.norm(sd, p + "patch_embed.norm", "backbone", "patch_norm")
    for s, depth in enumerate(depths):
        # the stage's blocks are one nn.scan'd block: leading depth axis
        stacked = _Leaves({})
        prefix = ("backbone", f"stage{s}", "blocks")
        for path in [q for q in lv.left if q[:3] == prefix]:
            stacked.left[path[3:]] = lv.left.pop(path)
        if any(v.shape[0] != depth for v in stacked.left.values()):
            raise ValueError(f"stage {s} leaves are not stacked {depth} deep")
        for b in range(depth):
            blk = _Leaves({})
            blk.left = {k: v[b] for k, v in stacked.left.items()}
            bp = f"{p}layers.{s}.blocks.{b}."
            blk.norm(sd, bp + "norm1", "norm1")
            sd[bp + "attn.relative_position_bias_table"] = blk.take(
                "attn", "relative_position_bias_table")
            sd[bp + "attn.relative_position_index"] = relative_position_index(ws)
            blk.dense(sd, bp + "attn.qkv", "attn", "qkv")
            blk.dense(sd, bp + "attn.proj", "attn", "proj")
            blk.norm(sd, bp + "norm2", "norm2")
            blk.dense(sd, bp + "mlp.fc1", "mlp_fc1")
            blk.dense(sd, bp + "mlp.fc2", "mlp_fc2")
            if blk.left:
                raise KeyError(f"stage {s} block leaves without a port "
                               f"tensor: {sorted(blk.left)}")
        if s < 3:
            lv.norm(sd, f"{p}layers.{s}.downsample.norm", "backbone",
                    f"merge{s}", "norm")
            lv.dense(sd, f"{p}layers.{s}.downsample.reduction", "backbone",
                     f"merge{s}", "reduction", bias=False)
        lv.norm(sd, f"{p}norm{s}", "backbone", f"out_norm{s}")


def _pixel_decoder_state(lv: _Leaves, sd: dict) -> None:
    p, t = "sem_seg_head.pixel_decoder.", "pixel_decoder"
    for i in range(3):
        lv.conv(sd, f"{p}input_proj.{i}.0", t, f"input_proj_{i}")
        lv.norm(sd, f"{p}input_proj.{i}.1", t, f"input_proj_gn_{i}")
    sd[p + "transformer.level_embed"] = lv.take(t, "level_embed")
    layers = sorted({k[1] for k in lv.left if k[0] == t
                     and re.fullmatch(r"layer_\d+", k[1])},
                    key=lambda n: int(n[len("layer_"):]))
    for l, name in enumerate(layers):
        lp = f"{p}transformer.encoder.layers.{l}."
        for sub in ("sampling_offsets", "attention_weights", "value_proj",
                    "output_proj"):
            lv.dense(sd, lp + "self_attn." + sub, t, name, "self_attn", sub)
        lv.norm(sd, lp + "norm1", t, name, "norm1")
        lv.dense(sd, lp + "linear1", t, name, "linear1")
        lv.dense(sd, lp + "linear2", t, name, "linear2")
        lv.norm(sd, lp + "norm2", t, name, "norm2")
    lv.conv(sd, p + "adapter_1", t, "fpn_adapter", bias=False)
    lv.norm(sd, p + "adapter_1.norm", t, "adapter_gn")
    lv.conv(sd, p + "layer_1", t, "fpn_conv", bias=False)
    lv.norm(sd, p + "layer_1.norm", t, "layer_gn")
    lv.conv(sd, p + "mask_features", t, "mask_features")


def _predictor_state(lv: _Leaves, sd: dict) -> None:
    p, t = "sem_seg_head.predictor.", "predictor"
    for name in ("query_feat", "query_embed", "level_embed"):
        sd[f"{p}{name}.weight"] = lv.take(t, name)
    lv.norm(sd, p + "decoder_norm", t, "decoder_norm")
    lv.dense(sd, p + "class_embed", t, "class_embed")
    for i in range(3):
        lv.dense(sd, f"{p}mask_embed.layers.{i}", t, "mask_embed", f"fc{i}")

    def mha(key: str, name: str):
        # torch's packed in_proj: q, k, v stacked on the output axis
        sd[key + ".in_proj_weight"] = np.concatenate(
            [lv.take(t, name, n, "kernel").T for n in "qkv"])
        sd[key + ".in_proj_bias"] = np.concatenate(
            [lv.take(t, name, n, "bias") for n in "qkv"])
        lv.dense(sd, key + ".out_proj", t, name, "out")

    n_layers = len({k[1] for k in lv.left if k[0] == t
                    and k[1].startswith("xattn_")})
    for l in range(n_layers):
        x = f"{p}transformer_cross_attention_layers.{l}."
        mha(x + "multihead_attn", f"xattn_{l}")
        lv.norm(sd, x + "norm", t, f"xnorm_{l}")
        s = f"{p}transformer_self_attention_layers.{l}."
        mha(s + "self_attn", f"sattn_{l}")
        lv.norm(sd, s + "norm", t, f"snorm_{l}")
        f = f"{p}transformer_ffn_layers.{l}."
        lv.dense(sd, f + "linear1", t, f"ffn1_{l}")
        lv.dense(sd, f + "linear2", t, f"ffn2_{l}")
        lv.norm(sd, f + "norm", t, f"fnorm_{l}")


def mask2former_state_dict(params: Mapping, size: str = "large"
                           ) -> dict[str, np.ndarray]:
    """`mal_tpu` Mask2Former params -> the detectron2-key state dict of the
    port's `Mask2Former` (the `relative_position_index` buffers included,
    as detectron2 checkpoints carry them). Raises if a leaf is left over."""
    lv = _Leaves(params)
    sd: dict[str, np.ndarray] = {}
    _swin_state(lv, size, sd)
    _pixel_decoder_state(lv, sd)
    _predictor_state(lv, sd)
    if lv.left:
        raise KeyError(f"flax leaves without a port tensor: "
                       f"{sorted('/'.join(k) for k in lv.left)}")
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def load_jax_mask2former(model: torch.nn.Module, variables: Mapping) -> None:
    """Fill `model` (a port `Mask2Former`, frozen or trainable, best built
    with `init_weights=False`) from `mal_tpu`'s flax variables ({"params":
    ...}, numpy): every tensor assigned, every leaf consumed."""
    _load_strict(model, mask2former_state_dict(variables["params"],
                                               model.swin_size))


# ---------------------------------------------------------------------------
# MaskFormer v1 (`segment/maskformer_v1.py`)
# ---------------------------------------------------------------------------

def _mha_state(lv: _Leaves, sd: dict, key: str, *path: str) -> None:
    """flax q / k / v / out Denses -> torch's packed in_proj and out_proj."""
    sd[key + ".in_proj_weight"] = np.concatenate(
        [lv.take(*path, n, "kernel").T for n in "qkv"])
    sd[key + ".in_proj_bias"] = np.concatenate(
        [lv.take(*path, n, "bias") for n in "qkv"])
    lv.dense(sd, key + ".out_proj", *path, "out")


def _numbered(lv: _Leaves, path: tuple, stem: str) -> int:
    """How many `{stem}{i}` children the flax tree has at `path`."""
    n = len(path)
    return len({k[n] for k in lv.left if k[:n] == path
                and re.fullmatch(stem + r"\d+", k[n])})


def _v1_pixel_decoder_state(lv: _Leaves, sd: dict, p: str, t: tuple,
                            names: list[str]) -> None:
    """FPN / transformer-encoder pixel decoder: flax `adapter_{f}`,
    `layer_{f}`, `layer_coarse` (each with its `_norm`), `mask_features`,
    `input_proj` and `enc_{l}` -> detectron2's `adapter_{i}`, `layer_{i}`,
    `layer_{top}`, `transformer.encoder.layers.{l}`."""
    for i, f in enumerate(names[:-1]):
        for ours, theirs in ((f"adapter_{i + 1}", f"adapter_{f}"),
                             (f"layer_{i + 1}", f"layer_{f}")):
            lv.conv(sd, p + ours, *t, theirs, bias=False)
            lv.norm(sd, p + ours + ".norm", *t, theirs + "_norm")
    top = f"layer_{len(names)}"
    lv.conv(sd, p + top, *t, "layer_coarse", bias=False)
    lv.norm(sd, p + top + ".norm", *t, "layer_coarse_norm")
    lv.conv(sd, p + "mask_features", *t, "mask_features")
    layers = _numbered(lv, t, "enc_")
    if layers:
        lv.conv(sd, p + "input_proj", *t, "input_proj")
    for l in range(layers):
        lp, lt = f"{p}transformer.encoder.layers.{l}.", t + (f"enc_{l}",)
        _mha_state(lv, sd, lp + "self_attn", *lt, "self_attn")
        for sub in ("linear1", "linear2"):
            lv.dense(sd, lp + sub, *lt, sub)
        for sub in ("norm1", "norm2"):
            lv.norm(sd, lp + sub, *lt, sub)


def _v1_predictor_state(lv: _Leaves, sd: dict, p: str, t: tuple) -> None:
    """StandardTransformerDecoder: flax `dec_{l}` (`cross_attn` the
    detectron2 `multihead_attn`), `decoder_norm`, `query_embed`,
    `class_embed`, `mask_embed/fc{i}` and the optional `input_proj`."""
    if (*t, "input_proj", "kernel") in lv.left:
        lv.conv(sd, p + "input_proj", *t, "input_proj")
    sd[p + "query_embed.weight"] = lv.take(*t, "query_embed")
    for l in range(_numbered(lv, t, "dec_")):
        lp, lt = f"{p}transformer.decoder.layers.{l}.", t + (f"dec_{l}",)
        _mha_state(lv, sd, lp + "self_attn", *lt, "self_attn")
        _mha_state(lv, sd, lp + "multihead_attn", *lt, "cross_attn")
        for sub in ("linear1", "linear2"):
            lv.dense(sd, lp + sub, *lt, sub)
        for sub in ("norm1", "norm2", "norm3"):
            lv.norm(sd, lp + sub, *lt, sub)
    lv.norm(sd, p + "transformer.decoder.norm", *t, "decoder_norm")
    lv.dense(sd, p + "class_embed", *t, "class_embed")
    for i in range(_numbered(lv, t + ("mask_embed",), "fc")):
        lv.dense(sd, f"{p}mask_embed.layers.{i}", *t, "mask_embed", f"fc{i}")


def _finish(lv: _Leaves, sd: dict) -> dict[str, np.ndarray]:
    if lv.left:
        raise KeyError(f"flax leaves without a port tensor: "
                       f"{sorted('/'.join(k) for k in lv.left)}")
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def maskformer_v1_state_dict(params: Mapping, size: str = "tiny"
                             ) -> dict[str, np.ndarray]:
    """`mal_tpu` MaskFormerV1 params -> the state dict of the port's
    `MaskFormerV1` (detectron2's keys). Raises if a leaf is left over."""
    from mal_tpu_torch.segment.maskformer_v1 import FEATURES

    lv = _Leaves(params)
    sd: dict[str, np.ndarray] = {}
    _swin_state(lv, size, sd)
    _v1_pixel_decoder_state(lv, sd, "sem_seg_head.pixel_decoder.",
                            ("pixel_decoder",), list(FEATURES))
    _v1_predictor_state(lv, sd, "sem_seg_head.predictor.", ("predictor",))
    return _finish(lv, sd)


def load_jax_maskformer_v1(model: torch.nn.Module, variables: Mapping
                           ) -> None:
    """Fill `model` (a port `MaskFormerV1`, best built with
    `init_weights=False`) from `mal_tpu`'s flax variables ({"params":
    ...}, numpy): every tensor assigned, every leaf consumed."""
    _load_strict(model, maskformer_v1_state_dict(variables["params"],
                                                 model.swin_size))


def load_jax_v1_module(module: torch.nn.Module, variables: Mapping) -> None:
    """Fill one MaskFormer-v1 module of the port (`FPNPixelDecoder`,
    `TransformerEncoderPixelDecoder`, `StandardTransformerDecoder` or
    `PerPixelBaselineHead`) from the variables of its `mal_tpu`
    counterpart, strictly."""
    from mal_tpu_torch.segment import maskformer_v1 as v1

    lv = _Leaves(variables["params"])
    sd: dict[str, np.ndarray] = {}
    if isinstance(module, v1.PerPixelBaselineHead):
        _v1_pixel_decoder_state(lv, sd, "pixel_decoder.", ("pixel_decoder",),
                                module.pixel_decoder.names)
        lv.conv(sd, "predictor", "predictor")
    elif isinstance(module, v1.FPNPixelDecoder):
        _v1_pixel_decoder_state(lv, sd, "", (), module.names)
    elif isinstance(module, v1.StandardTransformerDecoder):
        _v1_predictor_state(lv, sd, "", ())
    else:
        raise TypeError(f"not a MaskFormer-v1 module: {type(module).__name__}")
    _load_strict(module, _finish(lv, sd))
