"""Kernel K5, multi-scale deformable attention sampling, as a CUDA kernel
for Hopper.

Counterpart of `mal_tpu.segment.msdeform.ms_deform_attn_core` (which calls
the Pallas TPU kernel `deform_sample_fused_v4` on the TPU). The kernel
source is `mal_tpu_torch/csrc/deform_sample.cu`; its header says what
bounds it and how it is laid out.

- `ms_deform_attn_core`: the kernel's wrapper. For CUDA tensors it checks
  them and launches the kernel, counting each launch in
  `ms_deform_attn_core.launches`; for CPU tensors it returns the plain
  version. It never falls back from the kernel to the plain version. K5 has
  two kernels, and `staged_channels` picks one from the shapes before the
  launch: the staged kernel, which samples from a (batch, head) slice of 8
  channels held in shared memory, wherever such a slice fits; the gather
  kernel, which samples from device memory, elsewhere.
- `ms_deform_attn_core_per_level`: the plain PyTorch version, one
  `grid_sample` per level (`mal_tpu/segment/msdeform.py:27-52`).
- `deform_sample_fused` (kernel K5b) and `deform_sample_fused_reference`:
  the same sampling in the sample-major layout of the Pallas kernel
  `mal_tpu.ops.pallas.deform_sample.deform_sample_fused` (v2), summed over
  levels but not over points. `mal_tpu` has no caller of that kernel
  (`segment/msdeform.py:84` imports only v4), and neither has the port: it
  is an entry point of its own. K5b has two kernels too, and
  `major_staged_channels` picks one from the shapes: the staged kernel,
  which samples from a (group, 8-channel) slice held in shared memory,
  wherever such a slice fits; the gather kernel elsewhere. Its `route=`
  names either, for timing one against the other.

`mal_tpu`'s `mxu_precision` ("high" or "bf16") chooses how many bf16 passes
the TPU's matrix unit spends on the one-hot interpolation products of these
kernels. The CUDA kernels gather in fp32 and have no such product, so they
compute the same exact values in fast mode as in fp32 mode: exact where the
TPU kernel is approximate.
"""

from __future__ import annotations

import ctypes

import torch

from mal_tpu_torch.ops.cuda import refuse_grad
from mal_tpu_torch.ops.interp import grid_sample

Tensor = torch.Tensor

SOURCE = "deform_sample"
_MAX_LEVELS = 4
# shared memory a block may take on an H100 (sm_90): 227 KB
_SMEM_BYTES = 232448
_STAGED_POINTS = 4  # the most points a level the staged kernel takes
_STAGED_CHANNELS = 8  # channels of a slice the staged kernel holds


def staged_channels(tokens: int, ch: int, points: int) -> int | None:
    """Channels a block of K5's staged kernel takes from a (batch, head)
    slice of `tokens` value tokens of `ch` channels: 8, where `ch` is a
    multiple of 8, the slice fits in a block's shared memory (up to 7,264
    tokens) and a level has at most 4 `points`; else None, and the gather
    kernel runs."""
    if (points > _STAGED_POINTS or ch % _STAGED_CHANNELS
            or tokens * _STAGED_CHANNELS * 4 > _SMEM_BYTES):
        return None
    return _STAGED_CHANNELS


def major_staged_channels(tokens: int, ch: int) -> int | None:
    """Channels a block of K5b's staged kernel takes from a group's slice
    of `tokens` value tokens (the three levels') of `ch` channels: 8, where
    `ch` is a multiple of 8 and the slice fits in a block's shared memory
    (up to 7,264 tokens); else None, and the gather kernel runs."""
    if ch % _STAGED_CHANNELS or tokens * _STAGED_CHANNELS * 4 > _SMEM_BYTES:
        return None
    return _STAGED_CHANNELS


def ms_deform_attn_core_per_level(value: Tensor,
                                  spatial_shapes: list[tuple[int, int]],
                                  sampling_locations: Tensor,
                                  attention_weights: Tensor) -> Tensor:
    """Deformable sampling, plain torch.

    value (B, sum(HW), heads, ch); sampling_locations (B, Lq, heads, L, P, 2)
    as (x, y) in [0, 1]; attention_weights (B, Lq, heads, L, P). Returns
    (B, Lq, heads * ch): per level, a bilinear sample with zeros padding
    and align_corners=False, weighted and summed over levels and points.
    """
    B, _, H_, C = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    values = value.split([h * w for h, w in spatial_shapes], dim=1)
    out = 0.0
    for lvl, (h, w) in enumerate(spatial_shapes):
        # heads fold into the batch: each head samples its own value slice
        v = values[lvl].reshape(B, h, w, H_, C).permute(0, 3, 4, 1, 2)
        v = v.reshape(B * H_, C, h, w)
        g = 2.0 * sampling_locations[:, :, :, lvl] - 1.0   # (B, Lq, H_, P, 2)
        g = g.permute(0, 2, 1, 3, 4).reshape(B * H_, Lq, P, 2)
        sampled = grid_sample(v, g, padding_mode="zeros", align_corners=False)
        sampled = sampled.reshape(B, H_, C, Lq, P)
        w_l = attention_weights[:, :, :, lvl]              # (B, Lq, H_, P)
        out = out + torch.einsum("bhclp,blhp->blhc", sampled, w_l)
    return out.reshape(B, Lq, H_ * C)


def _check(value: Tensor, spatial_shapes, loc: Tensor, aw: Tensor) -> None:
    """Raise on anything the kernel does not take."""
    for name, x in {"value": value, "sampling_locations": loc,
                    "attention_weights": aw}.items():
        if x.device != value.device:
            raise ValueError(f"{name} is on {x.device}, value on {value.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if value.dim() != 4 or loc.dim() != 6 or aw.dim() != 5:
        raise ValueError("value, sampling_locations, attention_weights must be "
                         "(B, S, heads, ch), (B, Lq, heads, L, P, 2), "
                         "(B, Lq, heads, L, P)")
    B, S, H_, C = value.shape
    _, Lq, _, L, P, _ = loc.shape
    if not 1 <= L <= _MAX_LEVELS or len(spatial_shapes) != L:
        raise ValueError(f"{len(spatial_shapes)} shapes for {L} levels; the "
                         f"kernel takes 1 to {_MAX_LEVELS}")
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"levels {spatial_shapes} do not sum to {S} tokens")
    if loc.shape != (B, Lq, H_, L, P, 2) or aw.shape != (B, Lq, H_, L, P):
        raise ValueError(f"locations {tuple(loc.shape)} / weights "
                         f"{tuple(aw.shape)} do not fit value {tuple(value.shape)}")
    if H_ * C > 1024:
        raise ValueError(f"heads x channels = {H_ * C} is above 1024")


def _library() -> ctypes.CDLL:
    from mal_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    fn = lib.deform_sample_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.POINTER(ctypes.c_int)] * 3
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.deform_sample_staged_f32.argtypes = fn.argtypes
        lib.deform_sample_staged_f32.restype = ctypes.c_int
        lib.deform_sample_major_f32.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)] * 2
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.deform_sample_major_f32.restype = ctypes.c_int
        lib.deform_sample_major_staged_f32.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)] * 2
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.deform_sample_major_staged_f32.restype = ctypes.c_int
        lib.deform_sample_error_string.argtypes = [ctypes.c_int]
        lib.deform_sample_error_string.restype = ctypes.c_char_p
    return lib


def ms_deform_attn_core(value: Tensor, spatial_shapes: list[tuple[int, int]],
                        sampling_locations: Tensor,
                        attention_weights: Tensor) -> Tensor:
    """Deformable sampling (B, Lq, heads * ch); arguments as
    `ms_deform_attn_core_per_level`. CUDA tensors go to the kernel, CPU
    tensors to the plain version."""
    refuse_grad("ms_deform_attn_core", value, sampling_locations,
                attention_weights)
    if value.device.type == "cpu":
        return ms_deform_attn_core_per_level(value, spatial_shapes,
                                             sampling_locations,
                                             attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"unsupported device {value.device}")
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, H_, C = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    out = torch.empty((B, Lq, H_ * C), dtype=torch.float32, device=value.device)
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    ints = ctypes.c_int * L
    lib = _library()
    staged = staged_channels(S, C, P) is not None
    if staged and value.data_ptr() % 16:
        raise ValueError("value must be 16-byte aligned")
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(),
                ints(*(h for h, _ in spatial_shapes)),
                ints(*(w for _, w in spatial_shapes)), ints(*starts),
                B, S, Lq, H_, C, L, P)
        launch = (lib.deform_sample_staged_f32 if staged
                  else lib.deform_sample_f32)
        err = launch(*args, stream)
    if err:
        msg = lib.deform_sample_error_string(err).decode()
        raise RuntimeError(f"ms_deform_attn_core launch failed: {msg} ({err})")
    ms_deform_attn_core.launches += 1
    return out


ms_deform_attn_core.launches = 0


def deform_sample_fused_reference(vm0: Tensor, vm1: Tensor, vm2: Tensor,
                                  x: Tensor, y: Tensor, aw: Tensor,
                                  shapes: tuple[tuple[int, int], ...],
                                  ch: int) -> Tensor:
    """K5b in plain torch.

    vm_l (G, h_l * ch, w_l): the level's values per (batch x head) group,
    row r of the level in rows r * ch .. r * ch + ch; x, y, aw (G, T, 3, S):
    sampling coordinates in [0, 1] and attention weights per level (pad
    samples carry aw = 0). Returns (G, T, ch, S): the bilinear samples
    (zeros padding, align_corners=False), weighted and summed over levels.
    """
    G, T, L, S = x.shape
    out = 0.0
    for lvl, (vm, (h, w)) in enumerate(zip((vm0, vm1, vm2), shapes,
                                           strict=True)):
        v = vm.reshape(G, h, ch, w).permute(0, 1, 3, 2).reshape(G, h * w, ch)
        xs = x[:, :, lvl].reshape(G, T * S) * w - 0.5
        ys = y[:, :, lvl].reshape(G, T * S) * h - 0.5
        x0, y0 = xs.floor(), ys.floor()
        wx1, wy1 = xs - x0, ys - y0
        acc = 0.0
        for yi, wy in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
            for xi, wx in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
                inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
                val = v.gather(1, idx[..., None].expand(-1, -1, ch))
                acc = acc + val * (wy * wx * inside)[..., None]
        out = out + acc * aw[:, :, lvl].reshape(G, T * S, 1)
    return out.reshape(G, T, S, ch).permute(0, 1, 3, 2).contiguous()


def deform_sample_fused(vm0: Tensor, vm1: Tensor, vm2: Tensor, x: Tensor,
                        y: Tensor, aw: Tensor,
                        shapes: tuple[tuple[int, int], ...], ch: int, *,
                        route: str | None = None) -> Tensor:
    """K5b (G, T, ch, S); arguments as `deform_sample_fused_reference`.
    CUDA tensors go to the kernel of `route` ("staged" or "gather"; by
    default "staged" where `major_staged_channels` gives a slice), CPU
    tensors to the plain version."""
    refuse_grad("deform_sample_fused", vm0, vm1, vm2, x, y, aw)
    if x.device.type == "cpu":
        return deform_sample_fused_reference(vm0, vm1, vm2, x, y, aw, shapes,
                                             ch)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tensors = {"vm0": vm0, "vm1": vm1, "vm2": vm2, "x": x, "y": y, "aw": aw}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 4 or x.shape[2] != 3 or len(shapes) != 3:
        raise ValueError(f"x {tuple(x.shape)} must be (G, T, 3, S) with 3 "
                         f"level shapes")
    G, T, L, S = x.shape
    if y.shape != x.shape or aw.shape != x.shape:
        raise ValueError("x, y and aw must have one shape")
    for vm, (h, w) in zip((vm0, vm1, vm2), shapes):
        if tuple(vm.shape) != (G, h * ch, w):
            raise ValueError(f"level values {tuple(vm.shape)} must be "
                             f"{(G, h * ch, w)}")
    staged = major_staged_channels(sum(h * w for h, w in shapes), ch)
    if route is None:
        route = "gather" if staged is None else "staged"
    elif route not in ("staged", "gather") or (route == "staged"
                                               and staged is None):
        raise ValueError(f"route {route!r} does not take {ch} channels of "
                         f"levels {shapes}")
    out = torch.empty((G, T, ch, S), dtype=torch.float32, device=x.device)
    ints = ctypes.c_int * L
    lib = _library()
    with torch.cuda.device(x.device):
        args = (vm0.data_ptr(), vm1.data_ptr(), vm2.data_ptr(), x.data_ptr(),
                y.data_ptr(), aw.data_ptr(), out.data_ptr(),
                ints(*(h for h, _ in shapes)), ints(*(w for _, w in shapes)),
                G, T, S, ch)
        stream = torch.cuda.current_stream().cuda_stream
        if route == "staged":
            err = lib.deform_sample_major_staged_f32(
                *args, x.device.index, stream)
        else:
            err = lib.deform_sample_major_f32(*args, stream)
    if err:
        msg = lib.deform_sample_error_string(err).decode()
        raise RuntimeError(f"deform_sample_fused launch failed: {msg} ({err})")
    deform_sample_fused.launches += 1
    return out


deform_sample_fused.launches = 0
