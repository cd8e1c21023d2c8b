"""Kernel K4, Swin window attention, as a CUDA kernel for Hopper.

Counterpart of `mal_tpu.ops.pallas.window_attention.window_attention_fused`
(the Pallas TPU kernel the unfused `WindowAttention` calls on the TPU,
`mal_tpu/segment/swin.py:86-106`). The kernel source is
`mal_tpu_torch/csrc/window_attention.cu`; its header says what bounds it
and how it is laid out.

- `window_attention`: the kernel's wrapper. For CUDA tensors it checks them
  and launches the kernel, counting each launch in
  `window_attention.launches`; for CPU tensors it returns the plain
  version. It never falls back from the kernel to the plain version.
- `window_attention_reference`: the plain PyTorch version, in `mal_tpu`'s
  unfused order of operations (`swin.py:108-117`).

Both take the bias as the relative-position table plus the shifted-window
mask, not as `mal_tpu`'s pre-added (nm, h, N, N) `bias_all`: the kernel
indexes the table itself, which saves building and reading that tensor.

Preconditions on the mask, which the wrapper does not check (a check would
read the mask back to the host on every call): it is what
`segment/swin.py:shift_mask` makes, the port's one producer of masks, so
it is symmetric (the loop kernel reads it by columns, which are its rows)
and holds 0 and one non-zero value only (-100; the tiled and w7 kernels
keep it as bits and that one value). Any other mask gives a wrong answer
on a CUDA tensor, with no error; the plain version takes any mask.

The source has three kernels, one a route, and `window_attention_route`
picks one from the window size alone: "tiled" for 12x12 windows (every
Swin-L stage), "w7" for 7x7 windows (every Swin-T stage, MaskFormer v1),
"loop" for any other window up to 16x16 (no model in the repo runs one).
The wrapper's `route=` names another route for timing one against the
other (the loop kernel takes every window size).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable

import numpy as np
import torch

from mal_tpu_torch.ops.cuda import refuse_grad

Tensor = torch.Tensor

SOURCE = "window_attention"
HEAD_DIM = 32      # the kernel's head width, Swin's at every size
_MAX_WINDOW = 16   # K and V of a 16x16 window fill 64 KB of shared memory
TILED_WINDOW = 12  # the window size the tiled kernel is built for
W7_WINDOW = 7      # ... and the w7 kernel
# each route's C entry point in the library
_ENTRIES = {"tiled": "window_attention_tiled_f32",
            "w7": "window_attention_w7_f32", "loop": "window_attention_f32"}


def window_attention_route(ws: int) -> str:
    """The kernel that takes windows of ws x ws tokens: "tiled" for 12,
    "w7" for 7, "loop" for any other ws up to 16; above 16 a ValueError."""
    if not 1 <= ws <= _MAX_WINDOW:
        raise ValueError(f"window {ws} is outside 1..{_MAX_WINDOW}")
    return {TILED_WINDOW: "tiled", W7_WINDOW: "w7"}.get(ws, "loop")


def relative_position_index(ws: int) -> np.ndarray:
    """(N, N) index into the ((2ws-1)^2, heads) bias table for query i and
    key j (`mal_tpu/segment/swin.py:45-50`)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def window_attention_reference(qkv: Tensor, table: Tensor, mask: Tensor | None,
                               num_heads: int) -> Tensor:
    """softmax(q k^T d^-1/2 + bias + mask[w % nm]) v per window and head,
    plain torch.

    qkv (nW, N, 3C) from the qkv projection; table ((2ws-1)^2, heads);
    mask (nm, N, N), symmetric, or None. Returns (nW, N, C).
    """
    nW, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    d = C // h
    ws = int(round(N ** 0.5))
    q, k, v = qkv.reshape(nW, N, 3, h, d).unbind(2)          # (nW, N, h, d)
    idx = torch.from_numpy(relative_position_index(ws)).to(table.device)
    bias = table[idx.reshape(-1)].reshape(N, N, h).permute(2, 0, 1)

    attn = torch.einsum("wnhd,wmhd->whnm", q * d ** -0.5, k) + bias[None]
    if mask is not None:
        nm = mask.shape[0]
        attn = (attn.reshape(nW // nm, nm, h, N, N)
                + mask[None, :, None]).reshape(nW, h, N, N)
    attn = attn.softmax(dim=-1)
    return torch.einsum("whnm,wmhd->wnhd", attn, v).reshape(nW, N, C)


def _check(qkv: Tensor, table: Tensor, mask: Tensor | None,
           num_heads: int) -> int:
    """Raise on anything the kernel does not take; return the window size.
    It runs on every launch, so it reads each attribute once and compares
    shapes by their entries."""
    device = qkv.device
    for name, x in (("qkv", qkv), ("table", table), ("mask", mask)):
        if x is None:
            continue
        if x is not qkv and x.device != device:
            raise ValueError(f"{name} is on {x.device}, qkv on {device}")
        if x.dtype is not torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    shape = qkv.shape
    if len(shape) != 3 or shape[2] != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"qkv {tuple(shape)} must be (nW, N, 3 x "
                         f"{num_heads} heads x {HEAD_DIM})")
    nW, N = shape[0], shape[1]
    ws = math.isqrt(N)
    if ws * ws != N or ws > _MAX_WINDOW:
        raise ValueError(f"{N} tokens is not a square window of side <= "
                         f"{_MAX_WINDOW}")
    tshape = table.shape
    if len(tshape) != 2 or tshape[0] != (2 * ws - 1) ** 2 \
            or tshape[1] != num_heads:
        raise ValueError(f"table {tuple(tshape)} does not fit ws={ws}, "
                         f"{num_heads} heads")
    if mask is not None:
        mshape = mask.shape
        if (len(mshape) != 3 or mshape[1] != N or mshape[2] != N
                or nW % mshape[0]):
            raise ValueError(f"mask {tuple(mshape)} does not fit {nW} "
                             f"windows of {N} tokens")
        if mask.data_ptr() % 16:
            raise ValueError("qkv and mask must be 16-byte aligned")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv and mask must be 16-byte aligned")
    return ws


@functools.cache
def _entries() -> tuple[dict, Callable]:
    """The library's launch functions by route, with their argument types,
    and its error-string function; loaded (and built) once."""
    from mal_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    launch = {}
    for route, name in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        launch[route] = fn
    lib.window_attention_error_string.argtypes = [ctypes.c_int]
    lib.window_attention_error_string.restype = ctypes.c_char_p
    return launch, lib.window_attention_error_string


def window_attention(qkv: Tensor, table: Tensor, mask: Tensor | None,
                     num_heads: int, *, route: str | None = None) -> Tensor:
    """Window attention (nW, N, C); arguments as
    `window_attention_reference`, the mask as the module's preconditions
    say. CUDA tensors go to the kernel of `route` (by default
    `window_attention_route`'s), CPU tensors to the plain version."""
    refuse_grad("window_attention", qkv, table, mask)
    dev = qkv.device
    if dev.type == "cpu":
        return window_attention_reference(qkv, table, mask, num_heads)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ws = _check(qkv, table, mask, num_heads)
    if route is None:
        route = window_attention_route(ws)
    elif route != "loop" and route != window_attention_route(ws):
        raise ValueError(f"route {route!r} does not take {ws}x{ws} windows")
    nW, N, C3 = qkv.shape
    out = qkv.new_empty((nW, N, C3 // 3))
    nm = 1 if mask is None else mask.shape[0]
    launch, error_string = _entries()
    device = dev.index
    args = (qkv.data_ptr(), table.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            nW, num_heads, ws, nm, device)
    # the current stream's handle, without building the Stream object that
    # `torch.cuda.current_stream()` returns (on the H100's host that cost
    # as much as the launch); the binding exists in CUDA builds of torch
    if device == torch.cuda.current_device():
        err = launch[route](*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = launch[route](*args,
                                torch._C._cuda_getCurrentRawStream(device))
    if err:
        msg = error_string(err).decode()
        raise RuntimeError(f"window_attention launch failed: {msg} ({err})")
    window_attention.launches += 1
    return out


window_attention.launches = 0
