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
and holds 0 and one non-zero value only (-100; the tiled kernel keeps it as
bits and that one value). Any other mask gives a wrong answer on a CUDA
tensor, with no error; the plain version takes any mask.

The source has two kernels, and the wrapper picks one by the window size:
the tiled kernel for 12x12 windows (`TILED_WINDOW`, every Swin-L stage),
the loop kernel for any other (Swin-T's 7x7).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mal_tpu_torch.ops.cuda import refuse_grad

Tensor = torch.Tensor

SOURCE = "window_attention"
HEAD_DIM = 32      # the kernel's head width, Swin's at every size
_MAX_WINDOW = 16   # K and V of a 16x16 window fill 64 KB of shared memory
TILED_WINDOW = 12  # the window size the tiled kernel is built for


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
    """Raise on anything the kernel does not take; return the window size."""
    tensors = {"qkv": qkv, "table": table}
    if mask is not None:
        tensors["mask"] = mask
    for name, x in tensors.items():
        if x.device != qkv.device:
            raise ValueError(f"{name} is on {x.device}, qkv on {qkv.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qkv.dim() != 3 or qkv.shape[2] != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"qkv {tuple(qkv.shape)} must be (nW, N, 3 x "
                         f"{num_heads} heads x {HEAD_DIM})")
    nW, N, _ = qkv.shape
    ws = int(round(N ** 0.5))
    if ws * ws != N or ws > _MAX_WINDOW:
        raise ValueError(f"{N} tokens is not a square window of side <= "
                         f"{_MAX_WINDOW}")
    if table.shape != ((2 * ws - 1) ** 2, num_heads):
        raise ValueError(f"table {tuple(table.shape)} does not fit ws={ws}, "
                         f"{num_heads} heads")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (N, N)
                             or nW % mask.shape[0]):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit {nW} "
                         f"windows of {N} tokens")
    if qkv.data_ptr() % 16 or (mask is not None and mask.data_ptr() % 16):
        raise ValueError("qkv and mask must be 16-byte aligned")
    return ws


def _library() -> ctypes.CDLL:
    from mal_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if lib.window_attention_f32.argtypes is None:
        for fn in (lib.window_attention_f32, lib.window_attention_tiled_f32):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.window_attention_error_string.argtypes = [ctypes.c_int]
        lib.window_attention_error_string.restype = ctypes.c_char_p
    return lib


def window_attention(qkv: Tensor, table: Tensor, mask: Tensor | None,
                     num_heads: int) -> Tensor:
    """Window attention (nW, N, C); arguments as
    `window_attention_reference`, the mask as the module's preconditions
    say. CUDA tensors go to the kernel, CPU tensors to the plain version."""
    refuse_grad("window_attention", qkv, table, mask)
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, table, mask, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    ws = _check(qkv, table, mask, num_heads)
    nW, N, C3 = qkv.shape
    out = torch.empty((nW, N, C3 // 3), dtype=torch.float32, device=qkv.device)
    nm = 1 if mask is None else mask.shape[0]
    lib = _library()
    launch = (lib.window_attention_tiled_f32 if ws == TILED_WINDOW
              else lib.window_attention_f32)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            qkv.data_ptr(), table.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            nW, num_heads, ws, nm, stream)
    if err:
        msg = lib.window_attention_error_string(err).decode()
        raise RuntimeError(f"window_attention launch failed: {msg} ({err})")
    window_attention.launches += 1
    return out


window_attention.launches = 0
