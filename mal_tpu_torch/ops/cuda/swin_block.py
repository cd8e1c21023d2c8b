"""Kernels K2 and K3, the fused halves of a Swin block, as CUDA kernels for
Hopper.

Counterparts of `mal_tpu.ops.pallas.swin_block.swin_attn_fused` and
`swin_mlp_fused` (the Pallas TPU kernels the fused `SwinBlock` calls,
`mal_tpu/segment/swin.py:206-248`). The kernel source is
`mal_tpu_torch/csrc/swin_block.cu`; its header says what bounds the kernels
and how they are laid out.

- `swin_attn_fused` (K2): LayerNorm -> zero the pad tokens -> qkv -> per-head
  window attention with relative-position bias and shift mask -> proj, on the
  padded and rolled residual stream (B, Hp, Wp, C).
- `swin_mlp_fused` (K3): LayerNorm -> fc1 -> exact erf GELU -> fc2 -> +
  residual, on (tokens, C).
- `swin_attn_reference`, `swin_mlp_reference`: the plain PyTorch versions,
  with the kernels' rounding points.

Each wrapper checks CUDA tensors and launches its kernel, counting the
launch in `.launches`; CPU tensors take the plain version. Neither falls
back from the kernel to the plain version.

Differences from the Pallas signatures: weights are in `nn.Linear`'s layout
(out_features, in_features), fp32, and are rounded to the compute type
inside the kernel; the bias is the relative-position *table* plus the
symmetric shift mask, as K4 takes them (`ops/cuda/window_attention.py`),
not a pre-added (nm, heads, N, N) tensor. `compute_dtype` is
`torch.float32` or `torch.bfloat16`; the output has the stream's type. The
GELU uses erf itself (`erff` / `torch.erf`), where the Pallas kernel uses a
polynomial of 1.5e-7 absolute error because Mosaic has no erf.
"""

from __future__ import annotations

import ctypes

import torch

from mal_tpu_torch.ops.cuda import refuse_grad
from mal_tpu_torch.ops.cuda.window_attention import (HEAD_DIM,
                                                     relative_position_index)

Tensor = torch.Tensor

SOURCE = "swin_block"
LN_EPS = 1e-6      # flax.linen.LayerNorm's default, which mal_tpu keeps
_MAX_WINDOW = 16   # K and V of a 16x16 window fill 64 KB of shared memory
_TILE_K = 32       # the fp32 GEMM's tile depth: every product's sizes divide by it


def _rounded(x: Tensor, dtype: torch.dtype) -> Tensor:
    """x rounded to `dtype`, back in fp32: products of such tensors
    accumulate in fp32, as the kernels' do (a bf16 matmul on the CPU would
    round its result)."""
    return x.to(dtype).to(torch.float32)


def _layernorm(x: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """fp32 LayerNorm over the last axis, two passes, eps 1e-6."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def swin_attn_reference(xr: Tensor, valid: Tensor, ln_scale: Tensor,
                        ln_bias: Tensor, wqkv: Tensor, bqkv: Tensor,
                        table: Tensor, mask: Tensor | None, wproj: Tensor,
                        bproj: Tensor, *, window_size: int, num_heads: int,
                        compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """K2 in plain torch.

    xr (B, Hp, Wp, C): the residual stream, padded to window multiples and
    rolled; valid (Hp, Wp): 1 on real tokens, 0 on pad tokens, rolled alike;
    wqkv (3C, C), bqkv (3C), wproj (C, C), bproj (C); table ((2ws-1)^2,
    heads); mask (nm, N, N) symmetric, or None. Returns the attention
    output (B, Hp, Wp, C) in xr's type, still padded and rolled.
    """
    B, Hp, Wp, C = xr.shape
    ws, h, dt = window_size, num_heads, compute_dtype
    N, d = ws * ws, C // num_heads
    y = _layernorm(xr.to(torch.float32), ln_scale, ln_bias)
    y = _rounded(y * valid[None, :, :, None], dt)
    wins = (y.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
            .permute(0, 1, 3, 2, 4, 5).reshape(-1, N, C))
    nW = wins.shape[0]
    qkv = _rounded(wins @ _rounded(wqkv, dt).T + bqkv, dt)
    q, k, v = qkv.reshape(nW, N, 3, h, d).unbind(2)           # (nW, N, h, d)
    idx = torch.from_numpy(relative_position_index(ws)).to(table.device)
    bias = table[idx.reshape(-1)].reshape(N, N, h).permute(2, 0, 1)[None]
    if mask is not None:
        bias = bias + mask[:, None]                          # (nm, h, N, N)
    nm = bias.shape[0]
    s = torch.einsum("wnhd,wmhd->whnm", q, k) * d ** -0.5
    s = (s.reshape(nW // nm, nm, h, N, N) + bias).reshape(nW, h, N, N)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = _rounded(e / e.sum(dim=-1, keepdim=True), dt)
    attn = _rounded(torch.einsum("whnm,wmhd->wnhd", p, v).reshape(nW, N, C), dt)
    out = attn @ _rounded(wproj, dt).T + bproj
    out = (out.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
           .permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C))
    return out.to(xr.dtype)


def swin_mlp_reference(x: Tensor, ln_scale: Tensor, ln_bias: Tensor,
                       w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, *,
                       compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """K3 in plain torch: x (tokens, C), w1 (hidden, C), w2 (C, hidden).
    Returns x + MLP(LN(x)) in x's type."""
    dt = compute_dtype
    xf = x.to(torch.float32)
    y = _rounded(_layernorm(xf, ln_scale, ln_bias), dt)
    hid = y @ _rounded(w1, dt).T + b1
    hid = _rounded(0.5 * hid * (1.0 + torch.erf(hid * 2.0 ** -0.5)), dt)
    return (xf + (hid @ _rounded(w2, dt).T + b2)).to(x.dtype)


def _check_common(stream: Tensor, fp32: dict[str, Tensor],
                  compute_dtype: torch.dtype) -> None:
    """Raise on the types, devices and layouts the kernels do not take."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    if stream.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the stream must be float32 or bfloat16, got "
                        f"{stream.dtype}")
    if stream.dtype == torch.bfloat16 and compute_dtype != torch.bfloat16:
        raise TypeError("a bfloat16 stream needs compute_dtype=bfloat16")
    for name, x in {"stream": stream, **fp32}.items():
        if x.device != stream.device:
            raise ValueError(f"{name} is on {x.device}, the stream on "
                             f"{stream.device}")
        if name != "stream" and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _library() -> ctypes.CDLL:
    from mal_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    if lib.swin_attn_fused.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.swin_attn_fused.argtypes = [ptr] * 15 + [i32] * 9 + [ptr]
        lib.swin_attn_fused.restype = i32
        lib.swin_mlp_fused.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
        lib.swin_mlp_fused.restype = i32
        lib.swin_mlp_hidden.argtypes = [i32] * 4
        lib.swin_mlp_hidden.restype = ctypes.c_longlong
        lib.swin_block_error_string.argtypes = [i32]
        lib.swin_block_error_string.restype = ctypes.c_char_p
    return lib


def _scratch(n: int, dtype: torch.dtype, device) -> Tensor | None:
    """n elements of kernel scratch, or None (a null pointer) for none."""
    return torch.empty((n,), dtype=dtype, device=device) if n else None


def _ptr(x: Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def swin_attn_fused(xr: Tensor, valid: Tensor, ln_scale: Tensor,
                    ln_bias: Tensor, wqkv: Tensor, bqkv: Tensor, table: Tensor,
                    mask: Tensor | None, wproj: Tensor, bproj: Tensor, *,
                    window_size: int, num_heads: int,
                    compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """K2; arguments as `swin_attn_reference`. CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    refuse_grad("swin_attn_fused", xr, valid, ln_scale, ln_bias, wqkv, bqkv,
                table, mask, wproj, bproj)
    if xr.device.type == "cpu":
        return swin_attn_reference(
            xr, valid, ln_scale, ln_bias, wqkv, bqkv, table, mask, wproj,
            bproj, window_size=window_size, num_heads=num_heads,
            compute_dtype=compute_dtype)
    if xr.device.type != "cuda":
        raise ValueError(f"unsupported device {xr.device}")
    fp32 = {"valid": valid, "ln_scale": ln_scale, "ln_bias": ln_bias,
            "wqkv": wqkv, "bqkv": bqkv, "table": table, "wproj": wproj,
            "bproj": bproj}
    if mask is not None:
        fp32["mask"] = mask
    _check_common(xr, fp32, compute_dtype)
    if xr.dim() != 4:
        raise ValueError(f"the stream {tuple(xr.shape)} must be (B, Hp, Wp, C)")
    B, Hp, Wp, C = xr.shape
    ws, N = window_size, window_size ** 2
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"C = {C} must be {num_heads} heads x {HEAD_DIM}")
    if not 1 <= ws <= _MAX_WINDOW or Hp % ws or Wp % ws:
        raise ValueError(f"map {Hp}x{Wp} does not tile into windows of "
                         f"{ws} <= {_MAX_WINDOW}")
    want = {"valid": (Hp, Wp), "ln_scale": (C,), "ln_bias": (C,),
            "wqkv": (3 * C, C), "bqkv": (3 * C,), "wproj": (C, C),
            "bproj": (C,), "table": ((2 * ws - 1) ** 2, num_heads)}
    for name, shape in want.items():
        if tuple(fp32[name].shape) != shape:
            raise ValueError(f"{name} {tuple(fp32[name].shape)} must be {shape}")
    nW = B * (Hp // ws) * (Wp // ws)
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (N, N)
                             or nW % mask.shape[0]):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit {nW} "
                         f"windows of {N} tokens")
    M = B * Hp * Wp
    dev = xr.device
    bf16 = compute_dtype == torch.bfloat16
    lib = _library()
    with torch.cuda.device(dev):
        # scratch: the normalised tokens, qkv and the attention output in the
        # compute type; the weights rounded to bf16 (bf16 compute only)
        y = torch.empty((M, C), dtype=compute_dtype, device=dev)
        w16 = _scratch(4 * C * C if bf16 else 0, torch.bfloat16, dev)
        qkv = torch.empty((M, 3 * C), dtype=compute_dtype, device=dev)
        attn = torch.empty((M, C), dtype=compute_dtype, device=dev)
        out = torch.empty_like(xr)
        err = lib.swin_attn_fused(
            xr.data_ptr(), valid.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            table.data_ptr(), _ptr(mask), wproj.data_ptr(), bproj.data_ptr(),
            y.data_ptr(), _ptr(w16), qkv.data_ptr(), attn.data_ptr(),
            out.data_ptr(), B, Hp, Wp, C, num_heads, ws,
            1 if mask is None else mask.shape[0],
            xr.dtype == torch.bfloat16, bf16,
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.swin_block_error_string(err).decode()
        raise RuntimeError(f"swin_attn_fused launch failed: {msg} ({err})")
    swin_attn_fused.launches += 1
    return out


swin_attn_fused.launches = 0


def swin_mlp_fused(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w1: Tensor,
                   b1: Tensor, w2: Tensor, b2: Tensor, *,
                   compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """K3; arguments as `swin_mlp_reference`. CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    refuse_grad("swin_mlp_fused", x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return swin_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                  compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    fp32 = {"ln_scale": ln_scale, "ln_bias": ln_bias, "w1": w1, "b1": b1,
            "w2": w2, "b2": b2}
    _check_common(x, fp32, compute_dtype)
    if x.dim() != 2:
        raise ValueError(f"the stream {tuple(x.shape)} must be (tokens, C)")
    M, C = x.shape
    hidden = w1.shape[0]
    if C % _TILE_K or hidden % _TILE_K:
        raise ValueError(f"C = {C} and hidden = {hidden} must be multiples "
                         f"of {_TILE_K}")
    want = {"ln_scale": (C,), "ln_bias": (C,), "w1": (hidden, C),
            "b1": (hidden,), "w2": (C, hidden), "b2": (C,)}
    for name, shape in want.items():
        if tuple(fp32[name].shape) != shape:
            raise ValueError(f"{name} {tuple(fp32[name].shape)} must be {shape}")
    dev = x.device
    bf16 = compute_dtype == torch.bfloat16
    lib = _library()
    with torch.cuda.device(dev):
        # scratch: the normalised tokens; the GELU hidden where fc1 and fc2
        # are not fused; the weights rounded to bf16 (bf16 compute only)
        y = torch.empty((M, C), dtype=compute_dtype, device=dev)
        hid = _scratch(lib.swin_mlp_hidden(M, C, hidden, bf16), compute_dtype,
                       dev)
        w16 = _scratch(2 * hidden * C if bf16 else 0, torch.bfloat16, dev)
        out = torch.empty_like(x)
        err = lib.swin_mlp_fused(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            y.data_ptr(), _ptr(w16), _ptr(hid), out.data_ptr(),
            M, C, hidden, x.dtype == torch.bfloat16, bf16,
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.swin_block_error_string(err).decode()
        raise RuntimeError(f"swin_mlp_fused launch failed: {msg} ({err})")
    swin_mlp_fused.launches += 1
    return out


swin_mlp_fused.launches = 0
