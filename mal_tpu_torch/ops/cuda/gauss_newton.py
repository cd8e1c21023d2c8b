"""DualRefine's Gauss-Newton normal equations as one CUDA reduction, with
its backward.

Replaces no TPU kernel: `mal_tpu/dualref/pose_update.py:direct_align`
leaves these products to XLA. The kernel source is
`mal_tpu_torch/csrc/gauss_newton.cu`; its header says what bounds it,
how it is laid out, and why its forward adds the terms in the order the
plain version's cuBLAS calls take at DualRefine's cell shape (there it
gives the plain version's H and b to the bit).

- `normal_equations(f, src_feat, J_pixel_xi, wmap) -> (H, b)`: the
  wrapper. For CPU tensors it returns the plain version (autograd takes
  its gradient); for CUDA tensors it checks them and runs the kernel
  through `NormalEquations`, whose backward is the kernel's backward. It
  never falls back from the kernel to the plain version. Each forward
  launch adds 1 to `normal_equations.launches` and to the profiling
  counter `gauss_newton_kernel`, each backward launch to
  `normal_equations.backward_launches` and `gauss_newton_kernel_bwd`.
- `normal_equations_reference`: the plain PyTorch version, the arithmetic
  `direct_align` ran before the kernel: the image-gradient stack, the
  residual, the (B, N, C, 6) Jacobian J, its weighted copy and two einsums.

Inputs: f (B, C, 5, N), the target features sampled at each pixel's
projection (plane 0) and its +-1 pixel neighbours in x (planes 1, 2) and y
(planes 3, 4); src_feat (B, C, N); J_pixel_xi (B, N, 2, 6), the analytic
pixel Jacobian; wmap (B, N), the composed weight. Returns H = Jᵀ W J
(B, 6, 6) and b = -Jᵀ W r (B, 6), r = src - f0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from mal_tpu_torch.utils import profiling

Tensor = torch.Tensor

SOURCE = "gauss_newton"
LANES = 64              # the forward kernel's kLanes: H's lanes
CHUNK = LANES * 256     # its kChunk: elements of one chunk sum


def normal_equations_reference(f: Tensor, src_feat: Tensor,
                               J_pixel_xi: Tensor, wmap: Tensor):
    """(H, b) in plain torch, shapes as the module says."""
    B, C, _, N = f.shape
    grads = torch.stack([(f[:, :, 1] - f[:, :, 2]) / 2.0,
                         (f[:, :, 3] - f[:, :, 4]) / 2.0], dim=2)  # (B, C, 2, N)
    J_img_pixel = grads.permute(0, 3, 1, 2)                 # (B, N, C, 2)
    J = -(J_img_pixel @ J_pixel_xi)                         # (B, N, C, 6)
    res = (src_feat - f[:, :, 0]).transpose(1, 2)           # (B, N, C)
    JW = J * wmap.reshape(B, N, 1, 1)
    H = torch.einsum("bnck,bncl->bkl", JW, J)               # (B, 6, 6)
    b = -torch.einsum("bnck,bnc->bk", JW, res)              # (B, 6)
    return H, b


def _check(f: Tensor, src_feat: Tensor, J_pixel_xi: Tensor,
           wmap: Tensor) -> tuple[int, int, int]:
    """Raise on anything the kernel does not take; return (B, C, N)."""
    device = f.device
    for name, x in (("f", f), ("src_feat", src_feat),
                    ("J_pixel_xi", J_pixel_xi), ("wmap", wmap)):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, f on {device}")
        if x.dtype is not torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if f.dim() != 4 or f.shape[2] != 5:
        raise ValueError(f"f {tuple(f.shape)} must be (B, C, 5, N)")
    B, C, _, N = f.shape
    for name, x, want in (("src_feat", src_feat, (B, C, N)),
                          ("J_pixel_xi", J_pixel_xi, (B, N, 2, 6)),
                          ("wmap", wmap, (B, N))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} {tuple(x.shape)} must be {want} for f "
                             f"{tuple(f.shape)}")
    if min(B, C, N) < 1:
        raise ValueError(f"f {tuple(f.shape)} is empty")
    if C > 2048:
        raise ValueError(f"f {tuple(f.shape)}: at most 2048 channels")
    if 5 * C * N >= 2 ** 31:
        raise ValueError(f"f {tuple(f.shape)}: a batch element's 5 C N "
                         f"samples must fit a 32-bit index")
    return B, C, N


@functools.cache
def _entries() -> tuple[Callable, Callable, Callable]:
    """The library's forward and backward launches, with their argument
    types, and its error-string function; loaded (and built) once."""
    from mal_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    forward = lib.gauss_newton_normal_equations_f32
    forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    forward.restype = ctypes.c_int
    backward = lib.gauss_newton_normal_equations_bwd_f32
    backward.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    backward.restype = ctypes.c_int
    lib.gauss_newton_error_string.argtypes = [ctypes.c_int]
    lib.gauss_newton_error_string.restype = ctypes.c_char_p
    return forward, backward, lib.gauss_newton_error_string


def _launch(fn: Callable, device: torch.device, *args) -> None:
    """Call a launch function on the device's current stream; raise if the
    launch failed."""
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        msg = _entries()[2](err).decode()
        raise RuntimeError(f"gauss_newton launch failed: {msg} ({err})")


class NormalEquations(torch.autograd.Function):
    """(H, b) by the forward kernel; the backward kernel gives the
    gradients of all four inputs in one pass. Inputs checked by `_check`."""

    @staticmethod
    def forward(ctx, f: Tensor, src_feat: Tensor, J_pixel_xi: Tensor,
                wmap: Tensor):
        B, C, N = _check(f, src_feat, J_pixel_xi, wmap)
        chunks = -(-N * C // CHUNK)
        partial = f.new_empty((B, chunks, LANES, 36))
        H = f.new_empty((B, 6, 6))
        b = f.new_empty((B, 6))
        _launch(_entries()[0], f.device, f.data_ptr(), src_feat.data_ptr(),
                J_pixel_xi.data_ptr(), wmap.data_ptr(), partial.data_ptr(),
                H.data_ptr(), b.data_ptr(), B, C, N)
        normal_equations.launches += 1
        profiling.count("gauss_newton_kernel")
        ctx.save_for_backward(f, src_feat, J_pixel_xi, wmap)
        return H, b

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dH: Tensor | None, db: Tensor | None):
        f, src_feat, J_pixel_xi, wmap = ctx.saved_tensors
        B, C, _, N = f.shape
        dH = (f.new_zeros((B, 6, 6)) if dH is None
              else dH.to(torch.float32).contiguous())
        db = (f.new_zeros((B, 6)) if db is None
              else db.to(torch.float32).contiguous())
        df = torch.empty_like(f)
        dsrc = torch.empty_like(src_feat)
        dJp = torch.empty_like(J_pixel_xi)
        dw = torch.empty_like(wmap)
        _launch(_entries()[1], f.device, f.data_ptr(), src_feat.data_ptr(),
                J_pixel_xi.data_ptr(), wmap.data_ptr(), dH.data_ptr(),
                db.data_ptr(), df.data_ptr(), dsrc.data_ptr(), dJp.data_ptr(),
                dw.data_ptr(), B, C, N)
        normal_equations.backward_launches += 1
        profiling.count("gauss_newton_kernel_bwd")
        return df, dsrc, dJp, dw


def normal_equations(f: Tensor, src_feat: Tensor, J_pixel_xi: Tensor,
                     wmap: Tensor):
    """(H (B, 6, 6), b (B, 6)) of the Gauss-Newton step, shapes as the
    module says. CPU tensors take the plain version, CUDA tensors the
    kernel (fp32 and contiguous, or it raises)."""
    dev = f.device
    if dev.type == "cpu":
        return normal_equations_reference(f, src_feat, J_pixel_xi, wmap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return NormalEquations.apply(f, src_feat, J_pixel_xi, wmap)


normal_equations.launches = 0
normal_equations.backward_launches = 0
