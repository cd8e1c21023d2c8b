"""The control of `correct`: the reference run with every product in the
nearest precision below the configuration's, which a comparison that
works has to reject. Inside `RoundedProducts(fmt)` the floating operands
of every convolution, matrix product, `einsum` and attention call are
rounded to `fmt` first (the products then accumulate as before, as tensor
cores do):

- "tf32": 10 mantissa bits, round to nearest even; the control of a
  float32 configuration with TF32 off;
- "fp8_e4m3": float8 e4m3, each operand scaled by 448 over its largest
  magnitude first; the control of a bfloat16 configuration.

The rounding passes the gradient straight through, so the backward runs
on the rounded forward."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

PRODUCTS = {F.conv2d, F.conv_transpose2d, F.linear, torch.matmul, torch.mm,
            torch.bmm, torch.einsum, torch.addmm, torch.baddbmm,
            F.scaled_dot_product_attention, torch.Tensor.__matmul__,
            torch.Tensor.__rmatmul__, torch.Tensor.matmul}
FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    scale = FP8_MAX / xf.abs().amax().clamp(min=1e-30)
    return ((xf * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


ROUNDING = {"tf32": round_tf32, "fp8_e4m3": round_fp8}


class RoundedProducts(TorchFunctionMode):
    def __init__(self, fmt: str):
        super().__init__()
        self.round = ROUNDING[fmt]

    def _operand(self, x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        with torch.no_grad():
            r = self.round(x)
        return x + (r - x).detach() if x.requires_grad else r

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            args = tree_map(self._operand, args)
            kwargs = tree_map(self._operand, kwargs)
        return func(*args, **kwargs)
