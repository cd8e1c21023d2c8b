"""Layers computed in a reduced type, with flax's `dtype=` semantics.

`mal_tpu`'s fast mode builds its `nn.Dense` / `nn.Conv` layers with
`dtype=jnp.bfloat16`: parameters stay fp32, and each call casts the input,
the kernel and the bias to bf16, rounds the product to bf16 and adds the
bias in bf16. These helpers do exactly that with a torch module's fp32
parameters, by explicit casts. `torch.autocast` is not used: its per-op
policy puts the rounding elsewhere than flax's `dtype=` does.

`dtype=None` is the exact path: the layer in the type of its input.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


def compute_dtype_of(name: str) -> torch.dtype | None:
    """`Config.compute_dtype` as these helpers take it."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {name!r}")


def linear(layer: nn.Linear, x: Tensor, dtype: torch.dtype | None) -> Tensor:
    """`layer(x)` computed in `dtype`; the result has that type."""
    if dtype is None:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def conv2d(layer: nn.Conv2d, x: Tensor, dtype: torch.dtype | None) -> Tensor:
    """The convolution of `layer` (zeros padding, or none) computed in
    `dtype`; the result has that type."""
    if dtype is None:
        return F.conv2d(x, layer.weight, layer.bias, layer.stride,
                        layer.padding, layer.dilation, layer.groups)
    y = F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride,
                 layer.padding, layer.dilation, layer.groups)
    if layer.bias is None:
        return y
    return y + layer.bias.to(dtype)[:, None, None]
