"""Device selection for the port's entry points.

The port runs on the GPU. An entry point given no device takes `cuda` and
raises when no card is present; it never carries on on the CPU unasked.
The CPU is used only when the caller names it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` -> `cuda`; anything else as given; a CUDA device raises when
    no card is present.

    On a CUDA device this also turns TF32 off for convolutions and matrix
    products: the port's main path is the fp32 exact recipe, and cuDNN
    would otherwise run fp32 convolutions in TF32 by default.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mal_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device
