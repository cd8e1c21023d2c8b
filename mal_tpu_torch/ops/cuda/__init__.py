"""The port's hand-written CUDA kernels and their wrappers."""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise where autograd would need a backward of kernel `name`: grad
    mode on and an input that requires a gradient. The kernels are
    forward-only, as in `mal_tpu`, where Pallas has a JVP rule for
    `pallas_call` and no transpose; their callers run them without
    gradient (the frozen segmenter, the detached cost volumes). The check
    comes before the device dispatch, so the plain version on the CPU
    refuses the same inputs."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (nor in mal_tpu, whose "
            "Pallas kernel has a JVP rule and no transpose), so a gradient "
            "would stop here; call it under torch.no_grad() or on inputs "
            "that do not require grad")
