"""Pareto (MGDA) two-task gradient re-weighting, the port's copy of
`mal_tpu.pareto`.

The reference turns it on with `--pareto` (`manydepth/options.py:440`):
`compute_main_losses` re-weights the photometric loss against the
distillation loss with `c_list=[0.1, 0.3]` (`manydepth/loss_utils.py:
256-263`), through a `manydepth/pareto.py` that is missing from the
reference snapshot. `mal_tpu` reconstructs it as the MGDA min-norm solver
of Sener & Koltun (NeurIPS 2018) with per-task lower bounds; for two tasks
the min-norm point has a closed form:

    w1* = clip( (g0 - g1) . g0 / ||g0 - g1||^2 ,  c1, 1 - c0 ),   w0* = 1 - w1*

Gradients are lists of tensors, one per parameter, in the same order.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _dot(a: list[Tensor], b: list[Tensor]) -> Tensor:
    return torch.stack([torch.vdot(x.float().flatten(), y.float().flatten())
                        for x, y in zip(a, b)]).sum()


def pareto_weights_2task(g0: list[Tensor], g1: list[Tensor],
                         c0: float = 0.1, c1: float = 0.3
                         ) -> tuple[Tensor, Tensor]:
    """Min-norm convex combination of two gradient lists: (w0, w1) with
    w0 + w1 = 1, w0 >= c0, w1 >= c1, minimising ||w0 g0 + w1 g1||^2
    within those bounds; 0.5 where g0 and g1 (nearly) coincide."""
    d00, d11, d01 = _dot(g0, g0), _dot(g1, g1), _dot(g0, g1)
    denom = d00 - 2.0 * d01 + d11          # ||g0 - g1||^2
    w1 = torch.where(denom > 1e-12, (d00 - d01) / denom.clamp(min=1e-12),
                     0.5)
    w1 = w1.clamp(c1, 1.0 - c0)
    return 1.0 - w1, w1


def pareto_combine_grads(g0: list[Tensor], g1: list[Tensor],
                         c0: float = 0.1, c1: float = 0.3):
    """(w0 g0 + w1 g1 per parameter, w0, w1)."""
    w0, w1 = pareto_weights_2task(g0, g1, c0, c1)
    return [w0 * a + w1 * b for a, b in zip(g0, g1)], w0, w1
