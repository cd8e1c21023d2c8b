"""The DEQ solve of DualRefine's training forward, frozen from the port's
`mal_tpu_torch/dualref/solvers.py`: Anderson acceleration over the
fixed-point state with an auxiliary state threaded through every
evaluation (`anderson_solver_aux`). The Picard iteration is the model's
own loop (`model.py`); the Broyden solve and the implicit-function-theorem
backward are not copied (`__init__.py` refuses them). One process on the
global batch: the residual norm is the plain L2 norm over it."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Tensor = torch.Tensor


def _anderson_mix(X: list[Tensor], F: list[Tensor], lam: float,
                  beta: float) -> Tensor:
    """The next Anderson iterate from the history (X_i, F_i = f(X_i)):
    alpha minimises |sum_i alpha_i G_i| with sum alpha = 1, G = F - X, by
    the normal equations with Tikhonov `lam`."""
    Xs, Fs = torch.stack(X), torch.stack(F)                  # (n, B, D)
    n = Xs.shape[0]
    G = Fs - Xs
    H = torch.einsum("ibd,jbd->bij", G, G) + lam * torch.eye(
        n, dtype=G.dtype, device=G.device)
    rhs = torch.ones(H.shape[0], n, 1, dtype=G.dtype, device=G.device)
    alpha = torch.linalg.solve(H, rhs)[..., 0]               # (B, n)
    alpha = alpha / (alpha.sum(dim=1, keepdim=True) + 1e-12)
    return (beta * torch.einsum("bi,ibd->bd", alpha, Fs)
            + (1 - beta) * torch.einsum("bi,ibd->bd", alpha, Xs))


class AuxSolverResult(NamedTuple):
    result: Tensor          # the lowest-residual mixed iterate (B, D)
    aux: Any                # aux after the final f evaluation
    aux_trajectory: Any     # aux of every f evaluation, stacked (leading T)
    z_trajectory: Tensor    # f(z) of every evaluation (T, B, D)
    rel_trace: Tensor
    abs_trace: Tensor
    mixed_trajectory: Tensor  # the mixed candidates X_k (n_scan, B, D)


def _stack_aux(auxs: list) -> Any:
    return tuple(torch.stack(parts) for parts in zip(*auxs))


def anderson_solver_aux(f: Callable, z0: Tensor, aux0: Any, steps: int,
                        m: int = 6, lam: float = 1e-4, beta: float = 1.0,
                        stop_mode: str = "abs") -> AuxSolverResult:
    """Anderson acceleration over z with an auxiliary state that is
    threaded through every evaluation but never mixed: `f(z, aux) ->
    (z', aux')`, aux a tuple of tensors (the SE(3) pose and its update
    norm).

    `steps` counts all f evaluations, as the DEQ library's `threshold`: two
    warm-up evaluations, then steps - 2 mixed ones. `result` is the mixed
    iterate X_k (before f) whose residual |f(X_k) - X_k| is lowest, the
    residual one global L2 norm over the whole batch, 'abs' or relative to
    |f(X_k)| ('rel') by `stop_mode`; the warm-up evaluations are not
    candidates, and with steps <= 2 the result is z0."""
    f0, aux = f(z0, aux0)
    auxs = [aux]
    f1, aux = f(f0, aux)
    auxs.append(aux)
    X, F = [z0, f0], [f0, f1]
    n_scan = max(steps - 2, 0)
    if n_scan == 0:
        empty = z0.new_zeros((0,))
        return AuxSolverResult(z0, aux, _stack_aux(auxs),
                               torch.stack([f0, f1]), empty, empty,
                               z0.new_zeros((0,) + tuple(z0.shape)))
    xs_mix, zs, abs_t, rel_t = [], [f0, f1], [], []
    for k in range(2, n_scan + 2):
        z_new = _anderson_mix(X, F, lam, beta)
        f_new, aux = f(z_new, aux)
        a = torch.linalg.vector_norm(f_new - z_new)
        r = a / (1e-5 + torch.linalg.vector_norm(f_new))
        if len(X) < m:
            X.append(z_new)
            F.append(f_new)
        else:
            X[k % m], F[k % m] = z_new, f_new
        xs_mix.append(z_new)
        zs.append(f_new)
        auxs.append(aux)
        abs_t.append(a)
        rel_t.append(r)
    abs_t, rel_t = torch.stack(abs_t), torch.stack(rel_t)
    mixed = torch.stack(xs_mix)
    trace = abs_t if stop_mode == "abs" else rel_t
    return AuxSolverResult(mixed[torch.argmin(trace)], aux, _stack_aux(auxs),
                           torch.stack(zs), rel_t, abs_t, mixed)
