"""Fixed-point solvers and backward passes for the DEQ refinement (PyTorch).

Counterpart of `mal_tpu.dualref.solvers`, the machinery of the DEQ library
that the reference imports from its missing `dualrefine/networks/lib/`
(`depth_pose.py:17-18`): Picard, Anderson and Broyden solves with fixed
iteration counts, convergence traces for monitoring, the truncated
"phantom" backward (unrolled damped iterations from the detached fixed
point) and the implicit-function-theorem backward.

The iteration counts are static, so the loops are plain Python loops; the
Anderson history is kept in lists rather than written in place, so that a
solve run with gradients on stays differentiable.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import torch

from mal_tpu_torch.parallel import mesh
from mal_tpu_torch.utils import profiling

Tensor = torch.Tensor


class SolverResult(NamedTuple):
    result: Tensor       # final iterate (B, D)
    trajectory: Tensor   # (T, B, D) iterates selected by `indexing` (or the last)
    rel_trace: Tensor    # (steps,) mean relative residual per step
    abs_trace: Tensor    # (steps,) mean absolute residual per step


def _residuals(z_new: Tensor, z_old: Tensor) -> tuple[Tensor, Tensor]:
    diff = torch.linalg.vector_norm(z_new - z_old, dim=-1)
    denom = torch.linalg.vector_norm(z_new, dim=-1) + 1e-8
    return diff.mean(), (diff / denom).mean()


def _select_trajectory(traj: Tensor, indexing: Sequence[int] | None,
                       steps: int) -> Tensor:
    if indexing is None:
        return traj[-1:]
    return traj[[min(i, steps) - 1 for i in indexing]]


def _finish(zs: list[Tensor], abs_t: list[Tensor], rel_t: list[Tensor],
            indexing, steps: int) -> SolverResult:
    traj = torch.stack(zs)
    return SolverResult(zs[-1], _select_trajectory(traj, indexing, steps),
                        torch.stack(rel_t), torch.stack(abs_t))


def fixed_point_iter(f: Callable, z0: Tensor, steps: int,
                     indexing: Sequence[int] | None = None) -> SolverResult:
    """Plain (Picard) iteration."""
    z, zs, abs_t, rel_t = z0, [], [], []
    for _ in range(steps):
        z_new = f(z)
        a, r = _residuals(z_new, z)
        z = z_new
        zs.append(z)
        abs_t.append(a)
        rel_t.append(r)
    return _finish(zs, abs_t, rel_t, indexing, steps)


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
    # `solve` checks its factorisation on the host, which synchronises
    alpha = torch.linalg.solve(H, rhs)[..., 0]               # (B, n)
    profiling.count("host_syncs")
    alpha = alpha / (alpha.sum(dim=1, keepdim=True) + 1e-12)
    return (beta * torch.einsum("bi,ibd->bd", alpha, Fs)
            + (1 - beta) * torch.einsum("bi,ibd->bd", alpha, Xs))


def anderson_solver(f: Callable, z0: Tensor, steps: int, m: int = 6,
                    lam: float = 1e-4, beta: float = 1.0,
                    indexing: Sequence[int] | None = None) -> SolverResult:
    """Anderson acceleration over a (B, D) state: two warm-up evaluations,
    then `steps` mixed ones over the last `m` residuals."""
    f0 = f(z0)
    X, F = [z0, f0], [f0, f(f0)]
    zs, abs_t, rel_t = [], [], []
    for k in range(2, steps + 2):
        z_new = _anderson_mix(X, F, lam, beta)
        f_new = f(z_new)
        a, r = _residuals(f_new, z_new)
        if len(X) < m:
            X.append(z_new)
            F.append(f_new)
        else:
            X[k % m], F[k % m] = z_new, f_new
        zs.append(f_new)
        abs_t.append(a)
        rel_t.append(r)
    return _finish(zs, abs_t, rel_t, indexing, steps)


def broyden_solver(f: Callable, z0: Tensor, steps: int,
                   indexing: Sequence[int] | None = None) -> SolverResult:
    """Limited-memory 'good Broyden' root solve of g(z) = f(z) - z, with the
    inverse-Jacobian estimate B = -I + sum_k u_k v_kᵀ kept as (u, v)
    pairs."""
    Us: list[Tensor] = []
    Vs: list[Tensor] = []

    def apply(P: list[Tensor], Q: list[Tensor], g: Tensor) -> Tensor:
        """-g + sum_k P_k (Q_k . g): B g with (Us, Vs), Bᵀ s with (Vs, Us)."""
        if not P:
            return -g
        contrib = torch.einsum("kbd,bd->kb", torch.stack(Q), g)
        return -g + torch.einsum("kb,kbd->bd", contrib, torch.stack(P))

    z, gz = z0, f(z0) - z0
    zs, abs_t, rel_t = [], [], []
    for _ in range(steps):
        dz = -apply(Us, Vs, gz)
        z_new = z + dz
        gz_new = f(z_new) - z_new
        y = gz_new - gz
        By = apply(Us, Vs, y)
        v_new = apply(Vs, Us, dz)
        denom = (v_new * y).sum(dim=-1, keepdim=True)
        safe = denom.abs() > 1e-8
        Us.append(torch.where(safe, (dz - By) / torch.where(safe, denom, 1.0),
                              0.0))
        Vs.append(torch.where(safe, v_new, 0.0))
        a, r = _residuals(z_new + gz_new, z_new)
        z, gz = z_new, gz_new
        zs.append(z)
        abs_t.append(a)
        rel_t.append(r)
    return _finish(zs, abs_t, rel_t, indexing, steps)


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
    norm; mixing a rigid transform linearly would leave the manifold).

    `steps` counts all f evaluations, as the DEQ library's `threshold`: two
    warm-up evaluations, then steps - 2 mixed ones. `result` is the mixed
    iterate X_k (before f) whose residual |f(X_k) - X_k| is lowest, the
    residual one global L2 norm over the whole batch (the global batch in
    a data-parallel step, so that every rank picks the same iterate), 'abs'
    or relative to |f(X_k)| ('rel') by `stop_mode`; the warm-up evaluations
    are not candidates, and with steps <= 2 the result is z0."""
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
        a = mesh.global_norm(f_new - z_new)
        r = a / (1e-5 + mesh.global_norm(f_new))
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
    # indexing by a device scalar reads it on the host
    best = mixed[torch.argmin(trace)]
    profiling.count("host_syncs")
    return AuxSolverResult(best, aux, _stack_aux(auxs), torch.stack(zs),
                           rel_t, abs_t, mixed)


class _AdjointGate(torch.autograd.Function):
    """Identity on f(z0) whose backward replaces the cotangent g by the
    adjoint fixed point y = Jᵀ y + g, J = df/dz at z0, from `b_steps`
    Neumann iterations; the gradient then flows on from f(z0) to f's
    parameters. `safe` keeps the last finite iterate if the series stops
    being finite."""

    @staticmethod
    def forward(ctx, fz: Tensor, z0: Tensor, b_steps: int, safe: bool):
        ctx.save_for_backward(fz, z0)
        ctx.b_steps, ctx.safe = b_steps, safe
        return fz.view_as(fz)

    @staticmethod
    def backward(ctx, g: Tensor):
        fz, z0 = ctx.saved_tensors
        y = g
        with torch.enable_grad():
            for _ in range(ctx.b_steps):
                (jty,) = torch.autograd.grad(fz, z0, y, retain_graph=True)
                y_next = jty + g
                if ctx.safe:
                    y_next = torch.where(torch.isfinite(y_next).all(), y_next, y)
                y = y_next
        return y, None, None, None


def ift_output(f: Callable, z_star: Tensor, b_steps: int = 6,
               safe: bool = False) -> Tensor:
    """Implicit-function-theorem gradient through the fixed point (`--ift`,
    `depth_pose.py:507-513`). The value is f(z*) at the detached z*, as a
    one-step phantom unroll; the backward gives f's parameters
    (df/dθ)ᵀ sum_k (Jᵀ)^k g ~ (df/dθ)ᵀ (I - Jᵀ)⁻¹ g and z* none."""
    z0 = z_star.detach().requires_grad_(True)
    with torch.enable_grad():
        fz = f(z0)
    return _AdjointGate.apply(fz, z0, int(b_steps), bool(safe))


def phantom_grad(f: Callable, z_star: Tensor, steps: int = 1,
                 tau: float = 1.0) -> Tensor:
    """Phantom-gradient correction: z <- (1 - tau) z + tau f(z), `steps`
    times from the detached fixed point, gradients through the unrolled
    applications only."""
    z = z_star.detach()
    for _ in range(steps):
        z = (1.0 - tau) * z + tau * f(z)
    return z
