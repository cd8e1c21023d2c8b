"""The reference's DualRefine configuration: the ManyDepth reference's
`Config` (`gpubench/reference/config.py`) with the fields of the port's
`Config` (`mal_tpu_torch/config.py`) that the copied DualRefine model and
step read, at the port's defaults (`dualrefine/options.py:84-230`).
`deq_ift` and `robust_pose_loss` are here so that `build` can name them
when it refuses them."""

from __future__ import annotations

from dataclasses import dataclass

from gpubench.reference import config


@dataclass(frozen=True)
class Config(config.Config):
    method: str = "dualrefine"
    deq_solver: str = "anderson"  # --f_solver: anderson | iteration
    deq_stop_mode: str = "abs"    # --stop_mode: abs | rel
    deq_iters: int = 6            # --f_thres
    deq_eval_factor: float = 1.0  # --eval_factor
    corr_radius: int = 8
    corr_levels: int = 3          # --num_levels
    num_cost_volume_head: int = 1
    num_pose_iter: int = 1
    disable_pose_updates: bool = False
    disable_evolving_pose_weight: bool = False
    disable_fixed_pose_weight: bool = False
    disable_wnorm: bool = False
    pose_for_consistency_mask: str = "Tstar"
    phantom_grad_steps: int = 1   # --phantom_grad
    deq_tau: float = 1.0
    deq_sup_all: bool = False     # --sup_all
    deq_indexing: tuple[int, ...] = ()  # --indexing
    deq_n_losses: int = 1         # --n_losses
    deq_ift: bool = False         # --ift: not copied
    robust_pose_loss: bool = False  # --robust_pose_loss: not copied
