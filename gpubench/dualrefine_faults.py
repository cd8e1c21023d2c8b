"""DualRefine's faults, planted under the timed step of
`dualrefine_fp32.kitti_triplets` for the tests and the calibration that
see `correct` come out false (`faults.py` has the faults every cell
shares): each takes the port's `train_step` and returns a broken step with
the same call.

- `gn_skipped`: the Gauss-Newton pose step skipped, the pose passed
  through every DEQ evaluation unrefined (`dualref/pose_update.py:
  direct_align` returning its input pose and a zero update);
- `solve_cut`: the fixed-point solve cut from the configuration's
  evaluations to 3 (`dualref/solvers.py:anderson_solver_aux`).
"""

from __future__ import annotations

import torch

from gpubench.faults import _patched, half_batch, unchanged

SOLVE_CUT_EVALUATIONS = 3


def gn_skipped(step):
    """Every Gauss-Newton step returning the pose it was given."""
    from mal_tpu_torch.dualref import model

    def make(direct_align):
        def skipped(poses, *args, **kwargs):
            return poses, torch.zeros(poses.shape[0], 6, dtype=poses.dtype,
                                      device=poses.device)
        return skipped
    return _patched(step, model, "direct_align", make)


def solve_cut(step):
    """The Anderson solve run for 3 evaluations, whatever it is asked."""
    from mal_tpu_torch.dualref import model

    def make(solver):
        def cut(f, z0, aux0, steps, **kwargs):
            return solver(f, z0, aux0, min(steps, SOLVE_CUT_EVALUATIONS),
                          **kwargs)
        return cut
    return _patched(step, model, "anderson_solver_aux", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "gn_skipped": gn_skipped, "solve_cut": solve_cut}
