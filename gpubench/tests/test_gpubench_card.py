"""On the card, at each cell's own size: the control (the reference in
the precision below the configuration's) is not correct by the cell's
limits. Skips where no card is present; `pytest -m gpu gpubench/tests`
runs it on the card."""

import pytest
import torch

from gpubench import compare
from gpubench.reference import runner
from gpubench.tests.tiny import full_cell
from gpubench.tools import readings


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mal_swinl_bf16.temporal_hint",
                                  "mal_distil_fp32.dp4",
                                  "dynamicdepth_fp32.precomputed_doj"])
def test_control_at_cell_size_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = full_cell(name)
    device = torch.device("cuda")
    ref = runner.readings(cell, 21, device)
    got = readings.variant_readings(cell, 21, "control", device)
    limits = {k: v for k, v in cell.workload["limits"].items()
              if k != "rank_gap"}
    ok, table = compare.judge(
        compare.numbers(got, ref, cell.workload.get("leaf_groups")), limits)
    assert not ok, table
