"""The port's DDAD exporter (`mal_tpu_torch.data.export_ddad`, a copy of
`mal_tpu.data.export_ddad` the port can import) on the CPU: `export_sample`
on a fake dgp context (as tests/test_data.py builds one) equals
`mal_tpu`'s, array for array, and the port's `DDADDataset` reads the
written npz as `mal_tpu`'s does. The command's `--help` runs without JAX,
and `export_split` without the dgp package stops, naming it."""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from mal_tpu.data.ddad import DDADDataset as JDDADDataset
from mal_tpu.data.export_ddad import export_sample as j_export_sample
from mal_tpu_torch.data.ddad import DDADDataset
from mal_tpu_torch.data.export_ddad import export_sample, export_split

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _context(seed: int = 0) -> list:
    """[prev, cur, next] datum lists of 200x120 RGB frames with
    intrinsics; the key frame carries lidar depth and a lidar datum."""
    rng = np.random.RandomState(seed)

    def datum(with_depth):
        d = {"rgb": Image.fromarray(
                 rng.randint(0, 255, (120, 200, 3), np.uint8)),
             "intrinsics": np.array([[200.0, 0, 100], [0, 120.0, 60],
                                     [0, 0, 1]], np.float32)}
        if with_depth:
            d["depth"] = rng.uniform(1, 200, (120, 200)).astype(np.float32)
        return d

    return [[datum(False)], [{"point_cloud": None}, datum(True)],
            [datum(False)]]


def test_export_sample_equals_mal_tpus(tmp_path):
    context = _context()
    got = export_sample(context, width=96, height=64)
    want = j_export_sample(context, width=96, height=64)
    assert sorted(got) == sorted(want) == ["K", "color", "color_next",
                                           "color_prev", "depth_gt"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["K"][0, 0], 200.0 * 96 / 200, rtol=1e-6)

    split_dir = tmp_path / "train"
    split_dir.mkdir()
    np.savez_compressed(split_dir / "000000.npz", **got)
    item = DDADDataset(str(tmp_path), height=64, width=96, is_train=True)[0]
    j_item = JDDADDataset(str(tmp_path), height=64, width=96,
                          is_train=True)[0]
    assert item["color"]["0"].shape == (64, 96, 3)
    assert item["depth_gt"].shape == (120, 200)
    for f in ("-1", "0", "1"):
        np.testing.assert_array_equal(item["color"][f], j_item["color"][f])
    for k in ("K", "depth_gt"):
        np.testing.assert_array_equal(item[k], j_item[k], err_msg=k)


def test_help_runs_without_jax_and_export_needs_dgp(tmp_path, monkeypatch):
    code = ("import sys, runpy; sys.argv = ['export_ddad', '--help']\n"
            "try:\n"
            "    runpy.run_module('mal_tpu_torch.data.export_ddad',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'mal_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert "--json" in out.stdout and "--height" in out.stdout
    monkeypatch.setitem(sys.modules, "dgp", None)    # as where it is absent
    with pytest.raises(SystemExit, match="dgp"):
        export_split("ddad.json", str(tmp_path), "train")
