"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (`mal_tpu_torch` begins with `mal_tpu` and
is neither), and nothing it runs opens a file of the JAX package's
benchmarks (`benchmarks/`, `bench.py`)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
opened = []
sys.addaudithook(lambda event, a: opened.append(str(a[0]))
                 if event == "open" and isinstance(a[0], str) else None)
import torch
torch.set_num_threads(2)
from gpubench import run
from gpubench.tests.tiny import args, tiny_cell
for name in ("mal_swinl_bf16.temporal_hint", "mal_distil_fp32.dp4",
             "dynamicdepth_fp32.precomputed_doj"):
    result = run.measure(tiny_cell(name), args(3), torch.device("cpu"), 0, 1, [])
    assert result["correct"], result
top = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"top": top, "opened": opened}))
"""


def test_no_jax_and_no_benchmarks_folder(tmp_path):
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=900,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                               "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "mal_tpu"}
    assert "mal_tpu_torch" in got["top"]
    bench = (ROOT / "benchmarks", ROOT / "bench.py")
    for path in got["opened"]:
        p = Path(path).resolve()
        assert not any(p == b or b in p.parents for b in bench), path
    assert any("gpubench" in p for p in got["opened"])
