"""The port's kernel build: a library's name covers the shared headers."""

import shutil

import pytest

from mal_tpu_torch.ops.cuda import build

SOURCES = ["plane_sweep", "window_attention", "deform_sample", "swin_block"]


@pytest.mark.parametrize("name", SOURCES)
def test_library_name_changes_with_a_header(name, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.SOURCE_DIR, csrc)
    monkeypatch.setattr(build, "SOURCE_DIR", csrc)
    before = build.library_path(name)
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path(name) != before
