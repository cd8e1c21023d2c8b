"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/mal_tpu_torch_kernels/lib<name>-<hash>.so`
under the repository root, then loaded with `ctypes`. The hash covers the
source, every `csrc/*.cuh` header and the compiler flags, so an edited
source or header is rebuilt and an unchanged one is reused. Builds happen
at first use, never at import. A missing or failing `nvcc` is an error:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "mal_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the port's CUDA kernels can not be built")


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` lives."""
    h = hashlib.sha256()
    for path in [SOURCE_DIR / f"{name}.cu", *sorted(SOURCE_DIR.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(names: list[str]) -> dict[str, str]:
    """Compile every named source not yet built, one `nvcc` each, all at
    once. Returns each name's compiler log (register and spill counts)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, so)
    logs = {}
    failed = []
    for name, (proc, tmp, so) in pending.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, so)  # atomic: a reader never sees half a library
            so.with_suffix(".log").write_text(logs[name])
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    build_libraries([name])
    return ctypes.CDLL(str(library_path(name)))
