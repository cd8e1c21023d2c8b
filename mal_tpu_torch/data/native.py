"""ctypes bindings for the native IO runtime (`native/malio.cpp`), the
port's counterpart of `mal_tpu.data.native`.

`libmalio.so` is compiled on first use from the repository's
`native/malio.cpp`, with the flags of `native/Makefile`, into
`build/mal_tpu_torch_native/` (nothing is written into `native/`). Every
entry point falls back to PIL / numpy when the library cannot be built, as
`mal_tpu`'s does; `build_error()` says why it could not. The batch loader
decodes and resizes straight into one contiguous float32 NHWC buffer with
a C++ thread pool.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from functools import lru_cache

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SOURCE = os.path.join(_ROOT, "native", "malio.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "mal_tpu_torch_native")
LIB_PATH = os.path.join(BUILD_DIR, "libmalio.so")
# native/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
LDLIBS = ["-ljpeg", "-lpng", "-lpthread"]


def _compile() -> None:
    """g++ into a temporary file beside the library, then an atomic rename:
    processes that build at once never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared",
                        SOURCE, "-o", tmp, *LDLIBS],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@lru_cache(maxsize=1)
def _load_lib() -> tuple[ctypes.CDLL | None, str | None]:
    """(the library, None), or (None, why it could not be built or loaded)."""
    if not os.path.exists(LIB_PATH):
        try:
            _compile()
        except subprocess.CalledProcessError as e:
            return None, f"g++ failed: {e.stderr.strip()[-2000:]}"
        except (OSError, subprocess.TimeoutExpired) as e:
            return None, f"g++ could not run: {e}"
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as e:
        return None, f"loading {LIB_PATH} failed: {e}"

    lib.malio_load_image.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.malio_load_image.restype = ctypes.c_int
    lib.malio_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.malio_load_batch.restype = ctypes.c_int
    return lib, None


def available() -> bool:
    return _load_lib()[0] is not None


def build_error() -> str | None:
    """Why the library is unavailable, or None when it loaded."""
    return _load_lib()[1]


def load_image(path: str, width: int, height: int,
               flip: bool = False) -> np.ndarray:
    """Decode + Lanczos-resize one image -> (H, W, 3) float32 in [0,1]."""
    lib = _load_lib()[0]
    if lib is None:
        return _load_image_pil(path, width, height, flip)
    out = np.empty((height, width, 3), np.float32)
    rc = lib.malio_load_image(
        path.encode(), width, height, int(flip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise FileNotFoundError(path)
    return out


def load_batch(paths: list[str], width: int, height: int,
               flips: list[bool] | None = None,
               num_threads: int = 8) -> np.ndarray:
    """Threaded batched decode -> (N, H, W, 3) float32."""
    lib = _load_lib()[0]
    if flips is None:
        flips = [False] * len(paths)
    if lib is None:
        return np.stack([_load_image_pil(p, width, height, f)
                         for p, f in zip(paths, flips)])
    n = len(paths)
    out = np.empty((n, height, width, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fl = (ctypes.c_int * n)(*[int(f) for f in flips])
    rc = lib.malio_load_batch(
        arr, fl, n, width, height, num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise FileNotFoundError(f"{rc} of {n} images failed to load")
    return out


def _load_image_pil(path: str, width: int, height: int,
                    flip: bool) -> np.ndarray:
    from PIL import Image

    from mal_tpu_torch.data.mono_dataset import _ANTIALIAS, pil_loader

    img = pil_loader(path)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    img = img.resize((width, height), _ANTIALIAS)
    return np.asarray(img, np.float32) / 255.0
