"""Frozen operation and byte counts of the port's kernels, one file a
kernel, with the names its device code has in a profiler trace. A file
whose launches need inputs that no reader can see afterwards defines
`capture(model, sink) -> hook or None`, which keeps them in `sink` during
the profiled steps of the device alone (`capture` below finds it)."""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def capture(model, captured: dict) -> list:
    """Every kernel file's hooks on `model`, each keeping its launches'
    inputs in `captured[<file's name>]`."""
    hooks = []
    for path in sorted(HERE.glob("[!_]*.py")):
        module = importlib.import_module(f"gpubench.kernels.{path.stem}")
        keep = getattr(module, "capture", None)
        hook = keep(model, captured.setdefault(path.stem, [])) if keep else None
        if hook is not None:
            hooks.append(hook)
    return hooks
