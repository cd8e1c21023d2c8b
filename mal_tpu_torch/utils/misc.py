"""Small host utilities (the port's copy of `mal_tpu.utils.misc`,
`manydepth/utils.py`)."""

from __future__ import annotations


def readlines(filename: str) -> list[str]:
    with open(filename) as f:
        return [l.strip() for l in f if l.strip()]


def sec_to_hm_str(t: float) -> str:
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return f"{t:02d}h{m:02d}m{s:02d}s"
