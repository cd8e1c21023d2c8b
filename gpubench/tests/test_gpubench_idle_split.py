"""The split of the device's idle time by the program's spans
(`tools/idle_split.py`) on hand-made traces: the pieces partition the
idle, nesting goes to the innermost span, time outside every span to
`outside`, and the per-step numbers."""

import pytest

from gpubench.tools import idle_split
from gpubench.trace import Trace

BASE = 1_000_000_000   # the trace's baseTimeNanoseconds


def _trace(busy_us: list) -> Trace:
    """A trace whose device ran over `busy_us` (start, end) microseconds
    after the base."""
    device = [("k", a, b - a, i) for i, (a, b) in enumerate(busy_us)]
    return Trace(device, {}, [], 0.0, 1)


def _ns(us: float) -> int:
    return BASE + int(us * 1e3)


def test_nesting_goes_to_the_innermost_span():
    # step [10, 90] holds losses [20, 60], which holds matching [30, 50];
    # the device busy over [0, 25], [35, 40], [55, 70]
    spans = [("mal.step", _ns(10), _ns(90), None, 0),
             ("mal.losses", _ns(20), _ns(60), 0, 0),
             ("mal.matching", _ns(30), _ns(50), 1, 0)]
    tr = _trace([(0, 25), (35, 40), (55, 70)])
    got = idle_split.idle_by_span(tr, BASE, spans, _ns(0), _ns(100))
    want = {"mal.losses": 10e-6,       # [25, 30] + [50, 55]
            "mal.matching": 15e-6,     # [30, 35] + [40, 50]
            "mal.step": 20e-6,         # [70, 90]
            "outside": 10e-6}          # [90, 100]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


@pytest.mark.parametrize("busy", [[], [(0, 100)], [(5, 6), (7, 8), (50, 99)],
                                  [(-10, 3), (2, 40), (39, 41), (95, 130)]])
def test_pieces_partition_the_idle(busy):
    spans = [("mal.step", _ns(1), _ns(60), None, 0),
             ("mal.depth_model", _ns(2), _ns(20), 0, 0),
             ("mal.backward", _ns(25), _ns(55), 0, 0),
             ("mal.step", _ns(61), _ns(98), None, 1),
             ("mal.optimizer", _ns(70), None, 3, 1)]
    tr = _trace(busy)
    got = idle_split.idle_by_span(tr, BASE, spans, _ns(0), _ns(100))
    covered, at = 0.0, 0.0
    for a, b in sorted(busy):
        a, b = max(a, 0.0), min(b, 100.0)
        covered += max(0.0, b - max(a, at))
        at = max(at, b)
    assert sum(got.values()) == pytest.approx((100.0 - covered) * 1e-6,
                                              abs=1e-12)
    assert all(v > 0 for v in got.values())


def test_split_metrics_per_step():
    idle = {"mal.depth_model": 0.002, "mal.losses": 0.010,
            "mal.segmenter": 0.001, "mal.matching": 0.0005,
            "mal.matching.wait": 0.0005, "mal.matching.solve": 0.008,
            "mal.backward": 0.020, "mal.optimizer": 0.006,
            "mal.synthesis": 0.001, "mal.step": 0.001, "outside": 0.002}
    spans = [("mal.matching.solve", 0, 4_000_000, 2, 0),
             ("mal.matching.solve", 10_000_000, 15_000_000, 9, 1)]
    got = idle_split.split_metrics(idle, spans, {"host_syncs": 54}, 2)
    assert got == pytest.approx({
        "idle_ms.depth_model": 1.0, "idle_ms.losses": 5.0,
        "idle_ms.segmenter": 0.5, "idle_ms.matching": 4.5,
        "idle_ms.backward": 10.0, "idle_ms.optimizer": 3.0,
        "idle_ms.glue": 1.0, "idle_ms.outside": 1.0,
        "matching_host_ms": 4.5, "host_syncs_per_step": 27.0})
