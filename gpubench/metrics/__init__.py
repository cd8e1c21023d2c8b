"""One reader a per-layer metric, `metrics/<metric>.py`, found by the
metric's name in `BENCHMARK.json`. Each `read(ctx)` takes `run.py`'s
`Context` and returns the metric's value, or None where it finds nothing
to read (the harness then leaves the metric out)."""
