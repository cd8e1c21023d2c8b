"""The benchmark of `mal_tpu_torch` on NVIDIA GPUs.

`python -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` from the repository root
and prints one JSON line. Everything that measures lives here: the
traffic generator (`traffic.py`), the per-layer readers (`metrics/`), the
kernels' operation and byte counts (`kernels/`), the peaks (`peaks.py`),
the plain reference (`reference/`) and the comparison that decides
`correct` (`compare.py`). From the port it takes only the system under
test, its counters and its kernel names. Nothing here imports `jax` or
`mal_tpu`.
"""
