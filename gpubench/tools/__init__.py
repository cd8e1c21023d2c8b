"""One-off tools of the benchmark, run on the card: the model-FLOP count
of a configuration and the readings that set `correct`'s limits."""
