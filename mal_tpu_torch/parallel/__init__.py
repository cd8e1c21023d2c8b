"""Data parallelism over processes, one per card (`mal_tpu.parallel`'s
counterpart): `distributed` sets up the process group, `mesh` holds the
reductions that make a step on the global batch."""
