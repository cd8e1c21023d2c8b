"""Data parallelism over processes, one per card (`mal_tpu.parallel`'s
counterpart), with an optional depth axis whose ranks split the cost
volume's planes: `distributed` sets up the process group and the grid of
ranks, `mesh` holds the reductions that make a step on the global batch
and the depth rows' context."""
