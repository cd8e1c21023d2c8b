"""The plain reference of the training cells: a frozen copy of the port's
plain path (`mal_tpu_torch` at the commit that added this benchmark:
`config`, `geometry`, `losses`, `temporal`, `models/`, `ops/`, `segment/`'s
Mask2Former and matcher, `train/`), with every kernel replaced by its plain
version (`ops/kernels.py`), cut to what the benchmark's configurations
run: the ManyDepth + MAL step in one process on the global batch, the
frozen segmenter's inference forward, the default learning-rate schedule. It imports nothing of the port, of
JAX or of the JAX package; `runner.py` drives it from the seed's weights
and batches. Later changes to the port do not move it."""
