"""The frozen Mask2Former instance segmenter and the instance matcher of
the MAL temporal hint (PyTorch)."""
