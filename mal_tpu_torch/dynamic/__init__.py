"""DynamicDepth (counterpart of `mal_tpu.dynamic`): the DOMD warp, the
occlusion-aware cost volume (kernel K6), the model and the training step."""
