"""DualRefine (the HRNet DEQ depth-pose model) in PyTorch: the counterpart
of `mal_tpu.dualref`."""
