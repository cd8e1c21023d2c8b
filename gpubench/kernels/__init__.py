"""Frozen operation and byte counts of the port's kernels, one file a
kernel, with the names its device code has in a profiler trace."""
