"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W), and the roofline bound of a
kernel, copied from the port's `chip_smoke.py:_bound`."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}


def bound_s(n_bytes: float, n_ops: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the peak rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / peak_flops)
