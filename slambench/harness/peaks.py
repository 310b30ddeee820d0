"""The card's published peaks and the least time of a piece of work.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet; dense rates at the 700 W
limit): HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores,
989 TFLOP/s bf16 on them. Copied from ``chip_smoke.py``'s ``bound``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}


def least_seconds(n_bytes: float, n_ops: float, kind: str = "f32") -> float:
    """Bytes over the memory rate or operations over the peak rate of
    their type, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind])
