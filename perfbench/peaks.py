"""Published peaks of one NVIDIA H100 SXM and the least time of a piece of
work: a frozen copy of ``chip_smoke.py``'s ``PEAK_*`` and ``bound()``,
changed to return seconds.

NVIDIA's data sheet, dense rates without sparsity, at the full 700 W power
limit: 495 TFLOP/s in TF32 on the tensor cores, 67 TFLOP/s in float32 on
the CUDA cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """Least seconds for the work: the bytes over the memory rate against the
    operations, ``tc_flops`` of them over the TF32 tensor-core peak and the
    rest over the f32 CUDA-core peak; and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, tc_flops / PEAK_TF32 + (flops - tc_flops) / PEAK_F32
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
