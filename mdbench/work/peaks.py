"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit): f32 outside the tensor cores and HBM3 bandwidth.  A run prints
the card's power limit beside the shares it reads (``nvidia-smi``)."""

PEAK_F32_S = 67e12
PEAK_BYTES_S = 3.35e12


def bound_s(nbytes: float, nops: float) -> float:
    """The least time: the larger of bytes over bandwidth and operations
    over the f32 peak."""
    return max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S)
