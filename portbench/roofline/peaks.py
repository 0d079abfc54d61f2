"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full 700 W power limit): float32
outside the tensor cores and HBM3 bandwidth. A roofline share is stated against these, with the card's
power limit printed beside it."""

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work: each needed input read once and each output written once at the memory
    rate, against the operations at the float32 rate; the larger of the two, and which."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def describe() -> str:
    return f"float32 {PEAK_F32_FLOPS / 1e12:g} TFLOP/s, memory {PEAK_BYTES_PER_S / 1e12:g} TB/s (H100 SXM, published)"
