"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), as chip_smoke.py states them."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time the chip could take: operations over the peak rate or
    bytes over the memory bandwidth, whichever is longer."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
