"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), stated at the card's full power limit of 700 W: every roofline
and MFU share of the benchmark is taken against these, with the card's
power limit printed beside it.
"""

PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core rate, FLOP/s
PEAK_HBM_BYTES = 3.35e12   # HBM3 rate, bytes/s
RATED_POWER_W = 700.0


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take for the work: the larger of the
    operations at the bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def roofline_share(flops: float, nbytes: float, device_s: float):
    """Percent of the roofline that `device_s` seconds of device time reach
    for the work, or None when no device time was read."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * least_seconds(flops, nbytes) / device_s


def mfu(flops: float, seconds: float):
    """Percent of the bf16 peak that `flops` of needed work over `seconds`
    of wall time reach, or None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
