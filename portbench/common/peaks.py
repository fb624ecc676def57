"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit), the yardstick of every roofline share here."""
FP32_FLOPS = 67e12      # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12     # HBM3, bytes/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take for the work: the larger of its
    operations at the float32 peak and its bytes at the HBM peak."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)
