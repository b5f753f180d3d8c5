"""Peaks of one NVIDIA H100 SXM (H100 80GB HBM3), against which the roofline
shares are stated, with their sources. They assume the card's full power
limit of 700 W; the run records the card's `power.limit` beside them."""

# Float32 outside the tensor cores: 67 TFLOP/s on NVIDIA's data sheet, which
# counts a fused multiply-add as two operations. The recursions issue
# separate adds, multiplies and compares (the kernels are built with
# --fmad=false), one a lane a clock: half that rate.
F32_OPS_PER_S = 67e12 / 2
# exp, log and log1p run on the special function units: 16 a clock on each
# SM against 128 float32 lanes, so 67e12 / 16 (derived from NVIDIA's table
# of arithmetic instruction throughput for compute capability 9.0, not from
# the data sheet).
SFU_OPS_PER_S = 67e12 / 16
# HBM3, NVIDIA's data sheet.
HBM_BYTES_PER_S = 3.35e12


def least_seconds(f32: float, sfu: float, nbytes: float) -> float:
    """The least time the card could take: float32 operations and
    transcendentals run on different units, the bytes on the memory; the
    slowest of the three bounds it."""
    return max(f32 / F32_OPS_PER_S, sfu / SFU_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)
