"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates): the yardstick of every roofline share.

A kernel's least time is the largest of its tensor-core products at the
dense TF32 rate, its other operations at the FP32 rate and its bytes at
the HBM bandwidth.  The products of an f32 kernel are reckoned as one
TF32 pass, so no implementation, however it forms them, reads above
100%; the port's 3xTF32 convention (three passes) is ``tc_passes=3``.
"""

PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(work: dict, tc_passes: int = 1) -> float:
    """The least seconds the card takes for ``work`` ({"tc_flops",
    "flops", "bytes"})."""
    return max(tc_passes * work["tc_flops"] / PEAK_TF32_FLOPS,
               work["flops"] / PEAK_FP32_FLOPS,
               work["bytes"] / PEAK_HBM_BYTES)


def compute_seconds(work: dict) -> float:
    """The least seconds of ``work``'s operations alone (the step's
    share of the chip's peak counts these)."""
    return max(work["tc_flops"] / PEAK_TF32_FLOPS,
               work["flops"] / PEAK_FP32_FLOPS)
