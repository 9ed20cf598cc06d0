"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full
700 W) and the byte counts of the kernels whose roofline share is read.
Frozen here so that a change to the program cannot move its own yardstick."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def biquad_section_bytes(channels: int, frames: int) -> int:
    """Least bytes one ``biquad_section`` call moves on a (C, B) block: the
    block read and the output written once in float32, and per channel the
    two-sample input tail and the two-sample state in and out (8 floats)
    plus the 6 coefficients: ``4 (2 C B + 8 C + 6)``. Its 19 flops a sample
    at the FP32 rate take less time than these bytes."""
    return 4 * (2 * channels * frames + 8 * channels + 6)


def biquad_section_least_s(channels: int, frames: int) -> float:
    return max(biquad_section_bytes(channels, frames) / HBM_BYTES_PER_S,
               19 * channels * frames / FP32_FLOP_PER_S)
