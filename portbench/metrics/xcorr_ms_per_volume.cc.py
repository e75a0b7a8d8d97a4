"""Device ms a volume of the kernels that only the cc prealignment launches
over the traced call: cuFFT's transforms of the projections
(``vector_fft<...>``, ``regular_fft<...>``) and cuBLAS's complex matrix
products of the upsampled DFT (``..._gemm_cf32cf32_...``), as the cell's own
trace names them on the H100 (torch 2.11, CUDA 12.8). None where the slice ran
none."""

import re

PATTERNS = (r"\b\w+_fft<", r"_gemm_cf32cf32_")


def is_xcorr(name):
    """Whether a device row is a prealignment-only kernel."""
    return any(re.search(p, name) for p in PATTERNS)


def read(ctx):
    us, n = ctx.slice.device_us(is_xcorr)
    if not n:
        return None
    return us / 1e3 / ctx.items
