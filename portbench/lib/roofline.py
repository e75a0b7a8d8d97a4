"""The yardstick's peaks and the least time of each hand-written kernel.

A bound is the larger of the bytes over the peak bandwidth and the float32
operations over the peak float32 rate, each input read once and each output
written once. Peaks: one NVIDIA H100 SXM at its 700 W limit, dense, from
NVIDIA's data sheet.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the constant-diffusivity tick block (csrc/sor_halfsweep.cu): per interior
# cell SJ 36 B and the increments 12 B read, the increments 12 B written;
# 60 operations a cell and iteration
SOR_BYTES = 60
SOR_OPS = 60
# the flow-driven-diffusivity tick block (csrc/sor_psi_iterations.cu): per
# cell the increments, base and SJ read and the increments written; about 70
# operations for psi and 120 for a half-sweep a cell and iteration
PSI_BYTES = 72
PSI_OPS = 190


def bound_ms(n_bytes, n_ops):
    """(least ms, "bytes" or "operations": which bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sor_tick_ms(ringed_shape, n_iters):
    """Least ms of one constant-diffusivity tick block of ``n_iters``
    red+black iterations over a ringed (P, M, N) level."""
    P, M, N = ringed_shape
    cells = (P - 2) * (M - 2) * (N - 2)
    return bound_ms(SOR_BYTES * cells, SOR_OPS * n_iters * cells)[0]


def psi_tick_ms(ringed_shape, n_iters):
    """Least ms of one flow-driven-diffusivity tick block of ``n_iters``
    psi -> red -> black iterations over a ringed (P, M, N) level."""
    P, M, N = ringed_shape
    cells = P * M * N
    return bound_ms(PSI_BYTES * cells, PSI_OPS * n_iters * cells)[0]
