"""The constant-diffusivity tick block's share of its roofline: the least
time of a pair's tick blocks at the configuration's level shapes, times the
pairs traced, over the device time of ``sor_iterations_kernel``."""

from portbench.lib.kernels import roofline_pct
from portbench.lib.roofline import sor_tick_ms


def read(ctx):
    return roofline_pct(ctx, "sor_iterations_f32", sor_tick_ms)
