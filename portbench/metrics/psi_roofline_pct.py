"""The flow-driven-diffusivity tick block's share of its roofline: the
least time of a pair's tick blocks at the configuration's level shapes
(each input read once, each output written once), times the pairs traced,
over the device time of ``psi_tick_block_kernel`` / ``psi_tick_phases_kernel``."""

from portbench.lib.kernels import roofline_pct
from portbench.lib.roofline import psi_tick_ms


def read(ctx):
    return roofline_pct(ctx, "sor_iterations_psi_f32", psi_tick_ms)
