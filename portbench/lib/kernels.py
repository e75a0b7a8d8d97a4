"""The port's hand-written kernels as the profiler names them: the
``__global__`` functions of ``flowreg3d_tpu_torch/csrc/*.cu`` behind its seven
entry points, and the per-pair work of the two tick blocks from the level
plan."""

import re

from portbench.reference.plain import blocks

KERNEL_SYMBOLS = {
    "sor_iterations_f32": r"\bsor_iterations_kernel\b",
    "map_coords_f32": r"\bmap_coords_kernel\b",
    "median5_f32": r"\bmedian5_kernel\b",
    "psi_field_f32": r"\bpsi_field_kernel\b",
    "sor_halfsweep_psi_f32": r"\bhalfsweep_kernel<true>",
    "sor_halfsweep_const_f32": r"\bhalfsweep_kernel<false>",
    "sor_iterations_psi_f32": r"\bpsi_tick_(block|phases)_kernel\b",
}


def is_kernel(name, entry=None):
    """Whether a device row is one of the hand-written kernels (``entry``:
    that entry point's only)."""
    pats = (KERNEL_SYMBOLS.values() if entry is None
            else (KERNEL_SYMBOLS[entry],))
    return any(re.search(p, name) for p in pats)


def is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


def tick_bound_ms(plan, params, per_block):
    """Least ms of one registration's tick blocks: ``per_block(ringed
    level shape, iterations)`` summed over the levels and their blocks."""
    total = 0.0
    for _, (z, y, x), _ in plan:
        for n in blocks(params["iterations"], params["update_lag"]):
            total += per_block((z + 2, y + 2, x + 2), n)
    return total


def roofline_pct(ctx, entry, per_block):
    """The share of its roofline that a tick block reached over the traced
    slice, or None where the slice ran none."""
    us, launches = ctx.slice.device_us(lambda n: is_kernel(n, entry))
    if not launches or us <= 0:
        return None
    bound = tick_bound_ms(ctx.plan, ctx.params, per_block) * ctx.items
    return 100.0 * bound * 1e3 / us

