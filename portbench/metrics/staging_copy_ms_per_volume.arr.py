"""Host ms a volume in the program's ``flowreg3d.staging_copy`` span over the
traced call: the downloaded buffers copied into fresh pageable arrays."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.staging_copy")
