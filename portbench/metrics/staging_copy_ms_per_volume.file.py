"""Host ms a volume in the program's ``flowreg3d.staging_copy`` span over the
traced ``compensate_recording`` call: each batch's downloaded buffers copied
into fresh pageable arrays, which the async writer then holds."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.staging_copy")
