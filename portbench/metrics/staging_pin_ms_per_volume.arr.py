"""Host ms a volume in the program's ``flowreg3d.staging_pin`` span over the
traced call: allocating (page-locking) or growing the download buffers."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.staging_pin")
