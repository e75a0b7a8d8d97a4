"""Host ms a volume in the program's ``flowreg3d.upload`` span over the traced
call: the raw batch's host-to-device copy and dtype cast."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.upload")
