"""Host ms a volume in the program's ``flowreg3d.read`` span over the traced
call: the batch read from the reader and its channels chosen."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.read")
