"""Host ms a volume in the program's ``flowreg3d.read`` span over the traced
``compensate_recording`` call: the calling thread waiting on the read-ahead
reader's queue for each batch, and its channels chosen."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.read")
