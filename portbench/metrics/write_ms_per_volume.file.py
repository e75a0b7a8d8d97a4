"""Host ms a volume in the program's ``flowreg3d.write`` span over the traced
``compensate_recording`` call: each batch handed to the async writer, the
calling thread blocked while its queue is full."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.write")
