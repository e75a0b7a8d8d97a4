"""Host ms a volume in the program's ``flowreg3d.output`` span over the traced
call: compensate_arr_3D's arrays concatenated and cast to the output type."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.output")
