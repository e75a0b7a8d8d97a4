"""Host ms a volume in the program's ``flowreg3d.write`` span over the traced
call: each batch's registered frames and flows handed to the run's writers,
which ``compensate_arr_3D``'s writers copy and cast into the arrays it
returns. A program without the span reads None."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.write")
