"""Host ms a volume in the program's ``flowreg3d.cc_finalize`` span over the
traced call: the rigid flow added to each frame's residual and the raw frames
warped again, eagerly, frame by frame. A program without the span reads
None."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.cc_finalize")
