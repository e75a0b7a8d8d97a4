"""Host ms a volume in the program's ``flowreg3d.prealign`` span over the
traced call: every frame of a batch prealigned (one prealignment graph replay
a frame on a card). A program without the span reads None."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.prealign")
