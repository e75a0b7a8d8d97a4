"""Host ms a volume of the traced ``compensate_recording`` call in the
program's ``flowreg3d.reference`` span: the reference frames read by index
from the file on the calling thread, averaged, preprocessed and uploaded.
A program without the span reads None."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.reference")
