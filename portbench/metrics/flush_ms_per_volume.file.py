"""Host ms a volume of the traced ``compensate_recording`` call in the
program's ``flowreg3d.flush`` span: the metadata files written and the
streams closed, the calling thread waiting for the writer's thread to drain
and the TIFF writer to write its IFDs. A program without the span reads
None."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.flush")
