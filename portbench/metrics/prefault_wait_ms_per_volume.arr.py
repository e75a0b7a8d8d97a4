"""Host ms a volume in the program's ``flowreg3d.prefault_wait`` span over
the traced call: each batch's frames claimed from the in-memory writers'
page toucher before the download is copied into them, the host waiting for
the chunk the toucher is in. A program without the span reads None."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.prefault_wait")
