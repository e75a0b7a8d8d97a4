"""Host ms a volume in the program's ``flowreg3d.staging_wait`` span over the
traced call: the host blocked on the card before each batch's download, which
on the host-staged engine holds the batch's whole device work."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.staging_wait")
