"""Host ms a volume in the program's ``flowreg3d.enqueue`` span over the traced
call: the host queuing each batch's device work (preprocessing, initial w,
the graph replays, tail mean, reference update, cast, statistics, masks)."""

from portbench.lib.program import span_ms


def read(ctx):
    return span_ms(ctx, "flowreg3d.enqueue")
