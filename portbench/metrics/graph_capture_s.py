"""Seconds the process spent capturing CUDA graphs (``_graph.cached``'s
misses: set-up, window and slice, every kind summed), from the program's
``_graph.capture_totals()``; None where nothing was captured or the program
keeps no tally."""


def read(ctx):
    from flowreg3d_tpu_torch import _graph

    totals = getattr(_graph, "capture_totals", None)
    captures = totals() if totals else {}
    if not any(n for n, _ in captures.values()):
        return None
    return sum(s for _, s in captures.values())
