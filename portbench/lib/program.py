"""Readings of the program's own spans and counters (``flowreg3d_tpu_torch``'s
``_trace.span`` ranges, ``_graph.capture_totals``). A program that lacks one
reads None, so these readers run on a parent that predates them."""


def span_ms(ctx, name):
    """Host ms an item of the slice's host rows named ``name`` (their
    inclusive CPU time, summed over ``ctx.items``), or None where the slice
    holds no such row."""
    rows = [r for r in ctx.slice.rows if not r["device"] and r["name"] == name]
    if not rows:
        return None
    return sum(r["cpu_us"] for r in rows) / 1e3 / ctx.items
