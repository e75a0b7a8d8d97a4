"""The share of the traced slice (one whole call, or the traced pairs) in
which the card ran nothing: 1 - the union of its kernel and copy intervals
over the slice's length, averaged over the cards. Read as ``idle_pct.<tag>``,
one metric for each end-to-end rate it moves."""


def read(ctx):
    sl = ctx.slice
    if not sl.window_s or not sl.busy_s:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
