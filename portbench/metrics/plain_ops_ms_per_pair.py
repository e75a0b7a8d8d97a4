"""Device ms a pair of every kernel that is none of the hand-written ones
(the plain-torch level ops: resizes, motion tensor, tick update, coordinate
build, pads), copies and fills left out. Read as
``plain_ops_ms_per_pair.<tag>``, one metric for each pair rate it moves."""

from portbench.lib.kernels import is_copy, is_kernel


def read(ctx):
    us, n = ctx.slice.device_us(
        lambda name: not is_kernel(name) and not is_copy(name))
    if not n:
        return None
    return us / 1e3 / ctx.items
