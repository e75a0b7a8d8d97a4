"""Host launch calls a volume over the traced call: graph launches and
kernel launches, plain and cooperative (the profiler's CUDA runtime rows). A
count: it jumps when a path falls off its graph."""

NAMES = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchCooperativeKernel")


def read(ctx):
    n = ctx.slice.host_count(NAMES)
    if not n:
        return None
    return n / ctx.items
