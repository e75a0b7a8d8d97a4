"""Host launch calls a volume over the traced call under the cc prealignment:
graph launches and kernel launches, plain and cooperative (the profiler's CUDA
runtime rows). It jumps if the prealignment falls off its graph, and it counts
the eager re-warp's launches."""

NAMES = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchCooperativeKernel")


def read(ctx):
    n = ctx.slice.host_count(NAMES)
    if not n:
        return None
    return n / ctx.items
