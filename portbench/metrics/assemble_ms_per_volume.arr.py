"""Host ms a volume that ``compensate_arr_3D`` spends outside the
``BatchMotionCorrector.run`` it calls (``get_array``'s concatenations and the
output cast), over the window's calls: a host-clock span from the benchmark's
side."""


def read(ctx):
    calls, runs = ctx.spans.get("call_s"), ctx.spans.get("run_s")
    if not calls or not runs or len(calls) != len(runs):
        return None
    return 1e3 * (sum(calls) - sum(runs)) / ctx.spans["volumes"]
