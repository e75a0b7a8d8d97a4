"""Share of the frames the process's in-memory writers took (the registered
frames' and the flows') whose download landed in the writer's array, in %:
the program's ``io.array.write_totals()`` over the process (set-up, window
and traced call), as ``graph_capture_s`` reads its tally. 100 where every
batch of ``compensate_arr_3D`` lands in place, 0 where every one is copied
in by ``write_frames``; None where no frame was written or the program keeps
no tally."""


def read(ctx):
    from flowreg3d_tpu_torch.io import array

    totals = getattr(array, "write_totals", None)
    if totals is None:
        return None
    counts = totals()
    n = counts["landed"] + counts["copied"]
    if not n:
        return None
    return 100.0 * counts["landed"] / n
