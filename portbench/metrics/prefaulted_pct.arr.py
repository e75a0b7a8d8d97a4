"""Share of the frames the process's in-memory writers took (the registered
frames' and the flows', landed or copied in) whose every page the program's
page toucher had faulted before their copy began, in %: the program's
``io.array.write_totals()`` over the process (set-up, window and traced
call), as ``inplace_download_pct.arr`` reads its tally. Near 100 where the
toucher runs ahead of every batch's download; None where no frame was
written or the program keeps no such tally."""


def read(ctx):
    from flowreg3d_tpu_torch.io import array

    totals = getattr(array, "write_totals", None)
    if totals is None:
        return None
    counts = totals()
    n = counts["landed"] + counts["copied"]
    if "prefaulted" not in counts or not n:
        return None
    return 100.0 * counts["prefaulted"] / n
