"""Host ms a volume that the process's TIFF writers spent encoding, over the
process (set-up, window and traced call): ``io.tiff3d.tiff_totals()``'
encode seconds over its encoded volumes, on whichever thread the encode ran
(the async writer's, where a profiler records no range). None where no
volume was encoded or the program keeps no tally."""


def read(ctx):
    from flowreg3d_tpu_torch.io import tiff3d

    totals = getattr(tiff3d, "tiff_totals", None)
    counts = totals() if totals else {}
    if not counts.get("encoded_frames"):
        return None
    return 1e3 * counts["encode_s"] / counts["encoded_frames"]
