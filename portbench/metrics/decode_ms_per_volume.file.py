"""Host ms a volume that the process's TIFF readers spent decoding, over the
process (set-up, window and traced call): ``io.tiff3d.tiff_totals()``'
decode seconds over its decoded volumes, on whichever thread the decode ran
(most on the read-ahead reader's thread, where a profiler records no range;
the reference's frames on the calling thread). None where no volume was
decoded or the program keeps no tally."""


def read(ctx):
    from flowreg3d_tpu_torch.io import tiff3d

    totals = getattr(tiff3d, "tiff_totals", None)
    counts = totals() if totals else {}
    if not counts.get("decoded_frames"):
        return None
    return 1e3 * counts["decode_s"] / counts["decoded_frames"]
