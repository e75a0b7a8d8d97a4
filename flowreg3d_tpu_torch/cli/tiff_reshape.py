"""``flowreg3d-torch tiff-reshape``: flat TIFF -> proper 3D volumetric stack.

Parity target: reference cli/tiff_reshape.py — ScanImage auto-detection or
manual ``--slices-per-volume``; volume range/stride selection; frames-per-
slice averaging; optional per-axis scaling via the fused Gauss-cubic resize;
dry-run; TZYXC ImageJ hyperstack output. The resize is the port's
(``ops/resize.py``), on ``--device`` (default ``cuda``).

Note: the built-in TIFF codec writes uncompressed data; ``--compression``
values other than 'none' are accepted for CLI compatibility and ignored with
a warning.
"""

import os
import warnings

import numpy as np


def add_parser(subparsers):
    parser = subparsers.add_parser(
        "tiff-reshape",
        help="Convert flat TIFF files to proper 3D volumetric stacks",
        description="Reshape TIFFs storing 3D volumes as sequential 2D "
                    "slices into TZYXC stacks (ScanImage auto-detection, "
                    "volume selection, optional scaling).",
    )
    parser.add_argument("input_file", type=str)
    parser.add_argument("output_file", type=str)
    g = parser.add_argument_group("Structure specification")
    g.add_argument("--slices-per-volume", "-z", type=int, default=None)
    g.add_argument("--frames-per-slice", "-f", type=int, default=1)
    g = parser.add_argument_group("Volume selection")
    g.add_argument("--start-volume", "-s", type=int, default=None)
    g.add_argument("--end-volume", "-e", type=int, default=None)
    g.add_argument("--volume-stride", "--stride", type=int, default=1)
    g = parser.add_argument_group("Processing options")
    g.add_argument("--channels", type=int, default=None)
    g.add_argument("--dim-order", type=str, default=None)
    g.add_argument("--scale", nargs=3, type=float,
                   metavar=("SX", "SY", "SZ"), default=None)
    g.add_argument("--device", type=str, default="cuda",
                   help="where --scale resizes: cuda (default) or cpu")
    g.add_argument("--compression", type=str,
                   choices=["none", "lzw", "zlib", "jpeg"], default="none")
    g = parser.add_argument_group("Output options")
    g.add_argument("--output-dim-order", type=str, default="TZYXC")
    g.add_argument("--imagej", action="store_true")
    g.add_argument("--split-channels", action="store_true")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--overwrite", action="store_true")
    parser.set_defaults(func=reshape_tiff)
    return parser


def _detect_structure(args):
    """(slices, channels, frames_per_slice) from flags or metadata."""
    slices = args.slices_per_volume
    channels = args.channels
    fps = args.frames_per_slice

    if slices is None or channels is None:
        from flowreg3d_tpu_torch.io.scanimage import parse_scanimage_metadata

        meta = parse_scanimage_metadata(args.input_file)
        if meta:
            if args.verbose:
                from flowreg3d_tpu_torch.io.scanimage import format_scanimage_report

                print(format_scanimage_report(meta))
            slices = slices or meta["slices_per_volume"]
            channels = channels or meta["channels"]
            if args.frames_per_slice == 1:
                fps = meta["frames_per_slice"]
    if slices is None:
        raise ValueError(
            "Cannot auto-detect slices per volume; pass --slices-per-volume")
    return int(slices), int(channels or 1), max(1, int(fps))


def resize_on(vol, scale, device):
    """The per-axis (sx, sy, sz) fused Gauss-cubic resize of one (Z, Y, X, C)
    numpy volume on ``device`` (a torch.device); a numpy array in the
    input's dtype."""
    import torch

    from flowreg3d_tpu_torch.ops.resize import imresize_fused_gauss_cubic3D

    sx, sy, sz = scale
    Z, Y, X = vol.shape[:3]
    out_size = (max(1, round(Z * sz)), max(1, round(Y * sy)),
                max(1, round(X * sx)))
    t = torch.from_numpy(np.ascontiguousarray(vol)).to(device)
    return imresize_fused_gauss_cubic3D(t, out_size).cpu().numpy()


def _read_volume(tr, v, slices, fps, channels, S, H, W, dtype):
    """Assemble volume ``v`` as (1, Z, H, W, C) from page-granular reads.

    Page order within a volume: z-major, frames-per-slice, then channel
    (S == 1) — frames per slice are averaged (reference cli/tiff_reshape.py
    ReshapeTIFFReader behavior).
    """
    per_volume = slices * fps * (channels if S == 1 else 1)
    base = v * per_volume
    vol = np.empty((1, slices, H, W, channels), dtype)
    for z in range(slices):
        if S > 1:
            acc = np.zeros((H, W, S), np.float64)
            for f in range(fps):
                acc += tr.page_array(base + z * fps + f)
            vol[0, z] = (acc / fps).astype(dtype)
        else:
            for c in range(channels):
                acc = np.zeros((H, W), np.float64)
                for f in range(fps):
                    acc += tr.page_array(
                        base + (z * fps + f) * channels + c)
                vol[0, z, :, :, c] = (acc / fps).astype(dtype)
    return vol


def reshape_tiff(args):
    from flowreg3d_tpu_torch.io._tiff_format import TiffReader, _np_dtype

    if os.path.exists(args.output_file) and not args.overwrite:
        raise FileExistsError(
            f"{args.output_file} exists (use --overwrite)")
    if args.compression not in (None, "none"):
        warnings.warn("built-in TIFF codec writes uncompressed data; "
                      f"--compression {args.compression} ignored")

    with TiffReader(args.input_file) as tr:
        n_pages = tr.n_pages
        p0 = tr.pages[0]
        H, W, S = p0.length, p0.width, p0.samples
        dtype = _np_dtype(p0.sample_format, p0.bits, "=")

        slices, channels, fps = _detect_structure(args)
        if S > 1:
            channels = S

        per_volume = slices * fps * (channels if S == 1 else 1)
        n_volumes = n_pages // per_volume
        if n_volumes < 1:
            raise ValueError(
                f"{n_pages} pages < one volume ({per_volume} pages)")

        if args.verbose or args.dry_run:
            print(f"Input: {n_pages} pages of {H}x{W}")
            print(f"Structure: {n_volumes} volumes x {slices} slices x "
                  f"{channels} channels (frames/slice {fps})")

        start = args.start_volume or 0
        end = args.end_volume if args.end_volume is not None else n_volumes
        sel = list(range(start, min(end, n_volumes), args.volume_stride))
        if args.dry_run:
            print(f"Would write {len(sel)} volumes "
                  f"({start}..{min(end, n_volumes)} step "
                  f"{args.volume_stride}) to {args.output_file}")
            return 0

        device = None
        if args.scale is not None:
            from flowreg3d_tpu_torch._device import resolve_device

            device = resolve_device(args.device)
        # stream: one volume resident at a time -> constant memory for
        # arbitrarily long recordings (reference util/io/tiff.py:18-582)
        writer = _make_writer(args.output_file, args.split_channels,
                              channels, expected_frames=len(sel))
        try:
            for v in sel:
                vol = _read_volume(tr, v, slices, fps, channels, S, H, W,
                                   dtype)
                if args.scale is not None:
                    vol = np.stack([resize_on(v, args.scale, device)
                                    for v in vol])
                writer.write_frames(vol)
        finally:
            writer.close()
    print(f"Wrote {len(sel)} volumes to {args.output_file}")
    return 0


def _make_writer(output_file, split_channels, n_channels,
                 expected_frames=None):
    from flowreg3d_tpu_torch.io.tiff3d import TIFFFileWriter3D
    from flowreg3d_tpu_torch.io.multifile import MULTIFILEFileWriter3D

    if split_channels and n_channels > 1:
        return MULTIFILEFileWriter3D(output_file, "TIFF")
    return TIFFFileWriter3D(output_file, expected_frames=expected_frames)
