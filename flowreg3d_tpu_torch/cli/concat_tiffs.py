"""``flowreg3d-torch concat-tiffs``: per-timepoint volumes -> one movie.

Parity target: reference cli/concat_tiffs.py — lexicographic file ordering,
multichannel via filename suffixes with base-name alignment checks, optional
per-axis scaling (the port's resize, on ``--device``, default ``cuda``),
dry-run, TZYXC ImageJ hyperstack output.
"""

import os
from pathlib import Path

import numpy as np


def add_parser(subparsers):
    parser = subparsers.add_parser(
        "concat-tiffs",
        help="Concatenate per-volume 3D files from a folder into a TIFF movie",
        description="Each input file is one timepoint (Z,Y,X[,C]); files are "
                    "stacked in sorted order into a TZYXC hyperstack.",
    )
    parser.add_argument("input_folder", type=str)
    parser.add_argument("output_file", type=str)
    parser.add_argument("--pattern", "-p", type=str, default="*.tif*")
    parser.add_argument("--dim-order", type=str, default=None)
    parser.add_argument("--channel-suffixes", nargs="+", default=None)
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--output-dim-order", type=str, default="TZYXC")
    parser.add_argument("--split-channels", action="store_true")
    parser.add_argument("--scale", nargs=3, type=float,
                        metavar=("SX", "SY", "SZ"), default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where --scale resizes: cuda (default) or cpu")
    parser.set_defaults(func=concat_tiffs)
    return parser


def _read_volume(path, dim_order):
    from flowreg3d_tpu_torch.io._tiff_format import TiffReader

    with TiffReader(str(path)) as tr:
        arr = tr.asarray()  # (N,H,W[,S])
    if arr.ndim == 4:  # pages with samples -> (Z,Y,X,C)
        return arr
    if dim_order:
        order = dim_order.upper()
        if "C" not in order:
            arr = arr[..., np.newaxis]
            order += "C"
        perm = [order.index(d) for d in "ZYXC" if d in order]
        return np.transpose(arr, perm)
    return arr[..., np.newaxis]  # (Z,Y,X,1)


def _group_by_suffix(files, suffixes):
    """Align per-channel files by shared basename; error on mismatches."""
    groups = {}
    for sfx in suffixes:
        members = sorted(f for f in files if f.name.endswith(sfx))
        bases = [f.name[: -len(sfx)] for f in members]
        groups[sfx] = (bases, members)
    base_sets = [tuple(b) for b, _ in groups.values()]
    if len(set(base_sets)) != 1:
        raise ValueError(
            "Channel suffix groups do not share identical base names: "
            + ", ".join(f"{s}:{len(b)}" for s, (b, _) in groups.items()))
    return [groups[s][1] for s in suffixes]


def concat_tiffs(args):
    folder = Path(args.input_folder)
    if not folder.is_dir():
        raise NotADirectoryError(f"Not a folder: {folder}")
    if os.path.exists(args.output_file) and not args.overwrite:
        raise FileExistsError(f"{args.output_file} exists (use --overwrite)")

    files = sorted(folder.glob(args.pattern))
    if not files:
        raise FileNotFoundError(
            f"No files matching '{args.pattern}' in {folder}")

    if args.channel_suffixes:
        channel_files = _group_by_suffix(files, args.channel_suffixes)
        n_t = len(channel_files[0])
    else:
        channel_files = [files]
        n_t = len(files)

    if args.dry_run or args.verbose:
        print(f"Found {n_t} timepoints x {len(channel_files)} channel "
              f"file(s) in {folder}")
    if args.dry_run:
        first = _read_volume(channel_files[0][0], args.dim_order)
        print(f"First volume shape: {first.shape}")
        print(f"Would write {args.output_file}")
        return 0

    # stream: one timepoint resident at a time -> constant memory for
    # arbitrarily many per-timepoint files
    from flowreg3d_tpu_torch.io.tiff3d import TIFFFileWriter3D
    from flowreg3d_tpu_torch.io.multifile import MULTIFILEFileWriter3D

    device = None
    if args.scale is not None:
        from flowreg3d_tpu_torch._device import resolve_device

        device = resolve_device(args.device)

    writer = None
    first_shape = None
    try:
        for t in range(n_t):
            chans = [_read_volume(group[t], args.dim_order)
                     for group in channel_files]
            vol = (np.concatenate(chans, axis=-1) if len(chans) > 1
                   else chans[0])
            if first_shape is None:
                first_shape = vol.shape
            elif vol.shape != first_shape:
                raise ValueError(
                    f"Volume {t} shape {vol.shape} != first {first_shape}")
            if args.verbose:
                print(f"  [{t + 1}/{n_t}] {vol.shape}")
            if args.scale is not None:
                from flowreg3d_tpu_torch.cli.tiff_reshape import resize_on

                vol = resize_on(vol, args.scale, device)
            if writer is None:
                if args.split_channels and vol.shape[-1] > 1:
                    writer = MULTIFILEFileWriter3D(args.output_file, "TIFF")
                else:
                    writer = TIFFFileWriter3D(args.output_file,
                                              expected_frames=n_t)
            writer.write_frames(vol[np.newaxis])
    finally:
        if writer is not None:
            writer.close()
    print(f"Wrote {n_t} timepoints to {args.output_file}")
    return 0
