"""Port parity: the ``flowreg3d-torch`` CLI (``flowreg3d_tpu_torch.cli``)
against the JAX package's ``flowreg3d`` CLI on the same seeded TIFF files.

Without ``--scale`` both write byte-identical files; with it the port's
resize (``--device cpu`` here) holds ``tests/test_torch_ops.py``'s resize
tolerance against the JAX one (integers: at most one count apart, on at
most 0.1% of the voxels). The default ``--device`` is cuda: on a host
without CUDA a scaling command fails and says so.
"""

import numpy as np
import pytest
import torch

from flowreg3d_tpu.cli.main import main as jax_main

from flowreg3d_tpu_torch.cli.main import build_parser, main
from flowreg3d_tpu_torch.io._tiff_format import TiffWriter
from flowreg3d_tpu_torch.io.tiff3d import TIFFFileReader3D, TIFFFileWriter3D

SI_DESC = ("SI.hStackManager.numSlices = 3\n"
           "SI.hStackManager.framesPerSlice = 2\n"
           "SI.hChannels.channelSave = [1;2]\n")


def _flat_tiff(path, n_pages, h=16, w=18, desc=None, seed=0):
    pages = (np.random.default_rng(seed).random((n_pages, h, w))
             * 500).astype(np.uint16)
    with TiffWriter(str(path)) as tw:
        if desc:
            tw.set_description(desc)
        for p in pages:
            tw.write_page(p)
    return pages


def _read(path):
    r = TIFFFileReader3D(str(path))
    data = r[:]
    r.close()
    return data


def _both(tmp_path, command, src, *args):
    """Run one command through both CLIs; returns the two output paths."""
    out = {}
    for tag, entry in (("jax", jax_main), ("torch", main)):
        dst = tmp_path / f"{tag}.tif"
        extra = ["--device", "cpu"] if tag == "torch" and "--scale" in args \
            else []
        assert entry([command, str(src), str(dst), *args, *extra]) == 0
        out[tag] = dst
    return out["jax"], out["torch"]


def test_parser_version_and_help(capsys):
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--version"])
    assert "flowreg3d-torch" in capsys.readouterr().out
    assert main([]) == 1
    assert "tiff-reshape" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["frobnicate"])
    args = build_parser().parse_args(["tiff-reshape", "a.tif", "b.tif"])
    assert args.device == "cuda"
    args = build_parser().parse_args(["concat-tiffs", "d", "b.tif"])
    assert args.device == "cuda"


@pytest.mark.parametrize("n_pages,desc,args", [
    (12, None, ["--slices-per-volume", "3"]),
    (40, None, ["-z", "4", "--start-volume", "1", "--end-volume", "9",
                "--stride", "3"]),
    (24, None, ["-z", "3", "--frames-per-slice", "2", "--channels", "2"]),
    (24, SI_DESC, []),                      # ScanImage auto-detection
    (24, None, ["-z", "2", "--channels", "2", "--split-channels"]),
])
def test_reshape_files_identical(tmp_path, n_pages, desc, args):
    src = tmp_path / "flat.tif"
    _flat_tiff(src, n_pages, desc=desc)
    want, got = _both(tmp_path, "tiff-reshape", src, *args)
    if "--split-channels" in args:
        for c in (1, 2):
            assert (tmp_path / f"torch_ch{c}.tif").read_bytes() == \
                (tmp_path / f"jax_ch{c}.tif").read_bytes()
    else:
        assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("scale", [(0.5, 0.5, 1.0), (1.5, 0.75, 0.5)])
def test_reshape_scale_matches_jax(tmp_path, scale):
    src = tmp_path / "flat.tif"
    _flat_tiff(src, 16, h=20, w=24)
    want, got = _both(tmp_path, "tiff-reshape", src, "-z", "4", "--scale",
                      *map(str, scale))
    a, b = _read(got), _read(want)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint16
    assert a.shape[1:4] == (round(4 * scale[2]), round(20 * scale[1]),
                            round(24 * scale[0]))
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def _volume_folder(tmp_path, suffixes=("",), n=4):
    folder = tmp_path / "frames"
    folder.mkdir()
    rng = np.random.default_rng(1)
    for i in range(n):
        for sfx in suffixes:
            v = (rng.random((4, 10, 12)) * 100).astype(np.uint16)
            with TIFFFileWriter3D(str(folder / f"t{i:03d}{sfx}.tif")) as w:
                w.write_frames(v[np.newaxis, ..., np.newaxis])
    return folder


@pytest.mark.parametrize("suffixes,args", [
    (("",), []),
    (("_ch1", "_ch2"), ["--channel-suffixes", "_ch1.tif", "_ch2.tif"]),
])
def test_concat_files_identical(tmp_path, suffixes, args):
    folder = _volume_folder(tmp_path, suffixes)
    want, got = _both(tmp_path, "concat-tiffs", folder, *args)
    assert got.read_bytes() == want.read_bytes()
    assert _read(got).shape == (4, 4, 10, 12, len(suffixes))


def test_concat_scale_matches_jax(tmp_path):
    folder = _volume_folder(tmp_path)
    want, got = _both(tmp_path, "concat-tiffs", folder, "--scale", "0.5",
                      "0.5", "2.0")
    a, b = _read(got), _read(want)
    assert a.shape == b.shape == (4, 8, 5, 6, 1)
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def test_guards_dry_run_and_errors(tmp_path, capsys):
    src = tmp_path / "flat.tif"
    _flat_tiff(src, 12)
    dst = tmp_path / "vol.tif"
    assert main(["tiff-reshape", str(src), str(dst), "-z", "3",
                 "--dry-run"]) == 0
    assert "Would write 4 volumes" in capsys.readouterr().out
    assert not dst.exists()
    dst.write_bytes(b"")
    assert main(["tiff-reshape", str(src), str(dst), "-z", "3"]) == 1
    assert "exists" in capsys.readouterr().err
    assert main(["tiff-reshape", str(src), str(tmp_path / "n.tif")]) == 1
    assert "slices-per-volume" in capsys.readouterr().err
    folder = tmp_path / "frames"
    folder.mkdir()
    assert main(["concat-tiffs", str(folder), str(tmp_path / "m.tif")]) == 1
    assert "No files" in capsys.readouterr().err


def test_scale_runs_on_cuda_by_default(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    src = tmp_path / "flat.tif"
    _flat_tiff(src, 8)
    dst = tmp_path / "vol.tif"
    assert main(["tiff-reshape", str(src), str(dst), "-z", "4", "--scale",
                 "0.5", "0.5", "1.0"]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert not dst.exists()
    # without --scale no device is needed
    assert main(["tiff-reshape", str(src), str(dst), "-z", "4"]) == 0
