"""The TIFF recording cell (``tiff_defaults.file``) on the CPU at tiny sizes:
the benchmark's plain TIFF codec against the port's, a whole run of the cell
through the harness (``correct``, its numbers 0, the traced run's readers),
``correct`` false for each fault the cell can have, and every part of the
cell found by name."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flowreg3d_tpu_torch.io import _tiff_format
from flowreg3d_tpu_torch.io.tiff3d import TIFFFileReader3D, TIFFFileWriter3D
from flowreg3d_tpu_torch.pipeline import OFOptions
from portbench import run as harness
from portbench.entries import arr
from portbench.lib.spec import Spec
from portbench.reference import tiff

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 123
CELL = "tiff_defaults.file"
IO = ("output_format", "reference_frames", "save_w", "save_meta_info")
ADDED = ("decode_ms_per_volume.file", "encode_ms_per_volume.file",
         "read_ms_per_volume.file", "write_ms_per_volume.file",
         "reference_ms_per_volume.file", "flush_ms_per_volume.file",
         "staging_copy_ms_per_volume.file", "idle_pct.file")


def _volumes(dtype, shape=(5, 3, 7, 9, 2)):
    info = np.iinfo(dtype)
    return np.random.default_rng(4).integers(
        info.min, info.max, shape, endpoint=True).astype(dtype)


def _plain_write(path, frames):
    with tiff.Writer(path, frames.shape[1:], frames.dtype) as w:
        for vol in frames:
            w.write(vol)


def _plain_read(path):
    with tiff.Reader(path) as r:
        return r.shape, np.stack([r.volume(t) for t in range(r.shape[0])])


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.uint8])
def test_plain_codec_and_the_ports_read_each_other(tmp_path, dtype):
    frames = _volumes(dtype)
    _plain_write(tmp_path / "plain.tif", frames)
    r = TIFFFileReader3D(str(tmp_path / "plain.tif"))
    got = r[:]
    r.close()
    assert got.dtype == frames.dtype
    np.testing.assert_array_equal(got, frames)

    w = TIFFFileWriter3D(str(tmp_path / "port.tif"))
    w.write_frames(frames[:2])
    w.write_frames(frames[2:])
    w.close()
    shape, got = _plain_read(tmp_path / "port.tif")
    assert shape == frames.shape and got.dtype == frames.dtype
    np.testing.assert_array_equal(got, frames)


def test_plain_reader_refuses_other_layouts(tmp_path):
    w = TIFFFileWriter3D(str(tmp_path / "float.tif"))
    w.write_frames(np.zeros((2, 3, 4, 5, 1), np.float32))
    w.close()
    bare = tmp_path / "bare.tif"         # no ImageJ description
    with _tiff_format.TiffWriter(str(bare), bigtiff=True) as tw:
        tw.write_page(np.zeros((4, 5), np.uint16))
    classic = tmp_path / "classic.tif"
    w = TIFFFileWriter3D(str(classic), bigtiff=False)
    w.write_frames(np.zeros((2, 3, 4, 5, 1), np.uint16))
    w.close()
    for path in (tmp_path / "float.tif", bare, classic):
        with pytest.raises(ValueError):
            tiff.Reader(path)


def _small(per_batch=2):
    flow = dict(Spec().config("tiff_defaults")["flow"], buffer_size=3)
    return {"config": {"shape": [10, 36, 40], "flow": flow},
            "traffic": {"frames": 7, "warm_frames": 3,
                        "check": {"frames_per_batch": per_batch}}}


def _run(trace=0, per_batch=2):
    result, _ = harness.run_cell(CELL, SEED, 0.05, trace, CPU,
                                 overrides=_small(per_batch),
                                 log=lambda msg: None)
    return result


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert {k: v["value"] for k, v in result["checks"].items()} == {
        "reg_rel_rms": 0.0, "reference_max_abs": 0.0}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"volumes_per_s", "setup_s"}


def test_traced_run_reads_the_io_metrics():
    """On the CPU the slice has the program's spans and the process its
    TIFF tally (no device rows): every new reader but the idle share reads
    a number."""
    result = _run(trace=1)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    for name in ADDED[:-1]:
        assert got[name]["value"] >= 0, (name, got)
    for name in ("decode_ms_per_volume.file", "encode_ms_per_volume.file",
                 "reference_ms_per_volume.file", "flush_ms_per_volume.file"):
        assert got[name]["value"] > 0, (name, got)
    assert "idle_pct.file" not in got


def _swapped(monkeypatch):
    """The first two volumes of every batch of two or more written in each
    other's place."""
    write = TIFFFileWriter3D.write_frames

    def swapped(self, frames):
        frames = np.asarray(frames)
        if len(frames) > 1:
            frames = frames[[1, 0] + list(range(2, len(frames)))]
        return write(self, frames)
    monkeypatch.setattr(TIFFFileWriter3D, "write_frames", swapped)


def _last_batch_dropped(monkeypatch):
    """The short last batch (1 of the tiny recording's 7 volumes, in batches
    of 3) never reaches the file."""
    write = TIFFFileWriter3D.write_frames

    def dropped(self, frames):
        if np.asarray(frames).shape[0] < 3:
            return None
        return write(self, frames)
    monkeypatch.setattr(TIFFFileWriter3D, "write_frames", dropped)


def _reference_shifted(monkeypatch):
    """The reference the mean of the frames after those named."""
    orig = OFOptions.get_reference_frame

    def shifted(self, video_reader=None, **kw):
        return orig(self.replace(reference_frames=[
            i + 1 for i in self.reference_frames]), video_reader, **kw)
    monkeypatch.setattr(OFOptions, "get_reference_frame", shifted)


@pytest.mark.parametrize("fault", [_swapped, _last_batch_dropped,
                                   _reference_shifted],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = _run(per_batch=3)
    assert not result["correct"], result["checks"]


def test_cell_parts_found_by_name():
    """Each part is found, and the cell reports at least what this file
    names (later cells and metrics may add to it)."""
    spec = Spec()
    wl = spec.workload(CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        "tiff_defaults", "file", 1)
    cfg = spec.config("tiff_defaults")
    assert cfg["reduced"] == []
    flow, io = cfg["flow"], {k: cfg["flow"][k] for k in IO}
    assert {k: v for k, v in flow.items() if k not in IO} == spec.config(
        "ofoptions_defaults")["flow"]
    assert io == {"output_format": "TIFF", "reference_frames": list(range(20)),
                  "save_w": False, "save_meta_info": True}
    OFOptions(**flow)
    tr, base = spec.traffic("file"), spec.traffic("arr")
    assert (tr["entry"], tr["frames"], tr["warm_frames"]) == ("file", 60, 10)
    assert {k: v for k, v in tr.items() if k not in (
        "entry", "why", "frames")} == {
        k: v for k, v in base.items() if k not in ("entry", "why", "frames")}
    mod = spec.entry("file")
    assert issubclass(mod.Entry, arr.Entry) and callable(mod.readings)
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    assert set(limits) == {"reg_rel_rms", "reference_max_abs"}
    names = [m["name"] for m in spec.metrics(CELL, 1)]
    assert set(ADDED) <= set(names)
    assert all(callable(spec.reader(n)) for n in names)
    assert {"volumes_per_s", "setup_s"} <= {
        m["name"] for m in spec.metrics(CELL, 0)}
