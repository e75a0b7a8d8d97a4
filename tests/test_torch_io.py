"""Port parity: the file I/O of ``flowreg3d_tpu_torch.io`` against the JAX
package's ``flowreg3d_tpu.io``, on the same seeded numpy frames.

- TIFF files the two writers make from the same frames are byte-identical,
  and each package reads the other's;
- round-trips for TIFF, HDF5, MAT v5 and v7.3 and the MULTIFILE writers
  through the port, each file also read by the JAX package; the
  MULTICHANNEL, SUBSET and Folder readers; dataset discovery;
- ScanImage metadata parsed equal from the same files and headers;
- ``PrefetchReader3D``: the stream, ``seek_frame`` and binning equal to the
  plain reader and to the JAX wrapper; a closed prefetcher's thread ends;
- ``AsyncWriter3D``: order, errors;
- ``ArrayWriter3D`` against a concatenation of its batches and the cast
  ``compensate_arr`` made before the writer cast (round half to even, then
  clip, for integer types): equal values and dtype for every output type,
  from u16 and float32, told the frame count (written in place, returned
  without a copy) or not (concatenated); more frames than told, or another
  volume shape, raise;
- ``ArrayWriter3D.frames_view``: a view filled by a plain torch ``copy_``
  and committed holds what ``write_frames`` writes, for every output type
  it offers a view for (a float output, or the source's dtype), and it
  declines the rest (an integer output from another dtype) and a writer
  told no count; the process tally and the writer's count; past the count,
  or for another volume shape, it raises as ``write_frames`` does;
- the page toucher of a counted writer: batches claimed before it reached
  their frames, after it faulted them whole and while it is inside them
  (its pace set by the test) give ``write_frames``' array bit for bit, for
  every output type, landed or written; it skips frames claimed ahead of
  it; ``write_totals()['prefaulted']`` counts only frames it faulted whole
  before their claim; no toucher thread is left after ``close``, nor after
  an in-memory run that failed; writers told no count, and arrays of one
  chunk or less, start none;
- the device cast of the registered frames (``cast_output``) equals the
  host's (``cast_frames``) bit for bit on float32 frames holding half-way
  values, values out of range on both sides and noise, for every integer
  type the device casts to;
- h5py imported only where HDF5 or MAT v7.3 is asked for, and its absence
  raised as an ImportError naming it;
- ``tiff_totals()`` counts the volumes and bytes a TIFF writer encoded and
  a reader decoded exactly, and their seconds grow, also where the async
  writer's and the read-ahead reader's threads did the work.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import flowreg3d_tpu.io.prefetch as jprefetch
import flowreg3d_tpu.io.scanimage as jscan
from flowreg3d_tpu.io import get_video_file_reader as jax_reader
from flowreg3d_tpu.io import get_video_file_writer as jax_writer
from flowreg3d_tpu.io.array import ArrayReader3D as JaxArrayReader
from flowreg3d_tpu.io.ds import find_datasets as jax_find_datasets

import flowreg3d_tpu_torch.io.scanimage as tscan
from flowreg3d_tpu_torch.io import (ArrayReader3D, ArrayWriter3D,
                                    get_video_file_reader,
                                    get_video_file_writer)
from flowreg3d_tpu_torch.io import array
from flowreg3d_tpu_torch.io.array import (cast_frames, claim_frames,
                                          write_totals)
from flowreg3d_tpu_torch.io._tiff_format import TiffWriter
from flowreg3d_tpu_torch.io.async_writer import AsyncWriter3D
from flowreg3d_tpu_torch.io.ds import (dataset_name_for_channel,
                                       find_datasets)
from flowreg3d_tpu_torch.io.multifile import (MULTICHANNELFileReader3D,
                                              SUBSETFileReader3D)
from flowreg3d_tpu_torch.io.prefetch import PrefetchReader3D
from flowreg3d_tpu_torch.io.tiff3d import tiff_totals
from flowreg3d_tpu_torch.pipeline.compensate_arr import _DTYPE_MAP
from flowreg3d_tpu_torch.pipeline.device_pipeline import cast_output

WRITERS = {"jax": jax_writer, "torch": get_video_file_writer}
READERS = {"jax": jax_reader, "torch": get_video_file_reader}


@pytest.fixture
def video():
    return (np.random.default_rng(3).random((7, 6, 10, 12, 2))
            * 1000).astype(np.uint16)


def _write(pkg, path, fmt, frames, **kw):
    w = WRITERS[pkg](str(path), fmt, **kw)
    w.write_frames(frames[:4])
    w.write_frames(frames[4:])
    w.close()


def _read(pkg, path, **kw):
    r = READERS[pkg](path if isinstance(path, list) else str(path), **kw)
    data = r[:]
    r.close()
    return data


@pytest.mark.parametrize("dtype,shape", [
    (np.uint16, (7, 6, 10, 12, 2)),
    (np.float32, (3, 4, 8, 9, 1)),
    (np.uint8, (2, 5, 7, 3, 3)),
])
def test_tiff_files_byte_identical(tmp_path, dtype, shape):
    frames = (np.random.default_rng(1).random(shape) * 200).astype(dtype)
    for pkg in WRITERS:
        _write(pkg, tmp_path / f"{pkg}.tif", "TIFF", frames)
    assert (tmp_path / "jax.tif").read_bytes() == \
        (tmp_path / "torch.tif").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_tiff_cross_read(tmp_path, video, writer, reader):
    _write(writer, tmp_path / "v.tif", "TIFF", video)
    got = _read(reader, tmp_path / "v.tif", buffer_size=3)
    assert got.dtype == video.dtype
    np.testing.assert_array_equal(got, video)


@pytest.mark.parametrize("fmt,name,kw", [
    ("TIFF", "v.tif", {}),
    ("HDF5", "v.h5", {}),
    ("HDF5", "v.h5", {"compression": "gzip", "dataset_names": "mych*"}),
    ("MAT", "v.mat", {}),
    ("MAT", "v5.mat", {"version": "5"}),
])
def test_roundtrip_and_read_by_jax(tmp_path, video, fmt, name, kw):
    _write("torch", tmp_path / name, fmt, video, **kw)
    np.testing.assert_array_equal(_read("torch", tmp_path / name), video)
    np.testing.assert_array_equal(_read("jax", tmp_path / name), video)
    if fmt == "MAT":
        from flowreg3d_tpu_torch.io.mat import is_mat73

        assert is_mat73(tmp_path / name) == (kw.get("version") != "5")


@pytest.mark.parametrize("fmt,ext", [("MULTIFILE_TIFF", ".tif"),
                                     ("MULTIFILE_HDF5", ".h5"),
                                     ("MULTIFILE_MAT", ".mat")])
def test_multifile_writer_and_multichannel_reader(tmp_path, video, fmt, ext):
    _write("torch", tmp_path / f"out{ext}", fmt, video)
    paths = [str(tmp_path / f"out_ch{c}{ext}") for c in (1, 2)]
    r = MULTICHANNELFileReader3D(paths)
    np.testing.assert_array_equal(r[:], video)
    r.close()
    np.testing.assert_array_equal(_read("torch", paths[1]), video[..., 1:])
    # the factory takes a list of paths in both packages
    np.testing.assert_array_equal(_read("torch", paths), video)
    r = jax_reader(paths)
    np.testing.assert_array_equal(r[:], video)
    r.close()


def test_folder_and_subset_readers(tmp_path, video):
    folder = tmp_path / "vols"
    folder.mkdir()
    # names that mis-sort lexicographically: natural order must win
    for a, b, name in [(0, 2, "vol_2.tif"), (2, 5, "vol_10.tif"),
                       (5, 7, "vol_100.tif")]:
        w = get_video_file_writer(str(folder / name), "TIFF")
        w.write_frames(video[a:b])
        w.close()
    (folder / "notes.txt").write_text("ignored")
    r = get_video_file_reader(str(folder), buffer_size=3)
    assert r.shape == video.shape
    np.testing.assert_array_equal(r[:], video)
    np.testing.assert_array_equal(r[[1, 4, 6]], video[[1, 4, 6]])
    sub = SUBSETFileReader3D(r, [1, 3, -1])
    np.testing.assert_array_equal(sub[:], video[[1, 3, 6]])
    r.close()
    np.testing.assert_array_equal(_read("jax", folder), video)
    (folder / "stray.h5").write_bytes(b"\x89HDF")
    with pytest.raises(ValueError, match="Mixed"):
        get_video_file_reader(str(folder))


def test_factory_array_passthrough_and_errors(tmp_path, video):
    r = get_video_file_reader(video)
    assert isinstance(r, ArrayReader3D)
    assert get_video_file_reader(r) is r
    assert isinstance(get_video_file_writer(None, "ARRAY"), ArrayWriter3D)
    with pytest.raises(ValueError, match="file_path required"):
        get_video_file_writer(None, "HDF5")
    with pytest.raises(ValueError, match="Unsupported"):
        get_video_file_writer(str(tmp_path / "x"), "AVI")
    with pytest.raises(FileNotFoundError):
        get_video_file_reader(str(tmp_path / "missing.tif"))
    (tmp_path / "x.avi").write_bytes(b"")
    with pytest.raises(ValueError, match="Unsupported file format"):
        get_video_file_reader(str(tmp_path / "x.avi"))


@pytest.mark.parametrize("info", [
    [("ch1", (4, 5, 6, 7)), ("ch2", (4, 5, 6, 7)), ("meta", (3,))],
    [("ch1", (4, 5, 6, 7)), ("ch2", (9, 5, 6, 7)), ("mov", (4, 5, 6, 7))],
    [("a", (2, 3, 4, 5)), ("b", (4, 5, 6, 7, 2))],
    [("Channel_2", (3, 4, 5, 6)), ("channel_10", (3, 4, 5, 6)),
     ("x", (1,))],
])
def test_dataset_discovery_matches_jax(info):
    assert find_datasets(info) == jax_find_datasets(info)
    assert dataset_name_for_channel(None, 2, 3) == "ch2"
    assert dataset_name_for_channel("ch*_reg", 1, 2) == "ch1_reg"
    assert dataset_name_for_channel(["a", "b"], 2, 2) == "b"
    assert dataset_name_for_channel("mov", 1, 1) == "mov"


_SI_HEADER = ("SI.VERSION_MAJOR = 2023\nSI.hChannels.channelSave = [1;2]\n"
              "SI.hStackManager.numSlices = 5\n"
              "SI.hStackManager.framesPerSlice = 1\n"
              "SI.hStackManager.numVolumes = 7\n"
              "SI.hStackManager.stackZStepSize = 2.5\n"
              "SI.hRoiManager.scanFrameRate = 30.2\n")
_SI_ROIS = {"RoiGroups": {"imagingRoiGroup": {"rois": [
    {"name": "roiA", "enable": True, "zs": [0, 10, 20],
     "scanfields": {"pixelResolutionXY": [256, 128], "centerXY": [0.1, -0.2],
                    "sizeXY": [2.0, 1.0]}}]}}}


@pytest.mark.parametrize("description,artist", [
    (_SI_HEADER.replace("\n", "\r"), json.dumps(_SI_ROIS)),
    ("scanimage legacy; SI.hChannels.channelsActive = 2; "
     "SI.hStackManager.numSlices = 6; SI.hStackManager.numVolumes = 10",
     None),
    ("no metadata here", None),
])
def test_scanimage_parse_matches_jax(tmp_path, description, artist):
    path = tmp_path / "si.tif"
    with TiffWriter(str(path)) as tw:
        tw.set_description(description)
        if artist:
            tw.set_artist(artist)
        for _ in range(70):
            tw.write_page(np.zeros((4, 6), np.uint16))
    got = tscan.parse_scanimage_metadata(str(path))
    want = jscan.parse_scanimage_metadata(str(path))
    assert got == want
    assert tscan.parse_scanimage_metadata(description) == \
        jscan.parse_scanimage_metadata(description)
    if want is not None:
        assert tscan.format_scanimage_report(got) == \
            jscan.format_scanimage_report(want)
        assert tscan.interpret_scanimage_dimensions(got, n_pages=70) == \
            jscan.interpret_scanimage_dimensions(want, n_pages=70)


def _frames(T=9):
    return np.arange(T * 2 * 3 * 4).reshape(T, 2, 3, 4, 1).astype(np.float32)


def _stream(reader):
    out = []
    while reader.has_batch():
        out.append(reader.read_batch())
    return out


@pytest.mark.parametrize("buffer_size,bin_size,seek", [
    (2, 1, 0), (4, 1, 5), (2, 2, 1), (3, 1, 9)])
def test_prefetch_stream_and_seek_match(buffer_size, bin_size, seek):
    video = _frames()
    plain = ArrayReader3D(video, buffer_size, bin_size)
    pre = PrefetchReader3D(ArrayReader3D(video, buffer_size, bin_size))
    jpre = jprefetch.PrefetchReader3D(JaxArrayReader(video, buffer_size,
                                                     bin_size))
    for r in (plain, pre, jpre):
        r.seek_frame(seek)
    want = _stream(plain)
    for got in (_stream(pre), _stream(jpre)):
        assert [b.shape for b in got] == [b.shape for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert pre.read_batch() is None
    assert pre.current_frame == plain.current_frame
    if want:                        # the stream has started
        with pytest.raises(RuntimeError, match="seek"):
            pre.seek_frame(0)
    pre.reset()
    np.testing.assert_array_equal(pre.read_batch(),
                                  video[:buffer_size * bin_size].reshape(
                                      -1, bin_size, 2, 3, 4, 1).mean(axis=1))
    np.testing.assert_array_equal(pre[1], plain[1])   # random access
    pre.close()


def test_prefetch_close_ends_its_thread():
    pre = PrefetchReader3D(ArrayReader3D(_frames(40), 1), prefetch_depth=2)
    pre.read_batch()
    worker = pre._thread
    for _ in range(100):            # the worker fills the queue and blocks
        if pre._queue.full():
            break
        threading.Event().wait(0.01)
    pre.close()
    worker.join(timeout=10)
    assert not worker.is_alive()


def test_async_writer_order_and_errors(tmp_path):
    video = (np.random.default_rng(0).random((9, 4, 6, 8, 1))
             * 100).astype(np.uint16)
    w = AsyncWriter3D(get_video_file_writer(str(tmp_path / "v.tif"),
                                            "TIFF"))
    for t0 in range(0, 9, 2):
        w.write_frames(video[t0:t0 + 2])
    w.close()
    np.testing.assert_array_equal(_read("torch", tmp_path / "v.tif"), video)
    np.testing.assert_array_equal(_read("jax", tmp_path / "v.tif"), video)

    class Boom(ArrayWriter3D):
        def write_frames(self, frames):
            raise IOError("disk full")

    w = AsyncWriter3D(Boom())
    w.write_frames(video[:1])
    w.flush()
    with pytest.raises(IOError, match="disk full"):
        w.write_frames(video[1:2])  # after a failure, writes raise
    with pytest.raises(IOError, match="disk full"):
        w.close()


def test_without_h5py_hdf5_and_mat73_raise(tmp_path, monkeypatch, video):
    """Where h5py is missing, HDF5 and MAT v7.3 raise an ImportError that
    names it when the reader or writer is made; TIFF and MAT v5 work."""
    _write("torch", tmp_path / "v.h5", "HDF5", video)
    _write("torch", tmp_path / "v.mat", "MAT", video)
    monkeypatch.setitem(sys.modules, "h5py", None)
    for make in (lambda: get_video_file_writer(str(tmp_path / "w.h5"),
                                               "HDF5"),
                 lambda: get_video_file_writer(str(tmp_path / "w.mat"),
                                               "MAT"),
                 lambda: get_video_file_reader(str(tmp_path / "v.h5")),
                 lambda: get_video_file_reader(str(tmp_path / "v.mat"))):
        with pytest.raises(ImportError, match="h5py"):
            make()
    assert not (tmp_path / "w.h5").exists()
    assert not (tmp_path / "w.mat").exists()
    _write("torch", tmp_path / "v5.mat", "MAT", video, version="5")
    _write("torch", tmp_path / "v.tif", "TIFF", video)
    np.testing.assert_array_equal(_read("torch", tmp_path / "v5.mat"), video)
    np.testing.assert_array_equal(_read("torch", tmp_path / "v.tif"), video)


def _concatenated_then_cast(batches, dtype):
    """The in-memory output as ``compensate_arr`` made it before its writer
    cast: every batch concatenated, then cast."""
    out = np.concatenate(batches, axis=0)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(dtype)
    return out.astype(dtype)


def _batches(src):
    """T=5 volumes in batches of 2, 2, 1, holding values that round half to
    even and that every integer output type clips."""
    rng = np.random.default_rng(5)
    if src == np.uint16:
        edge = [0, 1, 254, 255, 256, 32767, 32768, 65534, 65535]
        vol = rng.integers(0, 65536, (5, 3, 4, 6, 2), dtype=np.uint16)
    else:
        edge = [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 254.5, 255.5, 32767.5,
                -32768.5, 65535.5, -3e9, 2e9, 1e-3, -7.25]
        vol = (rng.standard_normal((5, 3, 4, 6, 2)) * 4e4).astype(src)
    vol.reshape(-1)[:len(edge)] = edge
    return [vol[0:2], vol[2:4], vol[4:5]]


@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("src", [np.uint16, np.float32])
@pytest.mark.parametrize("name", sorted(_DTYPE_MAP))
def test_array_writer_casts_like_concatenate_then_cast(name, src, counted):
    dtype = _DTYPE_MAP[name]
    batches = _batches(src)
    w = ArrayWriter3D(frame_count=5 if counted else None, dtype=dtype)
    for b in batches:
        w.write_frames(b)
    got = w.get_array()
    want = _concatenated_then_cast(batches, dtype)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert (w.frames_in_place, w.frames_appended) == ((5, 0) if counted
                                                      else (0, 5))
    # told the count, the writer hands back its own array, never a copy
    assert np.shares_memory(got, w.get_array()) == counted


def test_array_writer_without_a_count_concatenates():
    batches = _batches(np.uint16)
    w = ArrayWriter3D()
    for b in batches:
        w.write_frames(b)
    w.write_frames(batches[0][0])       # one (Z,Y,X,C) volume
    got = w.get_array()
    np.testing.assert_array_equal(
        got, np.concatenate(batches + [batches[0][:1]]))
    assert got.dtype == np.uint16
    assert (w.frames_in_place, w.frames_appended) == (0, 6)
    assert ArrayWriter3D().get_array() is None


def test_array_writer_told_a_count_raises_beyond_it():
    batches = _batches(np.float32)
    w = ArrayWriter3D(frame_count=3)
    w.write_frames(batches[0])
    np.testing.assert_array_equal(w.get_array(), batches[0])
    with pytest.raises(ValueError, match="told 3 frames and got 4"):
        w.write_frames(batches[1])
    with pytest.raises(ValueError, match="Expected volumes"):
        w.write_frames(batches[2][..., :1])
    w.write_frames(batches[2])
    assert w.frames_in_place == 3 and w.frames_appended == 0
    np.testing.assert_array_equal(w.get_array(),
                                  np.concatenate([batches[0], batches[2]]))


@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("src", [np.uint16, np.float32])
@pytest.mark.parametrize("name", sorted(_DTYPE_MAP))
def test_array_writer_view_filled_by_copy_equals_written(name, src, counted):
    """Batches filled into the writer's views by a plain torch ``copy_``
    and committed, where it offers views, else written: the array of
    ``write_frames`` alone."""
    dtype = np.dtype(_DTYPE_MAP[name])
    offers = counted and (dtype == src or dtype.kind == "f")
    batches = _batches(src)
    w = ArrayWriter3D(frame_count=5 if counted else None, dtype=dtype)
    before = write_totals()
    for b in batches:
        view = w.frames_view(len(b), b.shape[1:], b.dtype)
        assert (view is not None) == offers
        if view is None:
            w.write_frames(b)
        else:
            torch.from_numpy(view).copy_(torch.from_numpy(b))
            w.commit_frames(len(b))
    got = w.get_array()
    want = _concatenated_then_cast(batches, dtype)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    landed = 5 if offers else 0
    assert (w.frames_in_place, w.frames_landed) == ((5 if counted else 0),
                                                    landed)
    after = write_totals()
    assert (after["landed"] - before["landed"],
            after["copied"] - before["copied"]) == (landed, 5 - landed)


def test_array_writer_view_raises_beyond_the_count():
    batches = _batches(np.float32)
    w = ArrayWriter3D(frame_count=3)
    view = w.frames_view(2, batches[0].shape[1:], np.float32)
    view[...] = batches[0]
    w.commit_frames(2)
    with pytest.raises(ValueError, match="told 3 frames and got 4"):
        w.frames_view(2, batches[1].shape[1:], np.float32)
    with pytest.raises(ValueError, match="told 3 frames and got 4"):
        w.commit_frames(2)
    with pytest.raises(ValueError, match="Expected volumes"):
        w.frames_view(1, batches[2].shape[1:4] + (1,), np.float32)
    w.frames_view(1, batches[2].shape[1:], np.float32)[...] = batches[2]
    w.commit_frames(1)
    assert (w.frames_in_place, w.frames_landed) == (3, 3)
    np.testing.assert_array_equal(w.get_array(),
                                  np.concatenate([batches[0], batches[2]]))


def _touchers():
    return [t for t in threading.enumerate()
            if t.name == array.TOUCHER_NAME]


class _GatedToucher:
    """The page toucher at the test's pace: each chunk waits for a permit
    (``go``); while it runs, a helper lets go of a chunk that a claim waits
    for, and only of such a chunk. ``touched`` lists the data address of
    every chunk touched, in order."""

    def __init__(self, monkeypatch):
        self.go = threading.Semaphore(0)
        self.touched = []
        self._stop = threading.Event()
        touch = array._touch

        def gated(chunk):
            assert self.go.acquire(timeout=30)
            touch(chunk)
            self.touched.append(chunk.ctypes.data)

        monkeypatch.setattr(array, "_touch", gated)
        self._helper = threading.Thread(target=self._release_waited)
        self._helper.start()

    def _release_waited(self):
        toucher = array._TOUCHER
        while not self._stop.wait(0.001):
            with toucher.cond:
                waited = toucher._touching_claimed()
            if waited:
                self.go.release()
                with toucher.cond:
                    toucher.cond.wait_for(
                        lambda: not toucher._touching_claimed(), timeout=30)

    @staticmethod
    def _until(ready):
        deadline = time.monotonic() + 30
        while True:
            with array._TOUCHER.cond:
                if ready():
                    return
            assert time.monotonic() < deadline
            time.sleep(0.001)

    def run_to(self, writer, frame):
        """Let the toucher, once it waits at a chunk of ``writer``, fault
        its frames up to ``frame``; returns once it waits at the next."""
        toucher = array._TOUCHER
        self._until(lambda: toucher.busy is writer)
        self.go.release(frame - writer._touch_at)
        self._until(lambda: writer._touch_at == frame
                    and toucher.busy is writer)

    def close(self):
        self._stop.set()
        self._helper.join(timeout=30)
        assert not self._helper.is_alive()


@pytest.mark.parametrize("landing", [True, False])
@pytest.mark.parametrize("src", [np.uint16, np.float32])
@pytest.mark.parametrize("name", sorted(_DTYPE_MAP))
def test_toucher_never_writes_into_claimed_frames(monkeypatch, name, src,
                                                  landing):
    """A counted writer whose toucher goes at the test's pace (a chunk a
    frame): batch 0 claimed before the toucher reached its frames, batch 1
    after it faulted them whole, batch 2 while it is in the frame. The
    array equals ``write_frames``' bit for bit, the toucher skipped the
    frames claimed ahead of it, and only batch 1's frames count as
    prefaulted."""
    dtype = np.dtype(_DTYPE_MAP[name])
    batches = _batches(src)
    monkeypatch.setattr(array, "_CHUNK",
                        int(np.prod(batches[0].shape[1:])) * dtype.itemsize)
    gate = _GatedToucher(monkeypatch)
    w = ArrayWriter3D(frame_count=5, dtype=dtype)
    before = write_totals()
    try:
        for b, frame in zip(batches, (None, 4, None)):
            if frame is not None:
                gate.run_to(w, frame)
            view = w.frames_view(len(b), b.shape[1:], b.dtype) if landing \
                else None
            if view is None:
                w.write_frames(b)
            else:
                claim_frames([(w, len(b))])
                torch.from_numpy(view).copy_(torch.from_numpy(b))
                w.commit_frames(len(b))
        got = w.get_array()
        w.close()
    finally:
        gate.close()
    np.testing.assert_array_equal(got, _concatenated_then_cast(batches,
                                                               dtype))
    assert got.dtype == dtype
    frames = [(a - w.get_array().ctypes.data) // w.get_array()[0].nbytes
              for a in gate.touched]
    # frame 0 only where the toucher began it before batch 0's claim;
    # frame 1 never
    assert frames in ([0, 2, 3, 4], [2, 3, 4]), frames
    assert write_totals()["prefaulted"] - before["prefaulted"] == 2
    assert _touchers() == []


def test_prefaulted_counts_frames_touched_whole(monkeypatch):
    """Frames of two chunks: a frame the toucher is inside when it is
    claimed does not count, although the claim lets that chunk finish."""
    batches = _batches(np.float32)
    frame_bytes = int(np.prod(batches[0].shape[1:])) * 4
    monkeypatch.setattr(array, "_CHUNK", frame_bytes // 2)
    gate = _GatedToucher(monkeypatch)
    w = ArrayWriter3D(frame_count=5, dtype=np.float32)
    before = write_totals()
    try:
        w.write_frames(np.zeros((0,) + batches[0].shape[1:], np.float32))
        gate.go.release(5)      # frames 0 and 1, and half of frame 2
        gate._until(lambda: len(gate.touched) == 5
                    and array._TOUCHER.busy is w)
        w.write_frames(np.concatenate(batches[:2]))
        w.write_frames(batches[2])
        w.close()
    finally:
        gate.close()
    np.testing.assert_array_equal(w.get_array(), np.concatenate(batches))
    assert write_totals()["prefaulted"] - before["prefaulted"] == 2
    # in half frames: 0 to 2 whole (2's second half after its claim, which
    # waited for it), 3 skipped, 4's first half begun before its claim
    base = w.get_array().ctypes.data
    assert [(a - base) * 2 // frame_bytes for a in gate.touched] == \
        [0, 1, 2, 3, 4, 5, 8]
    assert _touchers() == []


def test_toucher_ends_with_close_and_uncounted_writers_start_none(
        monkeypatch):
    monkeypatch.setattr(array, "_CHUNK", 64)
    touch = array._touch
    monkeypatch.setattr(array, "_touch",
                        lambda chunk: (time.sleep(0.01), touch(chunk)))
    batches = _batches(np.uint16)
    for w in (ArrayWriter3D(), ArrayWriter3D(dtype=np.float64)):
        for b in batches:
            w.write_frames(b)
        assert _touchers() == []
        w.close()
    # a counted writer's array no larger than a chunk is faulted by its copy
    monkeypatch.setattr(array, "_CHUNK", 1 << 20)
    w = ArrayWriter3D(frame_count=5)
    w.write_frames(batches[0])
    assert _touchers() == []
    monkeypatch.setattr(array, "_CHUNK", 64)
    w = ArrayWriter3D(frame_count=5, dtype=np.float64)
    w.write_frames(batches[0])
    assert len(_touchers()) == 1         # the slowed toucher still runs
    got = w.get_array()
    w.close()
    assert _touchers() == []
    np.testing.assert_array_equal(got, batches[0].astype(np.float64))
    w.close()                               # closing again does nothing


def test_no_toucher_outlives_a_failed_run(monkeypatch):
    """An in-memory run that raises in its second batch: its writers are
    closed, so their toucher ends with the call."""
    from flowreg3d_tpu_torch.pipeline import OFOptions, compensate_arr_3D
    from flowreg3d_tpu_torch.pipeline.device_pipeline import ResidentPipeline

    monkeypatch.setattr(array, "_CHUNK", 64)
    touch = array._touch
    monkeypatch.setattr(array, "_touch",
                        lambda chunk: (time.sleep(0.01), touch(chunk)))
    run_batch = ResidentPipeline.run_batch
    seen = []

    def failing(self, *a, **kw):
        seen.append(len(_touchers()))
        if len(seen) == 2:
            raise RuntimeError("card lost")
        return run_batch(self, *a, **kw)

    monkeypatch.setattr(ResidentPipeline, "run_batch", failing)
    frames = (np.random.default_rng(0).uniform(0, 1, (5, 6, 16, 16, 1))
              * 1e4).astype(np.uint16)
    with pytest.raises(RuntimeError, match="card lost"):
        compensate_arr_3D(frames, frames[:2].mean(axis=0),
                          OFOptions(alpha=(1.5, 1.5, 1.5), iterations=2,
                                    levels=2, min_level=1, buffer_size=2,
                                    quality_setting="fast"), device="cpu")
    assert seen == [1, 1]       # it ran through both batches' start
    assert _touchers() == []


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint16])
def test_cast_output_equals_cast_frames(dtype):
    """The registered frames' cast on the device against the host's, which
    the host-staged engine ran before it cast on the device."""
    info = np.iinfo(dtype)
    halves = np.arange(-6, 7) + 0.5
    edges = [info.min - 0.5, info.min - 0.49, info.min - 1.0, info.min - 1e6,
             info.max + 0.5, info.max + 0.49, info.max + 1.0, info.max + 1e6,
             info.min + 0.5, info.max - 0.5, -0.0, 0.0, -3e9, 3e9]
    noise = np.random.default_rng(7).standard_normal(4000) * info.max
    x = np.concatenate([halves, info.max // 2 + halves, edges,
                        noise]).astype(np.float32).reshape(2, -1, 2)
    got = cast_output(torch.from_numpy(x), dtype).numpy()
    want = cast_frames(x, np.dtype(dtype))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def _totals_added(before):
    after = tiff_totals()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("threads", [False, True])
def test_tiff_totals_count_reads_and_writes(tmp_path, video, threads):
    """A write of 7 volumes in two batches and a stream of them in batches
    of 3 (``threads``: through the async writer and the read-ahead reader,
    whose threads do the work), then one more volume read by index."""
    path = tmp_path / "v.tif"
    before = tiff_totals()
    w = get_video_file_writer(str(path), "TIFF")
    if threads:
        w = AsyncWriter3D(w)
    w.write_frames(video[:4])
    w.write_frames(video[4:])
    w.close()
    added = _totals_added(before)
    assert (added["encoded_frames"], added["encoded_bytes"]) == (
        7, video.nbytes)
    assert added["encode_s"] > 0
    assert added["decoded_frames"] == added["decoded_bytes"] == 0

    before = tiff_totals()
    r = get_video_file_reader(str(path), buffer_size=3)
    if threads:
        r = PrefetchReader3D(r, prefetch_depth=2)
    got = [r.read_batch() for _ in range(3)]
    assert r.read_batch() is None
    np.testing.assert_array_equal(r[[5]], video[5:6])
    r.close()
    np.testing.assert_array_equal(np.concatenate(got), video)
    added = _totals_added(before)
    assert (added["decoded_frames"], added["decoded_bytes"]) == (
        8, video.nbytes + video[5].nbytes)
    assert added["decode_s"] > 0
    assert added["encoded_frames"] == added["encode_s"] == 0
