"""3D TIFF reader/writer (ImageJ hyperstack layout) on the built-in codec.

Parity target: reference util/io/tiff_3d.py — reader with arbitrary
``dim_order`` permutation to TZYXC, ImageJ-hyperstack metadata detection, and
implicit-channel handling (:24-201); streaming writer emitting ImageJ
hyperstack metadata with page order T→Z→C (C fastest), BigTIFF by default
(:204-451). Uses flowreg3d_tpu_torch.io._tiff_format instead of tifffile.

A reader's decode (``_read_raw_frames``) opens the span ``flowreg3d.decode``
and a writer's encode (``write_frames``) ``flowreg3d.encode``; both usually run
on the read-ahead and writer threads, where a profiler started on the calling
thread records no range. So ``tiff_totals()`` also counts the volumes, bytes
and host seconds each took over the process, on whichever thread it ran.
"""

import os
import threading
from time import perf_counter

import numpy as np

from flowreg3d_tpu_torch._trace import span
from flowreg3d_tpu_torch.io._tiff_format import (
    TiffReader,
    TiffWriter,
    build_imagej_description,
)
from flowreg3d_tpu_torch.io.base import VideoReader3D, VideoWriter3D

# volumes, bytes and host seconds the process's TIFF readers decoded and its
# writers encoded, on any thread
_TOTALS = dict.fromkeys(("decoded_frames", "decoded_bytes", "decode_s",
                         "encoded_frames", "encoded_bytes", "encode_s"), 0)
_TOTALS_LOCK = threading.Lock()


def tiff_totals():
    """{'decoded_frames', 'decoded_bytes', 'decode_s', 'encoded_frames',
    'encoded_bytes', 'encode_s'}: the volumes (T entries), their bytes and
    the host seconds that every ``TIFFFileReader3D._read_raw_frames`` and
    ``TIFFFileWriter3D.write_frames`` of the process took."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def _tally(kind, frames, t0):
    """Add a decode's or an encode's (T,Z,Y,X,C) ``frames`` and its seconds
    since ``t0`` to the process's totals."""
    seconds = perf_counter() - t0
    with _TOTALS_LOCK:
        _TOTALS[f"{kind}d_frames"] += frames.shape[0]
        _TOTALS[f"{kind}d_bytes"] += frames.nbytes
        _TOTALS[f"{kind}_s"] += seconds


class TIFFFileReader3D(VideoReader3D):
    """Streaming page-based TIFF reader with constant-memory access.

    Pages are decoded on demand per requested frame (reference
    util/io/tiff.py's page-granular streaming, :18-582), so recordings far
    larger than host RAM stream through ``read_batch`` in constant memory.
    ImageJ hyperstacks (page order T->Z->C, C fastest) and interleaved-
    channel pages (samples-per-pixel -> deinterleaved channels) resolve the
    (t, z, c) -> page mapping directly; exotic ``dim_order`` layouts fall
    back to an eager whole-file load + transpose.
    """

    def __init__(self, file_path, buffer_size=10, bin_size=1,
                 dim_order="TZYXC", **kwargs):
        super().__init__()
        self.file_path = str(file_path)
        self.buffer_size = buffer_size
        self.bin_size = bin_size
        self.dim_order = dim_order.upper()
        if not set("TXYZ").issubset(set(self.dim_order)):
            raise ValueError(
                f"dim_order must contain T, X, Y, Z. Got: {dim_order}")
        self._data = None      # eager-fallback storage
        self._tf = None        # streaming page reader
        self._samples = 1
        if not os.path.isfile(self.file_path):
            raise FileNotFoundError(f"TIFF file not found: {file_path}")

    def _initialize(self):
        self._tf = TiffReader(self.file_path)
        ij = self._tf.imagej_metadata
        n = self._tf.n_pages
        p0 = self._tf.pages[0]
        H, W, S = p0.length, p0.width, p0.samples
        self._samples = S

        if ij:
            frames = int(ij.get("frames", 1))
            slices = int(ij.get("slices", 1))
            channels = int(ij.get("channels", 1))
            if S == 1 and frames * slices * channels == n:
                self._stream_dims(frames, slices, H, W, channels)
                return
            if S > 1 and frames * slices == n and channels in (1, S):
                self._stream_dims(frames, slices, H, W, S)
                return
        if self.dim_order in ("TZYXC", "TZYX", "TYXC", "TYX"):
            # plain page stack: N pages = T (Z folded only via metadata)
            self._stream_dims(n, 1, H, W, S)
            return
        if self.dim_order in ("ZYX", "ZYXC"):
            self._stream_dims(1, n, H, W, S)
            return
        self._initialize_eager()

    def _stream_dims(self, frames, slices, H, W, channels):
        self.frame_count = frames
        self.depth = slices
        self.height = H
        self.width = W
        self.n_channels = channels
        p0 = self._tf.pages[0]
        from flowreg3d_tpu_torch.io._tiff_format import _np_dtype

        self.dtype = _np_dtype(p0.sample_format, p0.bits, "=")

    def _initialize_eager(self):
        """Layouts the (t,z,c)->page mapping cannot express.

        Prefers a zero-copy memmap view over the file (the reference's
        ``use_memmap`` / ``asarray(out="memmap")`` behavior, reference
        util/io/tiff.py:41-55,444-445) so exotic ``dim_order`` files keep
        bounded RSS; the transpose below is a view, and only the frames a
        ``__getitem__``/``read_batch`` touches are ever paged in. Falls
        back to a whole-file decode for compressed/non-uniform layouts.
        """
        pages = self._tf.memmap_pages()
        if pages is None:
            pages = self._tf.asarray()  # (N, H, W[, S])
        arr = pages
        order = self.dim_order
        if "C" not in order:
            if arr.ndim == len(order):
                arr = arr[..., np.newaxis]
                order += "C"
            elif arr.ndim == len(order) + 1:
                order += "C"
            else:
                raise ValueError(
                    f"Array shape {arr.shape} doesn't match dim_order "
                    f"'{self.dim_order}'")
        elif arr.ndim == len(order) - 1:
            arr = np.expand_dims(arr, axis=order.index("C"))
        while arr.ndim < len(order):
            arr = arr[np.newaxis]
        if arr.ndim != len(order):
            raise ValueError(
                f"Dimension mismatch: array {arr.shape} vs order '{order}'")
        perm = [order.index(d) for d in "TZYXC"]
        self._data = np.transpose(arr, perm)
        (self.frame_count, self.depth, self.height, self.width,
         self.n_channels) = self._data.shape
        self.dtype = self._data.dtype

    def _read_raw_frames(self, frame_indices):
        t0 = perf_counter()
        with span("flowreg3d.decode"):
            out = self._decode(frame_indices)
        _tally("decode", out, t0)
        return out

    def _decode(self, frame_indices):
        if self._data is not None:
            out = self._data[frame_indices]
            # always a FRESH array: slice views would be read-only for
            # memmap-backed _data (callers mutate batches in place) and
            # would alias the cached volume otherwise
            return np.array(out, dtype=out.dtype.newbyteorder("="),
                            order="C")
        if isinstance(frame_indices, slice):
            ts = range(*frame_indices.indices(self.frame_count))
        else:
            ts = list(frame_indices)
        Z, Y, X, C = (self.depth, self.height, self.width, self.n_channels)
        out = np.empty((len(ts), Z, Y, X, C), self.dtype)
        S = self._samples
        for k, t in enumerate(ts):
            for z in range(Z):
                if S > 1:
                    # interleaved channels live in the page's sample axis
                    out[k, z] = self._tf.page_array(t * Z + z)
                else:
                    for c in range(C):
                        out[k, z, :, :, c] = self._tf.page_array(
                            (t * Z + z) * C + c)
        return out

    def close(self):
        self._data = None
        if self._tf is not None:
            self._tf.close()
            self._tf = None


class TIFFFileWriter3D(VideoWriter3D):
    """Streams (T,Z,Y,X,C) volumes as an ImageJ hyperstack TIFF."""

    def __init__(self, file_path, dim_order="TZYXC", compression=None,
                 bigtiff=True, imagej=True, expected_frames=None, ome=False,
                 metadata=None, compression_level=6):
        super().__init__()
        if compression not in (None, "none"):
            raise NotImplementedError(
                "built-in TIFF codec writes uncompressed data only")
        self.file_path = str(file_path)
        self.bigtiff = bigtiff
        self.imagej = imagej
        self.expected_frames = expected_frames
        self.frames_written = 0
        self._writer = None
        d = os.path.dirname(os.path.abspath(self.file_path))
        os.makedirs(d, exist_ok=True)

    def write_frames(self, frames):
        t0 = perf_counter()
        with span("flowreg3d.encode"):
            frames = self._encode(frames)
        _tally("encode", frames, t0)

    def _encode(self, frames):
        """Append the pages of (T,Z,Y,X,C) or (Z,Y,X,C) ``frames``; returns
        them as a batch."""
        frames = self._as_batch(np.asarray(frames))
        if frames.ndim != 5:
            raise ValueError(f"Expected 4D or 5D array, got {frames.ndim}D")
        if not self.initialized:
            self.init(frames)
            if os.path.exists(self.file_path):
                os.remove(self.file_path)
            self._writer = TiffWriter(self.file_path, bigtiff=self.bigtiff
                                      if self.bigtiff else None)
        T, Z, Y, X, C = frames.shape
        for t in range(T):
            for z in range(Z):
                for c in range(C):
                    self._writer.write_page(frames[t, z, :, :, c])
        self.frames_written += T
        return frames

    def close(self):
        if self._writer is not None:
            if self.imagej:
                frames = self.expected_frames or self.frames_written
                self._writer.set_description(build_imagej_description(
                    n_images=frames * self.depth * self.n_channels,
                    channels=self.n_channels, slices=self.depth,
                    frames=frames))
            self._writer.close()
            self._writer = None
