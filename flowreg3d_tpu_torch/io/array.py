"""In-memory array reader/writer (parity: reference util/io/_arr_3d.py).

These are the adapters that let ``compensate_arr`` reuse the streaming file
pipeline unchanged. The writer copies with torch's multithreaded CPU
``copy_``: one numpy pass over a recording's outputs runs on one core. Told
its frame count, it also hands out views of its next frames, so that a
batch's download lands in the returned array with no copy in between
(``frames_view`` / ``commit_frames``); ``write_totals()`` counts the frames
each way took over the process.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch.io.base import VideoReader3D, VideoWriter3D


def normalize_to_5d(array):
    """(Z,Y,X) -> (1,Z,Y,X,1); (Z,Y,X,C) -> (1,Z,Y,X,C); 5D passthrough."""
    if array.ndim == 3:
        return array[np.newaxis, ..., np.newaxis]
    if array.ndim == 4:
        return array[np.newaxis]
    if array.ndim == 5:
        return array
    raise ValueError(f"Array must be 3D, 4D or 5D, got shape {array.shape}")


class ArrayReader3D(VideoReader3D):
    """Treats a numpy array (3D/4D/5D) as a volumetric video source."""

    def __init__(self, array, buffer_size=10, bin_size=1):
        super().__init__()
        self.array = normalize_to_5d(np.asarray(array))
        self.buffer_size = buffer_size
        self.bin_size = bin_size
        (self.frame_count, self.depth, self.height, self.width,
         self.n_channels) = self.array.shape
        self.dtype = self.array.dtype
        self._initialized = True

    def _initialize(self):
        pass

    def _read_raw_frames(self, frame_indices):
        return self.array[frame_indices].copy()

    def close(self):
        pass


def cast_frames(frames, dtype):
    """``frames`` as ``dtype`` (no copy where it already is): integer types
    rounded half to even and clipped to their range."""
    if frames.dtype == dtype:
        return frames
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(frames), info.min, info.max).astype(dtype)
    return frames.astype(dtype)


# float outputs a plain torch ``copy_`` casts to as ``astype`` does
_COPY_FLOATS = (np.dtype(np.float16), np.dtype(np.float32),
                np.dtype(np.float64))

# frames ArrayWriter3D took over the process: downloads that landed in its
# arrays ("landed") and batches ``write_frames`` copied in ("copied")
_TOTALS = {"landed": 0, "copied": 0}


def write_totals():
    """{'landed': frames, 'copied': frames} of every ``ArrayWriter3D`` of
    the process: frames committed after their download landed in a writer's
    view, and frames ``write_frames`` copied in."""
    return dict(_TOTALS)


def _copy_into(dst, src):
    """``dst[...] = src`` cast as ``astype`` casts, by torch's multithreaded
    CPU copy where torch holds both dtypes."""
    try:
        dst_t, src_t = torch.from_numpy(dst), torch.from_numpy(src)
    except (TypeError, ValueError):     # a dtype or byte order torch lacks
        np.copyto(dst, src, casting="unsafe")
        return
    dst_t.copy_(src_t)


class ArrayWriter3D(VideoWriter3D):
    """Collects written volumes into one array that ``get_array()`` returns.

    Told ``frame_count``, the writer allocates the whole (frame_count, Z, Y,
    X, C) array at the first batch and copies each batch into its next
    frames, cast to ``dtype`` on the way as ``cast_frames`` casts; a batch
    beyond ``frame_count`` raises, and ``get_array`` returns the frames
    written without a copy. Without a count it keeps the batches and
    ``get_array`` concatenates them, then casts. ``frames_in_place`` and
    ``frames_appended`` count the frames each way took.

    Told a count, ``frames_view(n, frame_shape, src_dtype)`` also hands out
    the array's next ``n`` frames for the caller to fill from ``src_dtype``
    frames by a plain ``copy_``, and ``commit_frames(n)`` takes them as
    written; ``frames_landed`` counts the frames that came in this way.
    """

    def __init__(self, frame_count=None, dtype=None):
        super().__init__()
        self.frame_count = frame_count
        self.out_dtype = None if dtype is None else np.dtype(dtype)
        self.frames_in_place = 0
        self.frames_appended = 0
        self.frames_landed = 0
        self._chunks = []
        self._array = None

    def write_frames(self, frames):
        frames = self._as_batch(frames)
        if frames.ndim != 5:
            raise ValueError(f"Expected 4D or 5D array, got {frames.ndim}D")
        if not self.initialized:
            self.init(frames)
        _TOTALS["copied"] += frames.shape[0]
        if self.frame_count is None:
            self._chunks.append(frames)
            self.frames_appended += frames.shape[0]
            return
        out = self._next(len(frames), frames.shape[1:], frames.dtype)
        if np.issubdtype(out.dtype, np.integer):
            frames = cast_frames(frames, out.dtype)
        _copy_into(out, frames)
        self.frames_in_place += len(frames)

    def _next(self, n, frame_shape, src_dtype):
        """The array's next ``n`` frames, the array allocated at the first
        call; raises past ``frame_count`` or for another frame shape."""
        start, stop = self.frames_in_place, self.frames_in_place + n
        if stop > self.frame_count:
            raise ValueError(f"ArrayWriter3D was told {self.frame_count} "
                             f"frames and got {stop}")
        if self._array is None:
            dtype = src_dtype if self.out_dtype is None else self.out_dtype
            self._array = np.empty((self.frame_count,) + tuple(frame_shape),
                                   dtype)
        out = self._array[start:stop]
        if (n,) + tuple(frame_shape) != out.shape:  # a copy would broadcast
            raise ValueError(f"Expected volumes of {out.shape[1:]}, got "
                             f"{tuple(frame_shape)}")
        return out

    def frames_view(self, n, frame_shape, src_dtype):
        """A writable view of the next ``n`` frames of ``frame_shape``
        (Z,Y,X,C), for frames of ``src_dtype`` copied in by a plain
        ``copy_``; None where that copy would not give ``write_frames``'
        values (an integer output from another dtype needs its rounding and
        clipping) or where the writer was told no count."""
        src_dtype = np.dtype(src_dtype)
        if self.frame_count is None:
            return None
        out_dtype = src_dtype if self.out_dtype is None else self.out_dtype
        if out_dtype != src_dtype and out_dtype not in _COPY_FLOATS:
            return None
        if not self.initialized:
            self.init(np.empty((0,) + tuple(frame_shape), src_dtype))
        return self._next(n, frame_shape, src_dtype)

    def commit_frames(self, n):
        """The ``n`` frames of the last ``frames_view`` are written."""
        if self.frames_in_place + n > self.frame_count:
            raise ValueError(f"ArrayWriter3D was told {self.frame_count} "
                             f"frames and got {self.frames_in_place + n}")
        self.frames_in_place += n
        self.frames_landed += n
        _TOTALS["landed"] += n

    def get_array(self):
        if self._array is not None:
            return self._array[:self.frames_in_place]
        if not self._chunks:
            return None
        out = np.concatenate(self._chunks, axis=0)
        if self.out_dtype is not None:
            out = cast_frames(out, self.out_dtype)
        return out

    def close(self):
        pass
