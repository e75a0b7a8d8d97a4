"""In-memory array reader/writer (parity: reference util/io/_arr_3d.py).

These are the adapters that let ``compensate_arr`` reuse the streaming file
pipeline unchanged. The writer copies with torch's multithreaded CPU
``copy_``: one numpy pass over a recording's outputs runs on one core. Told
its frame count, it also hands out views of its next frames, so that a
batch's download lands in the returned array with no copy in between
(``frames_view`` / ``commit_frames``); ``write_totals()`` counts the frames
each way took over the process.

A fresh page costs its first write most of what a copy into it costs (the
kernel zeroes and maps it), so a counted writer's array is faulted ahead of
its copies: one background thread writes a zero into every page of each
such array, in frame order, while the caller waits on the device, and
every copy into a writer's frames claims them first (``claim_frames``),
after which the thread leaves them alone.
"""

import mmap
import threading

import numpy as np
import torch

from flowreg3d_tpu_torch._trace import span
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
# arrays ("landed"), batches ``write_frames`` copied in ("copied"), and the
# frames of either whose every page was faulted before their copy began
# ("prefaulted")
_TOTALS = {"landed": 0, "copied": 0, "prefaulted": 0}


def write_totals():
    """{'landed': frames, 'copied': frames, 'prefaulted': frames} of every
    ``ArrayWriter3D`` of the process: frames committed after their download
    landed in a writer's view, frames ``write_frames`` copied in, and the
    frames of either that the toucher had faulted whole when they were
    claimed."""
    return dict(_TOTALS)


# the toucher faults an array in chunks of at most this many bytes and one
# frame, and looks at the claims between two; an array of one chunk or less
# is faulted by its copy, a thread would cost more than it saves
_CHUNK = 32 << 20
_PAGE = mmap.PAGESIZE
TOUCHER_NAME = "ArrayWriter3D.prefault"


def _touch(chunk):
    """A zero written into every page that ``chunk`` (flat uint8) spans; the
    strided fill runs without the GIL."""
    chunk[:1] = 0
    chunk[(-chunk.ctypes.data) % _PAGE::_PAGE] = 0


class _Toucher:
    """The one thread that faults the counted writers' arrays ahead of
    their copies.

    It walks each writer's frames in order, a chunk at a time, and of all
    its writers always the one whose next frame comes first, so frame k of
    every writer is faulted before frame k + 1 of any. Frames claimed
    before it reaches them are skipped, and it never starts a chunk of a
    claimed frame; a claim waits only for the chunk being touched. The
    thread ends when no writer has frames left, or when the last one is
    closed.
    """

    def __init__(self):
        self.cond = threading.Condition()
        self.writers = []       # writers with frames left, in their order
        self.busy = None        # the writer a chunk is being touched of
        self.thread = None

    def start(self, writer):
        with self.cond:
            self.writers.append(writer)
            if self.thread is None:
                self.thread = threading.Thread(target=self._run,
                                               name=TOUCHER_NAME, daemon=True)
                self.thread.start()

    def _next_chunk(self):
        """The writer and flat uint8 chunk to touch next, or None; under
        the lock."""
        for w in self.writers:
            if w._touch_at < w._claimed:    # claimed before it was reached
                w._touch_at, w._touch_off = w._claimed, 0
        self.writers = [w for w in self.writers
                        if w._touch_at < w.frame_count]
        if not self.writers:
            return None
        w = min(self.writers, key=lambda w: w._touch_at)
        frame = w._array[w._touch_at].reshape(-1).view(np.uint8)
        return w, frame[w._touch_off:w._touch_off + _CHUNK]

    def _advance(self, w, nbytes):
        w._touch_off += nbytes
        if w._touch_off == w._array[0].nbytes:
            w._touch_at, w._touch_off = w._touch_at + 1, 0

    def _run(self):
        me = threading.current_thread()
        with self.cond:
            try:
                while self.thread is me:
                    nxt = self._next_chunk()
                    if nxt is None:
                        break
                    w, chunk = nxt
                    self.busy = w
                    self.cond.release()
                    try:
                        _touch(chunk)
                    finally:
                        self.cond.acquire()
                        self.busy = None
                        self.cond.notify_all()
                    self._advance(w, chunk.size)
            finally:
                if self.thread is me:
                    self.thread = None

    def _touching_claimed(self):
        w = self.busy
        return w is not None and w._touch_at < w._claimed

    def claim(self, claims):
        with self.cond:
            for w, n in claims:
                start = max(w.frames_in_place, w._claimed)
                stop = w.frames_in_place + n
                if stop <= start:
                    continue
                whole = min(stop, w._touch_at) - start
                if whole > 0:
                    _TOTALS["prefaulted"] += whole
                w._claimed = stop
            self.cond.wait_for(lambda: not self._touching_claimed())

    def stop(self, writer):
        """``writer`` left alone from here; the thread ended where it was
        the last writer."""
        with self.cond:
            if writer in self.writers:
                self.writers.remove(writer)
            self.cond.wait_for(lambda: self.busy is not writer)
            thread = None
            if not self.writers:
                thread, self.thread = self.thread, None
        if thread is not None:
            thread.join()


_TOUCHER = _Toucher()


def claim_frames(claims):
    """Claim frames about to be copied into: each (writer, n) of ``claims``
    names an ``ArrayWriter3D``'s next ``n`` frames. The toucher leaves them
    alone from here; returns once it writes into none of them (waiting at
    most for the chunk it is touching). Every copy into a counted writer's
    frames claims them first: ``write_frames`` does itself, the filler of a
    ``frames_view`` calls this."""
    _TOUCHER.claim(claims)


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
    frames by a plain ``copy_``, after ``claim_frames``, and
    ``commit_frames(n)`` takes them as written; ``frames_landed`` counts the
    frames that came in this way.

    An array of more than one chunk is faulted by the toucher from its
    allocation on, until every frame is faulted or claimed or the writer is
    closed.
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
        self._claimed = 0       # frames [0, _claimed) are a copy's
        self._touch_at = 0      # the toucher's frame and byte in it
        self._touch_off = 0

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
        with span("flowreg3d.prefault_wait"):
            claim_frames([(self, len(frames))])
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
            if self._array.nbytes > _CHUNK:
                _TOUCHER.start(self)
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
        _TOUCHER.stop(self)
