"""Background-thread batch prefetching for streaming readers.

SURVEY.md §7 flags host/device streaming overlap as a throughput
requirement: while the device registers batch N, the host should already be
reading and binning batch N+1. ``PrefetchReader3D`` wraps any VideoReader3D
and keeps up to ``prefetch_depth`` decoded batches in a bounded queue filled
by a daemon thread. The streaming interface (``read_batch``/``has_batch``/
``reset``) is preserved; random access (``__getitem__``) passes through to
the wrapped reader (lock-guarded — HDF5 handles are not thread-safe).
"""

import queue
import threading

from flowreg3d_tpu_torch.io.base import VideoReader3D

_SENTINEL = object()


class PrefetchReader3D(VideoReader3D):
    """Wraps a reader with an N-deep background prefetch queue."""

    def __init__(self, reader, prefetch_depth=2):
        super().__init__()
        self.reader = reader
        self.prefetch_depth = max(1, int(prefetch_depth))
        self._queue = None
        self._thread = None
        self._lock = threading.Lock()
        self._exhausted = False
        self._error = None

    def _initialize(self):
        self.reader._ensure_initialized()
        self.frame_count = self.reader.frame_count
        self.depth = self.reader.depth
        self.height = self.reader.height
        self.width = self.reader.width
        self.n_channels = self.reader.n_channels
        self.dtype = self.reader.dtype
        self.buffer_size = self.reader.buffer_size
        self.bin_size = self.reader.bin_size

    # -- prefetch machinery ---------------------------------------------

    def _worker(self, q):
        try:
            while True:
                with self._lock:
                    if self._queue is not q:  # stale worker after reset()
                        return
                    batch = self.reader.read_batch()
                if batch is None:
                    q.put(_SENTINEL)
                    return
                q.put(batch)
        except Exception as e:  # surfaced on the consumer side
            self._error = e
            q.put(_SENTINEL)

    def _ensure_thread(self):
        # the QUEUE is the stream state: a finished worker leaves buffered
        # batches + sentinel behind, which must still be drained — only a
        # missing queue (fresh stream or post-reset) starts a new epoch
        if self._queue is None:
            self._queue = queue.Queue(maxsize=self.prefetch_depth)
            self._thread = threading.Thread(
                target=self._worker, args=(self._queue,), daemon=True)
            self._thread.start()

    # -- streaming interface --------------------------------------------

    def read_batch(self):
        self._ensure_initialized()
        if not self.has_batch():
            return None
        self._ensure_thread()
        item = self._queue.get()
        if item is _SENTINEL:
            self._exhausted = True
            if self._error:
                raise self._error
            return None
        self.current_frame = min(
            self.current_frame + item.shape[0] * self.bin_size,
            self.frame_count)
        return item

    def has_batch(self):
        self._ensure_initialized()
        if self._exhausted:
            return False
        return self.current_frame < self.frame_count

    def reset(self):
        # invalidate the queue under the lock FIRST so an in-flight worker
        # exits before it can advance the freshly-reset reader
        with self._lock:
            self._queue = None
            self.reader.reset()
        self._thread = None
        self.current_frame = 0
        self._exhausted = False
        self._error = None

    def seek_frame(self, binned_frame):
        self._ensure_initialized()
        if self._queue is not None:
            raise RuntimeError("cannot seek after streaming has started")
        with self._lock:
            self.reader.seek_frame(binned_frame)
        self.current_frame = self.reader.current_frame

    def _read_raw_frames(self, frame_indices):
        with self._lock:
            return self.reader._read_raw_frames(frame_indices)

    def close(self):
        q, self._queue = self._queue, None
        self._thread = None
        with self._lock:
            self.reader.close()
        # a worker blocked on a full queue gets its slot, then sees that it
        # is stale and ends
        while q is not None:
            try:
                q.get_nowait()
            except queue.Empty:
                q = None
