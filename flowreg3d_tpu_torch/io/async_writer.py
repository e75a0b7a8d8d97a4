"""Background-thread writer: device results queue to disk off the hot path.

Mirror of io/prefetch.py on the output side — ``write_frames`` enqueues and
returns immediately; a daemon thread drains the bounded queue into the
wrapped writer, so HDF5/TIFF encoding overlaps the next batch's device
compute. ``close()`` flushes the queue and re-raises any writer error.
"""

import queue
import threading

from flowreg3d_tpu_torch.io.base import VideoWriter3D

_SENTINEL = object()


class AsyncWriter3D(VideoWriter3D):
    """Wraps a writer with an N-deep background write queue."""

    def __init__(self, writer, queue_depth=2):
        super().__init__()
        self.writer = writer
        self._queue = queue.Queue(maxsize=max(1, int(queue_depth)))
        self._error = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._queue.get()
            try:
                if item is _SENTINEL:
                    return
                if self._error is None:  # drain without writing post-failure
                    try:
                        self.writer.write_frames(item)
                    except Exception as e:
                        self._error = e
            finally:
                self._queue.task_done()

    def write_frames(self, frames):
        if self._error is not None:
            raise self._error
        frames = self._as_batch(frames)
        if not self.initialized:
            self.init(frames)
        self._queue.put(frames)

    def get_array(self):
        """Passthrough for ARRAY-backed writers (after flush)."""
        self.flush()
        return self.writer.get_array()

    def flush(self):
        self._queue.join()

    def close(self):
        self._queue.put(_SENTINEL)
        self._thread.join(timeout=300)
        self.writer.close()
        if self._error is not None:
            raise self._error
