"""Streaming reader/writer protocol for volumetric time series.

Behavioral parity target: reference util/io/_base_3d.py — canonical layout
(T, Z, Y, X, C); streaming ``read_batch``/``has_batch``/``reset``; rich
``__getitem__`` (int/slice/list/tuple) where, with ``bin_size > 1``, indices
address *binned* frames and each bin is the average of ``bin_size`` raw
frames (:84-228); ``shape``/``unbinned_shape``; iterator + context manager.
"""

from abc import ABC, abstractmethod

import numpy as np


class VideoReader3D(ABC):
    """Streaming volumetric reader. Subclasses set depth/height/width/
    frame_count/n_channels/dtype in ``_initialize`` and implement
    ``_read_raw_frames(slice_or_list) -> (T,Z,Y,X,C)``."""

    def __init__(self):
        self.depth = 0
        self.height = 0
        self.width = 0
        self.frame_count = 0
        self.n_channels = 0
        self.dtype = None
        self.buffer_size = 10
        self.bin_size = 1
        self.current_frame = 0
        self._initialized = False

    # -- subclass interface -------------------------------------------------

    @abstractmethod
    def _initialize(self):
        """Set depth/height/width/frame_count/n_channels/dtype."""

    @abstractmethod
    def _read_raw_frames(self, frame_indices):
        """Read raw (unbinned) volumes; returns (T, Z, Y, X, C)."""

    @abstractmethod
    def close(self):
        """Release file handles."""

    # -- binning ------------------------------------------------------------

    def _ensure_initialized(self):
        if not self._initialized:
            self._initialize()
            self._initialized = True

    @property
    def binned_count(self):
        self._ensure_initialized()
        return (self.frame_count + self.bin_size - 1) // self.bin_size

    def bin_frames(self, frames):
        """Average every ``bin_size`` consecutive frames (edge-padded tail)."""
        if self.bin_size == 1:
            return frames
        if frames.ndim != 5:
            raise ValueError(f"Expected 5D (T,Z,Y,X,C), got {frames.ndim}D")
        dtype = frames.dtype
        T = frames.shape[0]
        pad = (-T) % self.bin_size
        if pad:
            frames = np.concatenate(
                [frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)
        T = frames.shape[0]
        binned = frames.reshape((T // self.bin_size, self.bin_size)
                                + frames.shape[1:]).mean(axis=1)
        return binned.astype(dtype)

    def _read_bin(self, bin_idx):
        """One binned frame (Z,Y,X,C): mean of the bin's raw frames."""
        start = bin_idx * self.bin_size
        stop = min(start + self.bin_size, self.frame_count)
        raw = self._read_raw_frames(slice(start, stop))
        return raw.mean(axis=0).astype(raw.dtype)

    # -- indexing -----------------------------------------------------------

    def __getitem__(self, key):
        self._ensure_initialized()
        n = self.binned_count

        if isinstance(key, (int, np.integer)):
            idx = int(key) + n if key < 0 else int(key)
            if not 0 <= idx < n:
                raise IndexError(f"Index {key} out of range for {n} binned frames")
            return self._read_bin(idx)

        if isinstance(key, slice):
            start, stop, step = key.indices(n)
            idxs = range(start, stop, step)
            if len(idxs) == 0:
                return np.empty((0, self.depth, self.height, self.width,
                                 self.n_channels), dtype=self.dtype)
            return np.stack([self._read_bin(i) for i in idxs], axis=0)

        if isinstance(key, (list, np.ndarray)):
            idxs = np.asarray(key, dtype=np.int64)
            idxs = np.where(idxs < 0, n + idxs, idxs)
            if np.any((idxs < 0) | (idxs >= n)):
                raise IndexError(f"Index out of range for {n} binned frames")
            return np.stack([self._read_bin(int(i)) for i in idxs], axis=0)

        if isinstance(key, tuple):
            frame_key, *rest = key
            if isinstance(frame_key, (int, np.integer)):
                frames = self[frame_key][np.newaxis]
            else:
                frames = self[frame_key]
            if rest:
                sel = ((slice(None),) + tuple(rest)) if frames.ndim == 5 \
                    else tuple(rest)
                frames = frames[sel]
            return frames

        raise TypeError(f"Invalid index type: {type(key)}")

    # -- streaming ----------------------------------------------------------

    def read_batch(self):
        """Next batch of ``buffer_size`` binned frames, or None when done."""
        self._ensure_initialized()
        if not self.has_batch():
            return None
        stop = min(self.current_frame + self.buffer_size * self.bin_size,
                   self.frame_count)
        raw = self._read_raw_frames(slice(self.current_frame, stop))
        self.current_frame = stop
        return self.bin_frames(raw)

    def has_batch(self):
        # must self-initialize: on a fresh reader frame_count is still 0
        # and an uninitialized has_batch() would falsely end the stream
        self._ensure_initialized()
        return self.current_frame < self.frame_count

    def reset(self):
        self.current_frame = 0

    def seek_frame(self, binned_frame):
        """Position the stream so ``read_batch`` resumes at the given BINNED
        frame index without decoding the skipped range (checkpoint resume)."""
        self._ensure_initialized()
        raw = int(binned_frame) * self.bin_size
        if not 0 <= raw <= self.frame_count:
            raise ValueError(
                f"seek to binned frame {binned_frame} outside stream")
        self.current_frame = raw

    def __len__(self):
        return self.binned_count

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self.has_batch():
            raise StopIteration
        return self.read_batch()

    @property
    def shape(self):
        self._ensure_initialized()
        return (len(self), self.depth, self.height, self.width, self.n_channels)

    @property
    def unbinned_shape(self):
        self._ensure_initialized()
        return (self.frame_count, self.depth, self.height, self.width,
                self.n_channels)

    def __repr__(self):
        self._ensure_initialized()
        return (f"{type(self).__name__}(shape={self.shape}, dtype={self.dtype}, "
                f"bin_size={self.bin_size})")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()


class VideoWriter3D(ABC):
    """Streaming volumetric writer: ``init`` from the first batch, then
    ``write_frames`` repeatedly, then ``close``."""

    def __init__(self):
        self.initialized = False
        self.depth = 0
        self.height = 0
        self.width = 0
        self.n_channels = 0
        self.bit_depth = 0
        self.dtype = None

    def init(self, first_frame_batch):
        shape = first_frame_batch.shape
        if first_frame_batch.ndim == 4:
            shape = (1,) + shape
        if len(shape) != 5:
            raise ValueError(
                f"Expected 4D or 5D array, got {first_frame_batch.ndim}D")
        _, self.depth, self.height, self.width, self.n_channels = shape
        self.dtype = first_frame_batch.dtype
        self.bit_depth = self.dtype.itemsize * 8
        self.initialized = True

    @staticmethod
    def _as_batch(frames):
        """Normalize (Z,Y,X,C) -> (1,Z,Y,X,C)."""
        frames = np.asarray(frames)
        return frames[np.newaxis] if frames.ndim == 4 else frames

    @abstractmethod
    def write_frames(self, frames):
        """Append (T,Z,Y,X,C) or (Z,Y,X,C) volumes."""

    @abstractmethod
    def close(self):
        """Finalize the file."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
