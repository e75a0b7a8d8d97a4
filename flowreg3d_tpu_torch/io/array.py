"""In-memory array reader/writer (parity: reference util/io/_arr_3d.py).

These are the adapters that let ``compensate_arr`` reuse the streaming file
pipeline unchanged.
"""

import numpy as np

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


class ArrayWriter3D(VideoWriter3D):
    """Accumulates written volumes; ``get_array()`` concatenates them."""

    def __init__(self):
        super().__init__()
        self._chunks = []

    def write_frames(self, frames):
        frames = self._as_batch(frames)
        if frames.ndim != 5:
            raise ValueError(f"Expected 4D or 5D array, got {frames.ndim}D")
        if not self.initialized:
            self.init(frames)
        self._chunks.append(np.asarray(frames))

    def get_array(self):
        if not self._chunks:
            return None
        return np.concatenate(self._chunks, axis=0)

    def close(self):
        pass
