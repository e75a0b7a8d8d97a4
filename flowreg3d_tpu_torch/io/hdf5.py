"""HDF5 volumetric reader/writer with MATLAB-compatible layout.

Parity target: reference util/io/hdf5_3d.py — reader with dataset
auto-discovery (multi-dataset = channels) and contiguous-slice optimization;
writer storing one expandable 4D dataset per channel (``ch1``, ``ch2``, …)
with configurable ``dimension_ordering`` (default (1,2,3,0): stored (T,Z,Y,X)
so MATLAB reads (Z,Y,X,T) after its dimension reversal), chunked, optional
gzip/lzf compression, and attrs recording ordering + original TZYXC shape.

h5py is imported at first use (``require_h5py``), not with the module: a
host without it imports the io package and reads and writes every other
format; asking it for HDF5 (or MAT v7.3, ``io/mat.py``) raises an
ImportError that names h5py.
"""

import os

import numpy as np

from flowreg3d_tpu_torch.io.base import VideoReader3D, VideoWriter3D
from flowreg3d_tpu_torch.io.ds import (
    dataset_name_for_channel,
    find_datasets,
    sanitize_dataset_names,
)


def require_h5py():
    """The h5py module; an ImportError naming it where it is missing."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "HDF5 and MAT v7.3 files need the h5py package, which is not "
            "installed; write TIFF (output_format='TIFF') or MAT v5 "
            "instead") from e
    return h5py


class HDF5FileReader3D(VideoReader3D):
    """Reads (T,Z,Y,X[,C]) from HDF5; multiple 4D datasets become channels."""

    def __init__(self, file_path, buffer_size=500, bin_size=1, **kwargs):
        super().__init__()
        self.file_path = file_path
        self.buffer_size = buffer_size
        self.bin_size = bin_size
        self.h5file = None
        self.dataset_names = sanitize_dataset_names(kwargs.get("dataset_names"))
        self.dimension_ordering = kwargs.get("dimension_ordering")
        require_h5py()

    def _initialize(self):
        h5py = require_h5py()
        try:
            self.h5file = h5py.File(self.file_path, "r")
        except Exception as e:
            raise IOError(f"Cannot open HDF5 file: {e}")

        if not self.dataset_names:
            info = []

            def visitor(name, obj):
                if isinstance(obj, h5py.Dataset):
                    info.append((name, obj.shape))

            self.h5file.visititems(visitor)
            self.dataset_names = find_datasets(info)
        if not self.dataset_names:
            raise ValueError("No suitable datasets found")
        if isinstance(self.dataset_names, str):
            self.dataset_names = [self.dataset_names]

        first = self.h5file[self.dataset_names[0]]
        shape = first.shape
        if len(shape) == 4:
            self.frame_count, self.depth, self.height, self.width = shape
            self.n_channels = len(self.dataset_names)
        elif len(shape) == 5:
            (self.frame_count, self.depth, self.height, self.width,
             self.n_channels) = shape
        else:
            raise ValueError(f"Expected 4D/5D dataset, got shape {shape}")
        self.dtype = first.dtype

    def _read_raw_frames(self, frame_indices):
        if isinstance(frame_indices, list):
            if not frame_indices:
                return np.empty((0, self.depth, self.height, self.width,
                                 self.n_channels), dtype=self.dtype)
            if len(frame_indices) > 1 and np.all(np.diff(frame_indices) == 1):
                frame_indices = slice(frame_indices[0], frame_indices[-1] + 1)

        if isinstance(frame_indices, slice):
            start, stop, step = frame_indices.indices(self.frame_count)
            n = len(range(start, stop, step))
        else:
            n = len(frame_indices)

        first = self.h5file[self.dataset_names[0]]
        if first.ndim == 5:  # single 5D dataset carries all channels
            return np.asarray(first[frame_indices])
        out = np.zeros((n, self.depth, self.height, self.width, self.n_channels),
                       dtype=self.dtype)
        for c, name in enumerate(self.dataset_names):
            out[..., c] = self.h5file[name][frame_indices]
        return out

    def close(self):
        if self.h5file:
            self.h5file.close()
            self.h5file = None


class HDF5FileWriter3D(VideoWriter3D):
    """Streams (T,Z,Y,X,C) into per-channel expandable 4D datasets."""

    def __init__(self, file_path, **kwargs):
        super().__init__()
        self.file_path = file_path
        self.dataset_names = sanitize_dataset_names(
            kwargs.get("dataset_names")) or "ch*"
        self.dimension_ordering = kwargs.get("dimension_ordering", (1, 2, 3, 0))
        self.compression = kwargs.get("compression")
        self.compression_level = kwargs.get("compression_level", 4)
        self.chunk_temporal = kwargs.get("chunk_size", 1)
        self._h5file = None
        self._datasets = {}
        self._frames_written = 0
        require_h5py()

    def _placed(self, depth, height, width, time):
        """Arrange (depth,height,width,time) values by dimension_ordering."""
        out = [None] * 4
        out[self.dimension_ordering[0]] = depth
        out[self.dimension_ordering[1]] = height
        out[self.dimension_ordering[2]] = width
        out[self.dimension_ordering[3]] = time
        return tuple(out)

    def _create_datasets(self):
        if os.path.exists(self.file_path):
            os.remove(self.file_path)
        self._h5file = require_h5py().File(self.file_path, "w")
        shape0 = self._placed(self.depth, self.height, self.width, 0)
        maxshape = self._placed(self.depth, self.height, self.width, None)
        chunks = self._placed(self.depth, self.height, self.width,
                              self.chunk_temporal)
        comp = {}
        if self.compression == "gzip":
            comp = dict(compression="gzip", compression_opts=self.compression_level)
        elif self.compression:
            comp = dict(compression=self.compression)
        for c in range(self.n_channels):
            name = dataset_name_for_channel(self.dataset_names, c + 1,
                                            self.n_channels)
            ds = self._h5file.create_dataset(
                name, shape=shape0, maxshape=maxshape, dtype=self.dtype,
                chunks=chunks, **comp)
            ds.attrs["dimension_ordering"] = self.dimension_ordering
            ds.attrs["original_shape_TZYXC"] = (
                0, self.depth, self.height, self.width, self.n_channels)
            self._datasets[name] = ds

    @staticmethod
    def _normalize_frames(frames, depth, height, width):
        if frames.ndim == 3:
            return frames[np.newaxis, ..., np.newaxis]
        if frames.ndim == 4:
            if (frames.shape[0] == depth and frames.shape[1] == height
                    and frames.shape[2] == width):
                return frames[np.newaxis]
            return frames[..., np.newaxis]
        if frames.ndim == 5:
            return frames
        raise ValueError(f"Expected 3D, 4D or 5D input, got {frames.ndim}D")

    def write_frames(self, frames):
        frames = self._normalize_frames(np.asarray(frames), self.depth,
                                        self.height, self.width)
        if not self.initialized:
            self.init(frames)
            self._create_datasets()

        T, Z, Y, X, C = frames.shape
        if (Z, Y, X) != (self.depth, self.height, self.width):
            raise ValueError(
                f"Volume size mismatch: expected "
                f"({self.depth},{self.height},{self.width}), got ({Z},{Y},{X})")
        if C != self.n_channels:
            raise ValueError(
                f"Channel count mismatch: expected {self.n_channels}, got {C}")

        # permutation taking (T,Z,Y,X) axes into storage order
        perm = self._placed(1, 2, 3, 0)
        t_axis = self.dimension_ordering[3]
        start = self._frames_written
        stop = start + T
        for c in range(self.n_channels):
            name = dataset_name_for_channel(self.dataset_names, c + 1,
                                            self.n_channels)
            ds = self._datasets[name]
            data = np.transpose(frames[..., c], perm)
            new_shape = list(ds.shape)
            new_shape[t_axis] = stop
            ds.resize(new_shape)
            sel = [slice(None)] * 4
            sel[t_axis] = slice(start, stop)
            ds[tuple(sel)] = data
            ds.attrs["original_shape_TZYXC"] = (
                stop, Z, Y, X, self.n_channels)
        self._frames_written = stop
        self._h5file.flush()

    def close(self):
        if self._h5file:
            if self._datasets:
                a = self._h5file.attrs
                a["n_channels"] = self.n_channels
                a["frame_count"] = self._frames_written
                a["depth"] = self.depth
                a["height"] = self.height
                a["width"] = self.width
                a["dimension_ordering"] = self.dimension_ordering
                a["format"] = "flowreg3d_hdf5_v1"
                a["dataset_names"] = list(self._datasets.keys())
            self._h5file.close()
            self._h5file = None
            self._datasets = {}
