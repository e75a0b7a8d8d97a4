"""MATLAB .mat reader/writer: v5/v7 via scipy.io, v7.3 via h5py.

Parity target: reference util/io/mat_3d.py — reader sniffs the 116-byte text
header for ``MATLAB 7.3`` and reads via h5py (v7.3 is HDF5), otherwise uses
scipy.io.loadmat; known variable patterns (``ch*_reg``, ``ch*``, ``mov``,
``data``, …) then the generic discovery heuristics; writer buffers per-channel
arrays and writes once at close in MATLAB dimension ordering.

The reference v7.3 writer depends on hdf5storage; this build writes the v7.3
container directly: an HDF5 file with a 512-byte MATLAB userblock header and
per-variable ``MATLAB_class`` attributes (arrays stored in reversed dimension
order, as MATLAB expects). v7.3 needs h5py, imported at first use: without
it, a v7.3 reader or writer raises an ImportError that names h5py when it is
made (v5 needs scipy only).
"""

import os
import struct
import time

import numpy as np

from flowreg3d_tpu_torch.io.base import VideoReader3D, VideoWriter3D
from flowreg3d_tpu_torch.io.ds import dataset_name_for_channel, find_datasets
from flowreg3d_tpu_torch.io.hdf5 import require_h5py

_MATLAB_CLASSES = {
    "f8": "double", "f4": "single",
    "u1": "uint8", "u2": "uint16", "u4": "uint32", "u8": "uint64",
    "i1": "int8", "i2": "int16", "i4": "int32", "i8": "int64",
}


def is_mat73(file_path):
    with open(file_path, "rb") as f:
        header = f.read(128)
    return b"MATLAB 7.3 MAT-file" in header[:116]


def _write_mat73_userblock(file_path):
    """Stamp the 512-byte MATLAB v7.3 userblock onto an HDF5 file."""
    text = (f"MATLAB 7.3 MAT-file, Platform: posix, Created on: "
            f"{time.strftime('%a %b %d %H:%M:%S %Y')} "
            f"HDF5 schema 1.00 .").encode("ascii")[:116]
    block = text.ljust(116, b" ") + b"\x00" * 8 + struct.pack("<H", 0x0200) + b"IM"
    block = block.ljust(512, b"\x00")
    with open(file_path, "r+b") as f:
        f.write(block)


class MATFileReader3D(VideoReader3D):
    """Reads (T,Z,Y,X[,C]) volumetric series from v5/v7/v7.3 MAT files."""

    _KNOWN_PATTERNS = ("ch*_reg", "ch*", "buffer*", "mov", "data")

    def __init__(self, file_path, buffer_size=500, bin_size=1, **kwargs):
        super().__init__()
        self.file_path = str(file_path)
        self.buffer_size = buffer_size
        self.bin_size = bin_size
        self.dataset_names = kwargs.get("dataset_names")
        # positions of logical (Z, Y, X, T) in the STORED array (reference
        # mat_3d.py:38-40,225-247 semantics, normalized to a 4-tuple).
        # v7.3 default (3,2,1,0): a genuine MATLAB (Z,Y,X,T) variable is
        # seen reversed by h5py as (T,X,Y,Z); our own writer records the
        # actual ordering in a 'dimension_ordering' attribute which takes
        # precedence over this default. v5 default (0,1,2,3): scipy returns
        # MATLAB's (Z,Y,X,T) directly.
        self.dimension_ordering = kwargs.get("dimension_ordering")
        self._h5 = None
        self._arrays = None  # list of (T,Z,Y,X) numpy arrays, one per channel
        self._is73 = None
        if os.path.isfile(self.file_path) and is_mat73(self.file_path):
            require_h5py()

    def _discover(self, names_shapes):
        import re
        names = [n for n, _ in names_shapes]
        for pattern in self._KNOWN_PATTERNS:
            regex = re.compile("^" + pattern.replace("*", r"(\d+)") + "$",
                               re.IGNORECASE)
            matched = sorted(
                (int(m.group(1)) if m.groups() else 0, n)
                for n in names if (m := regex.match(n)))
            if matched:
                return [n for _, n in matched]
        return find_datasets(names_shapes)

    def _initialize(self):
        self._is73 = is_mat73(self.file_path)
        if self._is73:
            h5py = require_h5py()

            self._h5 = h5py.File(self.file_path, "r")
            info = []

            def visitor(name, obj):
                if isinstance(obj, h5py.Dataset) and obj.ndim >= 3:
                    info.append((name, obj.shape))

            self._h5.visititems(visitor)
            if not self.dataset_names:
                self.dataset_names = self._discover(info)
            if not self.dataset_names:
                raise ValueError("No suitable datasets found in MAT v7.3 file")
            ds = self._h5[self.dataset_names[0]]
            shape = ds.shape
            if self.dimension_ordering is None:
                attr = ds.attrs.get("dimension_ordering")
                if attr is not None:
                    self.dimension_ordering = tuple(int(a) for a in attr)
                elif len(shape) == 4:
                    self.dimension_ordering = (3, 2, 1, 0)
                else:
                    self.dimension_ordering = (2, 1, 0)
            do = tuple(self.dimension_ordering)
            if len(shape) == 4:
                if len(do) != 4:
                    raise ValueError(
                        "dimension_ordering must have 4 entries (Z,Y,X,T) "
                        f"for rank-4 data, got {do}")
                self.depth = shape[do[0]]
                self.height = shape[do[1]]
                self.width = shape[do[2]]
                self.frame_count = shape[do[3]]
            elif len(shape) == 3:
                do3 = do[:3]
                self.depth = shape[do3[0]]
                self.height = shape[do3[1]]
                self.width = shape[do3[2]]
                self.frame_count = 1
            else:
                raise ValueError(f"Unsupported MAT array rank {len(shape)}")
            self.n_channels = len(self.dataset_names)
            self.dtype = ds.dtype
        else:
            from scipy.io import loadmat

            data = loadmat(self.file_path)
            info = [(k, v.shape) for k, v in data.items()
                    if isinstance(v, np.ndarray) and v.ndim >= 3
                    and not k.startswith("__")]
            if not self.dataset_names:
                self.dataset_names = self._discover(info)
            if not self.dataset_names:
                raise ValueError("No suitable variables found in MAT file")
            if self.dimension_ordering is None:
                self.dimension_ordering = (0, 1, 2, 3)
            do = tuple(self.dimension_ordering)
            self._arrays = []
            for name in self.dataset_names:
                arr = data[name]
                # stored layout (per dimension_ordering) -> (T,Z,Y,X)
                if arr.ndim == 4:
                    arr = np.transpose(arr, (do[3], do[0], do[1], do[2]))
                elif arr.ndim == 3:
                    arr = np.transpose(arr, do[:3])[np.newaxis]
                self._arrays.append(arr)
            first = self._arrays[0]
            (self.frame_count, self.depth, self.height, self.width) = first.shape
            self.n_channels = len(self._arrays)
            self.dtype = first.dtype

    def _read_raw_frames(self, frame_indices):
        if isinstance(frame_indices, list) and len(frame_indices) > 1 \
                and np.all(np.diff(frame_indices) == 1):
            frame_indices = slice(frame_indices[0], frame_indices[-1] + 1)
        if self._is73:
            do = tuple(self.dimension_ordering)
            chans = []
            for name in self.dataset_names:
                ds = self._h5[name]
                if ds.ndim == 4:
                    idx = [slice(None)] * 4
                    idx[do[3]] = frame_indices
                    raw = np.asarray(ds[tuple(idx)])
                    # T-axis position after indexing: fancy-index with a
                    # list keeps the axis in place; slices keep all axes
                    raw = np.transpose(raw, (do[3], do[0], do[1], do[2]))
                else:
                    raw = np.transpose(np.asarray(ds[()]), do[:3])[np.newaxis]
                chans.append(raw)
            return np.stack(chans, axis=-1)
        return np.stack([a[frame_indices] for a in self._arrays], axis=-1)

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        self._arrays = None


class MATFileWriter3D(VideoWriter3D):
    """Buffers frames and writes per-channel MATLAB variables at close.

    ``version='7.3'`` (default) writes an HDF5-based v7.3 container;
    ``version='5'`` uses scipy.io.savemat.
    """

    def __init__(self, file_path, **kwargs):
        super().__init__()
        self.file_path = str(file_path)
        self.version = str(kwargs.get("version", "7.3"))
        self.dataset_names = kwargs.get("dataset_names") or "ch*"
        self._chunks = []
        if self.version.startswith("7.3"):
            require_h5py()

    def write_frames(self, frames):
        frames = self._as_batch(np.asarray(frames))
        if frames.ndim != 5:
            raise ValueError(f"Expected 4D or 5D array, got {frames.ndim}D")
        if not self.initialized:
            self.init(frames)
        self._chunks.append(frames)

    def close(self):
        if not self._chunks:
            return
        data = np.concatenate(self._chunks, axis=0)  # (T,Z,Y,X,C)
        self._chunks = []
        variables = {}
        for c in range(self.n_channels):
            name = dataset_name_for_channel(self.dataset_names, c + 1,
                                            self.n_channels)
            variables[name] = data[..., c]
        d = os.path.dirname(os.path.abspath(self.file_path))
        os.makedirs(d, exist_ok=True)
        if self.version.startswith("7.3"):
            self._write_v73(variables)
        else:
            from scipy.io import savemat

            # numpy (T,Z,Y,X) -> MATLAB (Z,Y,X,T)
            savemat(self.file_path,
                    {k: np.transpose(v, (1, 2, 3, 0)) for k, v in
                     variables.items()},
                    do_compression=False)

    def _write_v73(self, variables):
        h5py = require_h5py()

        with h5py.File(self.file_path, "w", userblock_size=512) as f:
            for name, arr in variables.items():
                # store (T,X,Y,Z) C-order so MATLAB sees the conventional
                # (Z,Y,X,T) layout (reference mat_3d.py:225-247); record the
                # ordering so our reader round-trips without guessing
                ds = f.create_dataset(name, data=np.transpose(
                    arr, (0, 3, 2, 1)))
                mat_class = _MATLAB_CLASSES.get(
                    arr.dtype.str[1:], "double")
                ds.attrs["MATLAB_class"] = np.bytes_(mat_class)
                ds.attrs["dimension_ordering"] = np.asarray(
                    (3, 2, 1, 0), np.int64)
        _write_mat73_userblock(self.file_path)
