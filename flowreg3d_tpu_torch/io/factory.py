"""Reader/writer factories (counterpart of ``flowreg3d_tpu/io/factory.py``;
parity: reference util/io/factory.py).

Extension map: .tif/.tiff -> TIFF, .h5/.hdf5/.hdf -> HDF5, .mat -> MAT.
ndarray -> ArrayReader3D; list of paths -> MULTICHANNEL; VideoReader3D
passthrough; a directory -> FolderReader3D. Writer formats: ARRAY, TIFF,
HDF5, MAT, MULTIFILE_<FMT> (an ``OutputFormat`` member or its value).
"""

from pathlib import Path

import numpy as np

from flowreg3d_tpu_torch.io.base import VideoReader3D


def get_video_file_reader(input_source, buffer_size=10, bin_size=1, **kwargs):
    if isinstance(input_source, np.ndarray):
        from flowreg3d_tpu_torch.io.array import ArrayReader3D

        return ArrayReader3D(input_source, buffer_size, bin_size)
    if isinstance(input_source, VideoReader3D):
        return input_source
    if isinstance(input_source, (list, tuple)):
        from flowreg3d_tpu_torch.io.multifile import MULTICHANNELFileReader3D

        return MULTICHANNELFileReader3D(list(input_source), buffer_size,
                                        bin_size, **kwargs)

    path = Path(input_source)
    if path.is_dir():
        # beyond reference parity: the reference raises NotImplementedError
        # here (factory.py:61-65); we read sorted per-timepoint volumes
        from flowreg3d_tpu_torch.io.multifile import FolderReader3D

        return FolderReader3D(str(path), buffer_size, bin_size, **kwargs)
    if not path.exists():
        raise FileNotFoundError(f"File not found: {input_source}")

    ext = path.suffix.lower()
    if ext in (".tif", ".tiff"):
        from flowreg3d_tpu_torch.io.tiff3d import TIFFFileReader3D

        cls = TIFFFileReader3D
    elif ext in (".h5", ".hdf5", ".hdf"):
        from flowreg3d_tpu_torch.io.hdf5 import HDF5FileReader3D

        cls = HDF5FileReader3D
    elif ext == ".mat":
        from flowreg3d_tpu_torch.io.mat import MATFileReader3D

        cls = MATFileReader3D
    else:
        raise ValueError(
            f"Unsupported file format for 3D: {ext}. Supported: TIFF, HDF5, MAT")
    return cls(str(path), buffer_size, bin_size, **kwargs)


def get_video_file_writer(file_path, output_format, **kwargs):
    output_format = str(getattr(output_format, "value",
                                output_format)).upper()
    if output_format == "ARRAY":
        from flowreg3d_tpu_torch.io.array import ArrayWriter3D

        return ArrayWriter3D()
    if file_path is None:
        raise ValueError(f"file_path required for output format: {output_format}")
    if output_format == "TIFF":
        from flowreg3d_tpu_torch.io.tiff3d import TIFFFileWriter3D

        return TIFFFileWriter3D(file_path, **kwargs)
    if output_format == "HDF5":
        from flowreg3d_tpu_torch.io.hdf5 import HDF5FileWriter3D

        return HDF5FileWriter3D(file_path, **kwargs)
    if output_format == "MAT":
        from flowreg3d_tpu_torch.io.mat import MATFileWriter3D

        return MATFileWriter3D(file_path, **kwargs)
    if output_format.startswith("MULTIFILE"):
        from flowreg3d_tpu_torch.io.multifile import MULTIFILEFileWriter3D

        parts = output_format.split("_")
        file_type = parts[1] if len(parts) > 1 else "TIFF"
        return MULTIFILEFileWriter3D(file_path, file_type, **kwargs)
    raise ValueError(f"Unsupported 3D output format: {output_format}")
