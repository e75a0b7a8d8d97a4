"""Reader/writer factories (counterpart of ``flowreg3d_tpu/io/factory.py``).

Only the in-memory ARRAY format is ported: an ndarray becomes an
``ArrayReader3D`` and a ``VideoReader3D`` passes through. File formats
(TIFF, HDF5, MAT, multifile) raise until the io modules are ported
(ROADMAP.md Queue 1 item 12).
"""

import numpy as np

from flowreg3d_tpu_torch.io.array import ArrayReader3D, ArrayWriter3D
from flowreg3d_tpu_torch.io.base import VideoReader3D

_NOT_PORTED = ("is not ported to flowreg3d_tpu_torch yet (ROADMAP.md Queue 1 "
               "item 12); only in-memory arrays (format ARRAY) are")


def get_video_file_reader(input_source, buffer_size=10, bin_size=1, **kwargs):
    if isinstance(input_source, np.ndarray):
        return ArrayReader3D(input_source, buffer_size, bin_size)
    if isinstance(input_source, VideoReader3D):
        return input_source
    raise NotImplementedError(f"reading {input_source!r} {_NOT_PORTED}")


def get_video_file_writer(file_path, output_format, **kwargs):
    output_format = str(getattr(output_format, "value", output_format)).upper()
    if output_format == "ARRAY":
        return ArrayWriter3D()
    raise NotImplementedError(f"output format {output_format} {_NOT_PORTED}")
