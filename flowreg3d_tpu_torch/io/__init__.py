"""Streaming volumetric I/O (counterpart of ``flowreg3d_tpu/io``): the
VideoReader3D/VideoWriter3D protocol with temporal binning, the in-memory
array adapters, the format factories, ImageJ hyperstack TIFF on the
package's own numpy codec (``io/_tiff_format.py``), MATLAB-compatible HDF5,
MAT v5/v7.3, the multifile/multichannel/subset/folder wrappers, dataset
discovery, ScanImage metadata, the read-ahead reader and the background
writer. Host-side only: nothing here touches the device (``ArrayWriter3D``
copies through torch's CPU tensors).
h5py is imported only where an HDF5 or MAT v7.3 file is asked for.
"""

from flowreg3d_tpu_torch.io.array import ArrayReader3D, ArrayWriter3D
from flowreg3d_tpu_torch.io.base import VideoReader3D, VideoWriter3D
from flowreg3d_tpu_torch.io.factory import (get_video_file_reader,
                                            get_video_file_writer)

__all__ = ["VideoReader3D", "VideoWriter3D", "ArrayReader3D",
           "ArrayWriter3D", "get_video_file_reader", "get_video_file_writer"]
