"""Streaming volumetric I/O: the reader/writer protocol and the in-memory
array adapters (counterpart of ``flowreg3d_tpu/io``; the file formats are
not ported yet)."""

from flowreg3d_tpu_torch.io.array import ArrayReader3D, ArrayWriter3D
from flowreg3d_tpu_torch.io.base import VideoReader3D, VideoWriter3D
from flowreg3d_tpu_torch.io.factory import (get_video_file_reader,
                                            get_video_file_writer)

__all__ = ["VideoReader3D", "VideoWriter3D", "ArrayReader3D",
           "ArrayWriter3D", "get_video_file_reader", "get_video_file_writer"]
