"""In-memory compensation API.

Counterpart of ``flowreg3d_tpu/pipeline/compensate_arr.py``: wraps the
arrays into the array reader/writer so the streaming pipeline is reused
unchanged, restores the input's shape convention and applies
``output_typename``: the writer is told the recording's frame count and the
output dtype, so each batch is cast into the returned array as it is
written. Returns ``(registered, flows)`` as numpy arrays. ``device=None``
means 'cuda'.
"""

from typing import Callable, Optional, Tuple

import numpy as np

from flowreg3d_tpu_torch._trace import span
from flowreg3d_tpu_torch.io.array import ArrayWriter3D
from flowreg3d_tpu_torch.pipeline.corrector import (BatchMotionCorrector,
                                                    RegistrationConfig)
from flowreg3d_tpu_torch.pipeline.of_options import OFOptions, OutputFormat

_DTYPE_MAP = {
    "single": np.float32,
    "double": np.float64,
    "uint8": np.uint8,
    "uint16": np.uint16,
    "int16": np.int16,
    "int32": np.int32,
}


def compensate_arr(c1, c_ref, options: Optional[OFOptions] = None,
                   progress_callback: Optional[Callable] = None,
                   config: Optional[RegistrationConfig] = None,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Register ``c1`` (T,Z,Y,X,C) / (Z,Y,X,C) / (T,Z,Y,X) / (Z,Y,X) against
    ``c_ref`` in memory. Returns (registered, flows (T,Z,Y,X,3))."""
    c1 = np.asarray(c1)
    c_ref = np.asarray(c_ref)
    if c1.size == 0:
        raise ValueError("Input array cannot be empty")

    original_ndim = c1.ndim
    squeezed = False
    if c1.ndim == 4 and c_ref.ndim == 3:
        c1 = c1[..., np.newaxis]
        c_ref = c_ref[..., np.newaxis]
        squeezed = True
    elif c1.ndim == 3:
        c1 = c1[np.newaxis, ..., np.newaxis]
        if c_ref.ndim == 3:
            c_ref = c_ref[..., np.newaxis]
        squeezed = True

    options = OFOptions() if options is None else options.copy()
    options.input_file = c1
    options.reference_frames = c_ref
    options.output_format = OutputFormat.ARRAY
    options.save_w = True
    options.save_meta_info = False
    options._video_reader = None
    options._video_writer = ArrayWriter3D(    # the reader's binned frames
        frame_count=-(-c1.shape[0] // options.bin_size),
        dtype=_DTYPE_MAP.get(options.output_typename))

    corrector = BatchMotionCorrector(options, config, device)
    if progress_callback is not None:
        corrector.register_progress_callback(progress_callback)
    corrector.run()

    with span("flowreg3d.output"):
        c_reg = corrector.video_writer.get_array()
        w = corrector.w_writer.get_array()

    if squeezed:
        if original_ndim == 3:
            c_reg = np.squeeze(c_reg)
            w = np.squeeze(w, axis=0)
        elif original_ndim == 4:
            c_reg = np.squeeze(c_reg, axis=-1)
    return c_reg, w


# the reference's name
compensate_arr_3D = compensate_arr
