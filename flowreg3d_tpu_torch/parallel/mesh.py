"""Helpers for frame-level data parallelism.

Counterpart of ``flowreg3d_tpu/parallel/mesh.py``. Only ``pad_to_multiple``
is ported so far; the device mesh itself (frames split over several cards,
reference volumes replicated) waits for the multi-GPU executor (ROADMAP.md
Queue 1 item 11).
"""

import numpy as np


def pad_to_multiple(arr, multiple, axis=0):
    """Edge-pad ``arr`` along ``axis`` to a multiple of ``multiple``;
    returns (padded, original_len)."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, pad)
    return np.pad(arr, pad_width, mode="edge"), n
