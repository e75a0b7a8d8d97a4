"""The plain reference of the TIFF recording deployment, importing nothing of
the port.

Upstream flowreg3D's ``compensate_recording(options)``
(``motion_correction/compensate_recording_3D.py:431-591``) over a TIFF file
read with ``reference/tiff.py``: the reference the float64 mean of the frames
``reference_frames`` names that the file holds (frame 0 where it holds none of
them), then every batch of ``buffer_size`` frames as ``reference/pipeline.py``
states the pipeline's semantics (preprocessing against the raw reference's
range, the initial flow of batch 0, each frame's flow from the batch's initial
flow and its cubic warp back onto the raw reference), the registered frames
rounded half to even and clipped to the input's integer type, as the output
TIFF holds them. Float32 with TF32 off.

Departures from the source, for the comparison:

- a frame of batch b > 0 starts from the program's own initial flow of that
  batch (the mean of its last <= 20 flows of batch b - 1, cloned on the card
  before the batch runs), not from one the reference works out: the
  comparison follows the program's chain, as ``reference/pipeline.py``'s does
  from the program's flows, which this deployment does not write; batch 0
  starts from the initial flow the reference works out itself;
- only the sampled frames are registered, and their flows are not kept.
"""

import numpy as np
import torch

from portbench.reference import plain
from portbench.reference.pipeline import (batch_ranges, gaussian, normalize,
                                          preprocess)


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mean_reference(reader, indices):
    """The float64 mean (Z,Y,X,C) of the volumes ``indices`` of ``reader``
    (a ``reference/tiff.Reader``) that the file holds, else of volume 0: a
    sum of integers, exact in float64, divided once."""
    n = reader.shape[0]
    idx = [int(i) for i in indices if 0 <= int(i) < n] or [0]
    total = np.zeros(reader.shape[1:], np.float64)
    for t in idx:
        total += reader.volume(t)
    return total / len(idx)


def check_frames_file(reader, reference, w_inits, sample, params, weight,
                      sigma, buffer_size, device, mm=plain.fp32_matmul):
    """The reference's registered volume (float64 on ``device``, rounded and
    clipped) of each frame in ``sample`` of the recording ``reader`` holds,
    against the raw ``reference`` (Z,Y,X,C) numpy. ``w_inits[b]`` is the
    program's initial flow (Z,Y,X,3) of batch b > 0; ``ValueError`` where a
    sampled batch has none."""
    _tf32_off()
    info = np.iinfo(reader.dtype)
    ref_raw = torch.as_tensor(np.asarray(reference, np.float32)).to(device)
    ref_proc = gaussian(normalize(ref_raw, ref_raw), sigma)
    Z, Y, X, C = ref_raw.shape
    wvol = plain.weight_volume(weight, (Z, Y, X), C, device)
    out = {}
    for k, (a, b) in enumerate(batch_ranges(reader.shape[0], buffer_size)):
        here = [t for t in sorted(sample) if a <= t < b]
        if not here:
            continue
        if k and (k >= len(w_inits) or w_inits[k] is None):
            raise ValueError(f"no initial flow of batch {k}")
        raw = torch.as_tensor(np.stack([reader.volume(t)
                                        for t in range(a, b)])
                              .astype(np.float32)).to(device)
        proc = preprocess(raw, ref_raw, sigma)
        if k:
            w_init = w_inits[k].to(device, torch.float32)
        else:
            zeros = torch.zeros((Z, Y, X, 3), dtype=torch.float32,
                                device=device)
            w_init = torch.stack([
                plain.flow(ref_proc, proc[i], zeros, wvol, params, mm)
                for i in range(min(22, b - a))]).mean(dim=0)
        for t in here:
            fl = plain.flow(ref_proc, proc[t - a], w_init, wvol, params, mm)
            reg = plain.warp(raw[t - a], fl[..., 0], fl[..., 1], fl[..., 2],
                             ref_raw, mm, 3)
            reg = torch.clamp(torch.round(reg), info.min, info.max)
            out[t] = reg.to(torch.float64)
        del raw, proc
    return out
