"""The plain reference of the in-memory pipeline's semantics.

``compensate_arr_3D(frames, reference, options)`` over a (T, Z, Y, X, C)
recording, as the port's pipeline defines it: the raw reference and each batch
of ``buffer_size`` frames as float32; preprocessing, normalisation against the
raw reference's range (the reference against its own) and then a Gaussian per
channel with sigma [sx, sy, sz, st] along x, y, z and, within the batch, t; the
initial flow, the mean of the flows of the first min(22, batch) frames from a
zero flow; every frame of batch b registered from w_init_b (the initial flow for
b = 0, else the mean of the last <= 20 flows of batch b - 1); each frame's flow
from the preprocessed reference to the preprocessed frame, with the channel
weights as a volume, and the raw frame warped back onto the raw reference
(cubic); the registered frames rounded half to even and clipped to the input's
integer type, then returned as float64.
"""

import numpy as np
import torch

from portbench.reference import plain


def _taps(sigma):
    if sigma <= 0:
        return np.ones(1)
    r = int(4.0 * float(sigma) + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _smooth_axis(vol, sigma, axis):
    """Gaussian along ``axis`` with the edge sample repeated at the
    boundary, taps rounded to float32."""
    k = [float(v) for v in np.asarray(_taps(sigma), np.float32)]
    if len(k) == 1:
        return vol * k[0]
    r = len(k) // 2
    n = vol.shape[axis]
    i = torch.arange(-r, n + r, device=vol.device) % (2 * n)
    i = torch.where(i >= n, 2 * n - 1 - i, i)
    xp = vol.index_select(axis, i)
    out = xp.narrow(axis, 0, n) * k[0]
    for j in range(1, len(k)):
        out = out + xp.narrow(axis, j, n) * k[j]
    return out


def gaussian(arr, sigma):
    """Per channel of (Z,Y,X,C) or (T,Z,Y,X,C): the spatial sigmas (and on a
    batch the temporal one), from the leading axis."""
    sigma = np.asarray(sigma, np.float64)
    chans = []
    for c in range(arr.shape[-1]):
        s = sigma[min(c, len(sigma) - 1)] if sigma.ndim == 2 else sigma
        s = s[:3] if arr.dim() == 4 else s
        s = s[::-1]
        vol = arr[..., c]
        for axis, sg in enumerate(s):
            if sg > 0:
                vol = _smooth_axis(vol, float(sg), axis)
        chans.append(vol)
    return torch.stack(chans, dim=-1)


def normalize(arr, ref, eps=1e-8):
    lo, hi = ref.min(), ref.max()
    return (arr - lo) / (hi - lo + eps)


def preprocess(arr, ref_raw, sigma):
    """A batch (T,Z,Y,X,C) against the raw reference's range."""
    return gaussian(normalize(arr, ref_raw), sigma)


def batch_ranges(n_frames, buffer_size):
    return [(a, min(a + buffer_size, n_frames))
            for a in range(0, n_frames, buffer_size)]


def check_frames(frames, reference, program_flows, sample, params, weight,
                 sigma, buffer_size, device, mm=plain.fp32_matmul):
    """The reference's (flow, registered float64) of each frame in
    ``sample``. ``frames`` (T,Z,Y,X,C) integer numpy, ``reference`` the raw
    reference numpy. A frame of batch b > 0 starts from the mean of the
    program's flows of batch b - 1 (``program_flows``, numpy (T,Z,Y,X,3)),
    which the comparison follows; batch 0 starts from the initial flow the
    reference works out itself."""
    info = np.iinfo(frames.dtype)
    ref_raw = torch.as_tensor(np.asarray(reference, np.float32)).to(device)
    ref_proc = gaussian(normalize(ref_raw, ref_raw), sigma)
    Z, Y, X, C = ref_raw.shape
    wvol = plain.weight_volume(weight, (Z, Y, X), C, device)
    ranges = batch_ranges(frames.shape[0], buffer_size)

    def batch_proc(a, b):
        raw = torch.as_tensor(frames[a:b].astype(np.float32)).to(device)
        return raw, preprocess(raw, ref_raw, sigma)

    initial_w = None
    out = {}
    for t in sorted(sample):
        k = next(i for i, (a, b) in enumerate(ranges) if a <= t < b)
        a, b = ranges[k]
        raw, proc = batch_proc(a, b)
        if k == 0:
            if initial_w is None:
                zeros = torch.zeros((Z, Y, X, 3), dtype=torch.float32,
                                    device=device)
                n = min(22, b - a)
                initial_w = torch.stack([
                    plain.flow(ref_proc, proc[i], zeros, wvol, params, mm)
                    for i in range(n)]).mean(dim=0)
            w_init = initial_w
        else:
            pa, pb = ranges[k - 1]
            prev = torch.as_tensor(program_flows[pa:pb]).to(device)
            w_init = prev[-20:].mean(dim=0)
            del prev
        fl = plain.flow(ref_proc, proc[t - a], w_init, wvol, params, mm)
        reg = plain.warp(raw[t - a], fl[..., 0], fl[..., 1], fl[..., 2],
                         ref_raw, mm, 3)
        reg = torch.clamp(torch.round(reg), info.min, info.max)
        out[t] = (fl, reg.to(torch.float64))
        del raw, proc
    return out
