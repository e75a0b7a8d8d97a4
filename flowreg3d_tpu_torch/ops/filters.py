"""Filters: the pipeline's preprocessing and the flow increments' median.

Counterpart of ``flowreg3d_tpu/ops/filters.py``:

- ``normalize``: min-max to [0, 1], jointly or per channel, optionally with
  the reference volume's range;
- ``apply_gaussian_filter``: MATLAB-imgaussfilt3-order smoothing of
  (Z,Y,X,C) or (T,Z,Y,X,C): per channel, separable along (t,)z,y,x with
  sigma given as [sx,sy,sz,st] (or (C,4)), taps of
  ``scipy.ndimage.gaussian_filter1d`` (truncate 4.0), boundary numpy
  'symmetric' (the edge sample repeated, scipy's 'reflect'). The temporal
  axis is filtered within the batch;
- ``median_filter_5x5x5``: the exact 5^3 median, plain PyTorch.

Everything runs in the input's dtype on its device; the pipeline feeds
float32. ``StreamingTemporalGaussian`` is not ported yet.
"""

from functools import lru_cache

import numpy as np
import torch

from flowreg3d_tpu_torch.ops.median_kernel import median5_plain, mirror_pad2


def normalize(arr, ref=None, channel_normalization="together", eps=1e-8):
    """Min-max normalise to [0, 1]; the range comes from ``ref`` when given.

    arr: (Z,Y,X,C) or (T,Z,Y,X,C) tensor (any rank for 'together').
    """
    src = arr if ref is None else ref.to(arr.dtype)
    if channel_normalization == "separate" and arr.dim() >= 4:
        flat = src.reshape(-1, src.shape[-1])
        min_val = flat.amin(0)
        rng = flat.amax(0) - min_val
        return (arr - min_val) / torch.where(rng > 0, rng,
                                             torch.ones_like(rng))
    min_val = src.min()
    max_val = src.max()
    if ref is None and channel_normalization == "separate":
        rng = max_val - min_val
        safe = torch.where(rng > 0, rng, torch.ones_like(rng))
        return torch.where(rng > 0, (arr - min_val) / safe, arr - min_val)
    return (arr - min_val) / (max_val - min_val + eps)


@lru_cache(maxsize=128)
def _gauss_kernel_np(sigma: float, truncate: float) -> np.ndarray:
    """1D Gaussian taps matching scipy.ndimage.gaussian_filter1d."""
    if sigma <= 0:
        return np.ones(1, dtype=np.float64)
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def symmetric_pad_index(n, r, device=None):
    """Source indices of numpy's 'symmetric' pad by ``r`` on both sides of an
    axis of length ``n`` (the edge sample repeated; any ``r``)."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _conv1d_axis(vol, taps, axis):
    """Convolution with the symmetric 1D ``taps`` along ``axis``, boundary
    'symmetric', as a weighted sum of shifted slices."""
    t = np.float64 if vol.dtype == torch.float64 else np.float32
    k = [float(v) for v in np.asarray(taps, t)]
    if len(k) == 1:
        return vol * k[0]
    r = len(k) // 2
    n = vol.shape[axis]
    xp = vol.index_select(axis, symmetric_pad_index(n, r, vol.device))
    out = xp.narrow(axis, 0, n) * k[0]
    for j in range(1, len(k)):
        out = out + xp.narrow(axis, j, n) * k[j]
    return out


def gaussian_filter_3d(vol, sigma_axes, truncate=4.0):
    """Separable Gaussian over the leading ``len(sigma_axes)`` axes."""
    out = vol
    for axis, s in enumerate(sigma_axes):
        if s and s > 0:
            out = _conv1d_axis(out, _gauss_kernel_np(float(s),
                                                     float(truncate)), axis)
    return out


def apply_gaussian_filter(arr, sigma, truncate=4.0):
    """MATLAB-order Gaussian of (Z,Y,X,C) or (T,Z,Y,X,C).

    ``sigma``: (4,) = [sx,sy,sz,st] for all channels, or (C,4) per channel.
    """
    sigma = np.asarray(sigma, dtype=np.float64)
    if arr.dim() not in (4, 5):
        return gaussian_filter_3d(arr, tuple(np.atleast_1d(sigma)), truncate)
    chans = []
    for c in range(arr.shape[-1]):
        s = sigma[min(c, len(sigma) - 1)] if sigma.ndim == 2 else sigma
        if arr.dim() == 4:
            s = s[:3]
        chans.append(gaussian_filter_3d(arr[..., c], tuple(s[::-1]),
                                        truncate))
    return torch.stack(chans, dim=-1)


def median_filter_5x5x5(x):
    """Exact 5x5x5 median of a (Z,Y,X) tensor, boundary 'mirror'
    (scipy.ndimage.median_filter(size=5, mode='mirror')), plain PyTorch."""
    return median5_plain(mirror_pad2(x[None]))[0]
