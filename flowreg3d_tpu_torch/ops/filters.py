"""Filters: the pipeline's preprocessing and the flow increments' median.

Counterpart of ``flowreg3d_tpu/ops/filters.py``:

- ``normalize``: min-max to [0, 1], jointly or per channel, optionally with
  the reference volume's range;
- ``apply_gaussian_filter``: MATLAB-imgaussfilt3-order smoothing of
  (Z,Y,X,C) or (T,Z,Y,X,C): per channel, separable along (t,)z,y,x with
  sigma given as [sx,sy,sz,st] (or (C,4)), taps of
  ``scipy.ndimage.gaussian_filter1d`` (truncate 4.0), boundary numpy
  'symmetric' by default (the edge sample repeated, scipy's 'reflect'), or
  any of the ``jnp.pad`` modes in ``PAD_MODES``. The temporal axis is
  filtered within the batch;
- ``median_filter_5x5x5``: the exact 5^3 median, plain PyTorch;
- ``StreamingTemporalGaussian`` / ``gaussian_filter_1d_half_kernel``: a
  causal half-Gaussian over a stream of frames, host numpy float64 (the
  JAX package's code and contract: no pipeline path calls them).

Everything else runs in the input's dtype on its device; the pipeline
feeds float32.
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


# the jnp.pad / numpy.pad modes the filters take
PAD_MODES = ("symmetric", "reflect", "edge", "constant", "wrap")


def pad_index(n, r, mode="symmetric", device=None):
    """Source indices of ``numpy.pad(x, r, mode)`` along an axis of length
    ``n`` (any ``r``). For 'constant' the index ``n`` stands for the zero
    sample, which the caller appends."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "symmetric":                   # the edge sample repeated
        i = i % (2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    if mode == "reflect":                     # mirrored about the edge
        if n == 1:
            return torch.zeros_like(i)
        i = i % (2 * n - 2)
        return torch.where(i >= n, 2 * n - 2 - i, i)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "constant":
        return torch.where((i >= 0) & (i < n), i, torch.full_like(i, n))
    raise _unsupported(mode)


def _unsupported(mode):
    return ValueError(f"unsupported pad mode {mode!r}; supported: "
                      f"{', '.join(PAD_MODES)}")


def _conv1d_axis(vol, taps, axis, pad_mode="symmetric"):
    """Convolution with the symmetric 1D ``taps`` along ``axis``, boundary
    padded as ``numpy.pad(mode=pad_mode)``, as a weighted sum of shifted
    slices."""
    t = np.float64 if vol.dtype == torch.float64 else np.float32
    k = [float(v) for v in np.asarray(taps, t)]
    if len(k) == 1:
        return vol * k[0]
    r = len(k) // 2
    n = vol.shape[axis]
    idx = pad_index(n, r, pad_mode, vol.device)
    if pad_mode == "constant":
        vol = torch.cat([vol, torch.zeros_like(vol.narrow(axis, 0, 1))],
                        dim=axis)
    xp = vol.index_select(axis, idx)
    out = xp.narrow(axis, 0, n) * k[0]
    for j in range(1, len(k)):
        out = out + xp.narrow(axis, j, n) * k[j]
    return out


def gaussian_filter_3d(vol, sigma_zyx, truncate=4.0, pad_mode="symmetric"):
    """Separable Gaussian over the leading ``len(sigma_zyx)`` axes, boundary
    ``numpy.pad(mode=pad_mode)``, one of ``PAD_MODES``."""
    if pad_mode not in PAD_MODES:
        raise _unsupported(pad_mode)
    out = vol
    for axis, s in enumerate(sigma_zyx):
        if s and s > 0:
            out = _conv1d_axis(out, _gauss_kernel_np(float(s),
                                                     float(truncate)),
                               axis, pad_mode)
    return out


def apply_gaussian_filter(arr, sigma, mode="symmetric", truncate=4.0):
    """MATLAB-order Gaussian of (Z,Y,X,C) or (T,Z,Y,X,C).

    ``sigma``: (4,) = [sx,sy,sz,st] for all channels, or (C,4) per channel.
    Only the MATLAB-order lengths are reversed to the array's axes: 3 on
    4-D input, 4 on 5-D input; any other length applies as given, from the
    leading axis, as in the JAX package. ``mode``: the boundary, a
    ``numpy.pad`` mode of ``PAD_MODES`` (scipy's 'reflect' is 'symmetric').
    """
    sigma = np.asarray(sigma, dtype=np.float64)
    if arr.dim() not in (4, 5):
        return gaussian_filter_3d(arr, tuple(np.atleast_1d(sigma)), truncate,
                                  mode)
    chans = []
    for c in range(arr.shape[-1]):
        s = sigma[min(c, len(sigma) - 1)] if sigma.ndim == 2 else sigma
        if arr.dim() == 4:
            s = s[:3]
        if len(s) == arr.dim() - 1:
            s = s[::-1]
        chans.append(gaussian_filter_3d(arr[..., c], tuple(s), truncate,
                                        mode))
    return torch.stack(chans, dim=-1)


def median_filter_5x5x5(x):
    """Exact 5x5x5 median of a (Z,Y,X) tensor, boundary 'mirror'
    (scipy.ndimage.median_filter(size=5, mode='mirror')), plain PyTorch."""
    return median5_plain(mirror_pad2(x[None]))[0]


class StreamingTemporalGaussian:
    """Causal (half-kernel) temporal Gaussian over a streamed batch axis.

    A deque of the last ``radius+1`` frames convolved with the half
    Gaussian (current + past taps only, renormalized), so batch boundaries
    introduce no artifacts. Host numpy float64, as in the JAX package.
    """

    def __init__(self, sigma, truncate=4.0):
        from collections import deque

        self.sigma = float(sigma)
        if self.sigma <= 0:
            self.radius = 0
            self.kernel = np.ones(1, np.float64)
        else:
            self.radius = int(truncate * self.sigma + 0.5)
            x = np.arange(0, self.radius + 1, dtype=np.float64)
            k = np.exp(-0.5 * (x / self.sigma) ** 2)
            self.kernel = k / k.sum()  # taps: [now, -1, -2, ...]
        self._buffer = deque(maxlen=self.radius + 1)

    def reset(self):
        self._buffer.clear()

    def __call__(self, frame):
        """Filtered frame given the stream history (adds ``frame`` first)."""
        frame = np.asarray(frame, np.float64)
        self._buffer.appendleft(frame)
        taps = self.kernel[: len(self._buffer)]
        taps = taps / taps.sum()
        out = np.zeros_like(frame)
        for w, f in zip(taps, self._buffer):
            out += w * f
        return out

    def filter_batch(self, frames):
        """Apply to a (T, ...) batch, continuing the stream state."""
        return np.stack([self(frames[t]) for t in range(frames.shape[0])])


def gaussian_filter_1d_half_kernel(frames, sigma, truncate=4.0, state=None):
    """Functional wrapper: returns (filtered (T,...), state) for streaming."""
    state = state or StreamingTemporalGaussian(sigma, truncate)
    return state.filter_batch(np.asarray(frames)), state
