"""Fused Gaussian anti-alias + Keys-cubic separable resize.

Counterpart of ``flowreg3d_tpu/ops/resize.py``. The per-axis tap tables are
built on the host in numpy (the same code as the JAX package) and scattered
into a dense (out_len, in_len) matrix per axis; a resize is three fp32
matrix products, x then y then z. ``resize_batch`` resizes a (T,Z,Y,X,C)
batch in one set of products (the frames folded into the channels) and
``imresize2d_gauss_cubic`` is the 2-D wrapper; both take ``device=None``,
meaning 'cuda'.
"""

from functools import lru_cache

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device

# Keys cubic parameter (MATLAB imresize kernel).
_A = -0.75


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel with A=-0.75 (MATLAB imresize kernel)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (_A + 2.0) * ax3 - (_A + 3.0) * ax2 + 1.0
    outer = _A * ax3 - 5.0 * _A * ax2 + 8.0 * _A * ax - 4.0 * _A
    return np.where(ax < 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _reflect_indices(j: np.ndarray, n: int) -> np.ndarray:
    """Vectorized reflect ('symmetric') index fold: ... 1 0 | 0 1 ... n-1 | n-1 ..."""
    if n <= 1:
        return np.zeros_like(j)
    period = 2 * n
    j = np.mod(j, period)
    j = np.where(j < 0, j + period, j)
    return np.where(j >= n, period - 1 - j, j)


def _fused_tap_tables(in_len: int, out_len: int, sigma: float):
    """(idx, wt) tap tables for one axis: Gaussian (x) Keys-cubic, normalized."""
    scale = out_len / in_len
    if sigma <= 0.0:
        radius = 0
        gauss = np.array([1.0], dtype=np.float64)
    else:
        radius = int(np.ceil(2.0 * sigma))
        xg = np.arange(-radius, radius + 1, dtype=np.float32)
        gauss = np.exp(-0.5 * (xg / np.float32(sigma)) ** 2).astype(np.float32)
        gauss = (gauss / gauss.sum()).astype(np.float64)
    taps = 2 * radius + 4

    i = np.arange(out_len, dtype=np.float64)
    x = (i + 0.5) / scale - 0.5
    left = np.floor(x - 2.0).astype(np.int64) - radius
    p = np.arange(taps)
    j = left[:, None] + p[None, :]               # (out_len, taps) source index
    d = x[:, None] - j                           # distance to tap
    # weight = sum_u gauss[u] * cubic(d - u), u in [-radius, radius]
    u = np.arange(-radius, radius + 1)
    wt = np.einsum("u,opu->op", gauss, _cubic_kernel(d[:, :, None] - u[None, None, :]))
    wt = wt / wt.sum(axis=1, keepdims=True)
    idx = _reflect_indices(j, in_len)
    return idx, wt


@lru_cache(maxsize=256)
def _resize_matrix_np(in_len: int, out_len: int, sigma: float) -> np.ndarray:
    """Dense (out_len, in_len) resize operator from the tap tables."""
    idx, wt = _fused_tap_tables(in_len, out_len, float(sigma))
    mat = np.zeros((out_len, in_len), dtype=np.float64)
    rows = np.repeat(np.arange(out_len), idx.shape[1])
    np.add.at(mat, (rows, idx.ravel()), wt.ravel())
    return mat


@lru_cache(maxsize=256)
def resize_matrix(in_len: int, out_len: int, sigma: float, dtype, device):
    """The resize operator as a tensor on ``device`` (cached per device)."""
    mat = _resize_matrix_np(in_len, out_len, float(sigma))
    return torch.as_tensor(mat, dtype=dtype).to(device)


def _axis_sigmas(in_shape, out_shape, sigma_coeff: float, per_axis: bool):
    """sigma per (z,y,x) axis."""
    sz = out_shape[0] / in_shape[0]
    sy = out_shape[1] / in_shape[1]
    sx = out_shape[2] / in_shape[2]
    if per_axis:
        return (
            sigma_coeff / sz if sz < 1.0 else 0.0,
            sigma_coeff / sy if sy < 1.0 else 0.0,
            sigma_coeff / sx if sx < 1.0 else 0.0,
        )
    s = min(sx, sy, sz)
    val = sigma_coeff / s if s < 1.0 else 0.0
    return (val, val, val)


def resize_volume(vol, out_size, sigma_coeff: float = 0.6,
                  per_axis: bool = False, dtype=torch.float32):
    """Resize a (Z,Y,X) or (Z,Y,X,C) tensor to out_size=(od,oh,ow)."""
    squeeze = vol.dim() == 3
    x = vol.to(dtype)
    if squeeze:
        x = x[..., None]
    Z, Y, X, C = x.shape
    od, oh, ow = int(out_size[0]), int(out_size[1]), int(out_size[2])
    sgz, sgy, sgx = _axis_sigmas((Z, Y, X), (od, oh, ow), sigma_coeff,
                                 per_axis)
    rx = resize_matrix(X, ow, sgx, dtype, x.device)
    ry = resize_matrix(Y, oh, sgy, dtype, x.device)
    rz = resize_matrix(Z, od, sgz, dtype, x.device)
    x = x.permute(0, 1, 3, 2).reshape(Z * Y * C, X) @ rx.T  # (Z*Y*C, ow)
    x = x.reshape(Z, Y, C, ow).permute(0, 1, 3, 2)          # (Z, Y, ow, C)
    x = torch.matmul(ry, x.reshape(Z, Y, ow * C))          # (Z, oh, ow*C)
    x = torch.matmul(rz, x.reshape(Z, oh * ow * C))        # (od, oh*ow*C)
    x = x.reshape(od, oh, ow, C)
    return x[..., 0] if squeeze else x


def _upload(x, dev):
    """A tensor on ``dev`` in its own dtype (numpy or tensor in)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def resize_batch(batch, out_size, sigma_coeff: float = 0.6,
                 per_axis: bool = False, dtype=torch.float32, device=None):
    """Resize a (T,Z,Y,X,C) or (T,Z,Y,X) batch along its spatial axes on
    ``device`` (None means 'cuda'); returns a tensor in ``dtype``."""
    x = _upload(batch, resolve_device(device))
    squeeze = x.dim() == 4
    if squeeze:
        x = x[..., None]
    T, Z, Y, X, C = x.shape
    x = x.permute(1, 2, 3, 0, 4).reshape(Z, Y, X, T * C)
    out = resize_volume(x, out_size, sigma_coeff, per_axis, dtype)
    od, oh, ow = out.shape[:3]
    out = out.reshape(od, oh, ow, T, C).permute(3, 0, 1, 2, 4).contiguous()
    return out[..., 0] if squeeze else out


def imresize_fused_gauss_cubic3D(img, size, sigma_coeff: float = 0.6,
                                 per_axis: bool = False):
    """Resize a 3D or 4D channels-last tensor; integer types keep their
    type by round-half-even + clip, like the JAX package."""
    out = resize_volume(img, size[:3], sigma_coeff, per_axis)
    if img.dtype.is_floating_point:
        return out.to(img.dtype)
    info = torch.iinfo(img.dtype)
    return torch.clamp(torch.round(out), info.min, info.max).to(img.dtype)


def imresize2d_gauss_cubic(img2d, out_hw, sigma_coeff: float = 0.6,
                           device=None):
    """Resize a (H,W) or (H,W,C) image to ``out_hw`` on ``device`` (None
    means 'cuda'), per-axis sigmas; integer types by round and clip."""
    img = _upload(img2d, resolve_device(device))
    out = imresize_fused_gauss_cubic3D(
        img[None], (1, int(out_hw[0]), int(out_hw[1])),
        sigma_coeff=sigma_coeff, per_axis=True)
    return out[0]
