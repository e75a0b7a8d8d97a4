"""Sampling a coefficient volume at clipped coordinates: the CUDA kernel
``map_coords_f32`` (csrc/map_coords.cu) and its plain PyTorch version.

Counterpart of ``flowreg3d_tpu/ops/warp_pallas.py:map_coordinates_windowed``.
``map_coords`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

import torch

from flowreg3d_tpu_torch import _ext

# the kernel indexes coeff and the outputs with 32-bit offsets
_MAX_ELEMENTS = 2 ** 31 - 1

_SIXTH = 1.0 / 6.0


def _cubic_weights(t):
    """Cubic B-spline tap weights at taps {-1, 0, 1, 2} for fraction t.

    Multiplies by 1/6 (as PyTorch's CUDA division by a scalar does, and
    as the kernel does) so that both round alike.
    """
    t2 = t * t
    t3 = t2 * t
    return ((1.0 - 3.0 * t + 3.0 * t2 - t3) * _SIXTH,
            (4.0 - 6.0 * t2 + 3.0 * t3) * _SIXTH,
            (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) * _SIXTH,
            t3 * _SIXTH)


def _taps(order):
    if order not in (1, 3):
        raise ValueError(f"order must be 1 or 3, got {order}")
    return 4 if order == 3 else 2


def _split(c, n):
    """Clamp to [0, n-1] (NaN to 0) -> (int64 base index, fraction)."""
    c = torch.nan_to_num(c, nan=0.0).clamp(0, n - 1)
    f = torch.floor(c)
    return f.long(), c - f


def map_coords_plain(coeff, cz, cy, cx, order):
    """Plain version of the kernel, same arithmetic order.

    coeff: (Z+3, Y+3, X+3) B-spline coefficients, tap i at index i+1
    (order 3), or the volume edge-padded by one at the far faces,
    (Z+1, Y+1, X+1) (order 1). cz, cy, cx: coordinates, any one shape.
    """
    K = _taps(order)
    Ze, Ye, Xe = coeff.shape
    Z, Y, X = Ze - (K - 1), Ye - (K - 1), Xe - (K - 1)
    z0, tz = _split(cz.reshape(-1), Z)
    y0, ty = _split(cy.reshape(-1), Y)
    x0, tx = _split(cx.reshape(-1), X)
    if K == 4:
        wz, wy, wx = _cubic_weights(tz), _cubic_weights(ty), _cubic_weights(tx)
    else:
        wz, wy, wx = (1.0 - tz, tz), (1.0 - ty, ty), (1.0 - tx, tx)
    flat = coeff.reshape(-1)
    base = (z0 * Ye + y0) * Xe + x0
    acc = torch.zeros_like(tz)
    for a in range(K):
        acc_y = torch.zeros_like(tz)
        for b in range(K):
            row = base + (a * Ye + b) * Xe
            acc_x = torch.zeros_like(tz)
            for d in range(K):
                acc_x = acc_x + wx[d] * flat[row + d]
            acc_y = acc_y + wy[b] * acc_x
        acc = acc + wz[a] * acc_y
    return acc.reshape(cz.shape)


def _out_shape(c):
    """The (Oz, Oy, Ox) volume the kernel tiles: the coordinates' own shape
    if 3-D, else one row."""
    return tuple(c.shape) if c.dim() == 3 else (1, 1, c.numel())


def map_coords(coeff, cz, cy, cx, order):
    """Sample ``coeff`` at (cz, cy, cx); see ``map_coords_plain``."""
    K = _taps(order)
    devices = {t.device for t in (coeff, cz, cy, cx)}
    if len(devices) != 1:
        raise ValueError(f"map_coords: tensors on several devices {devices}")
    if coeff.device.type == "cpu":
        return map_coords_plain(coeff, cz, cy, cx, order)
    _ext.check_cuda(coeff, "map_coords coeff", 3, torch.float32)
    for name, t in (("cz", cz), ("cy", cy), ("cx", cx)):
        _ext.check_cuda(t, f"map_coords {name}", cz.dim(), torch.float32)
        if t.shape != cz.shape:
            raise ValueError(f"map_coords: {name} shape {tuple(t.shape)} "
                             f"!= {tuple(cz.shape)}")
    Ze, Ye, Xe = coeff.shape
    if max(coeff.numel(), cz.numel()) > _MAX_ELEMENTS:
        raise ValueError(f"map_coords: coeff {tuple(coeff.shape)} or "
                         f"coordinates {tuple(cz.shape)} exceed 2^31 - 1 "
                         "elements")
    out = torch.empty_like(cz)
    with torch.cuda.device(coeff.device):
        rc = _ext.lib().map_coords_f32(
            coeff.data_ptr(), Ze, Ye, Xe, cz.data_ptr(), cy.data_ptr(),
            cx.data_ptr(), out.data_ptr(), *_out_shape(cz), Ze - (K - 1),
            Ye - (K - 1), Xe - (K - 1), order, _ext.stream_of(coeff))
    _ext.raise_on_error(rc, "map_coords_f32")
    map_coords.launches += 1
    return out


map_coords.launches = 0
