"""Backward warping of 3D volumes by dense displacement fields.

Counterpart of ``flowreg3d_tpu/ops/warp.py``: ``moving(x+u, y+v, z+w)``
sampled like ``scipy.ndimage.map_coordinates`` (order 3 = cubic B-spline
with prefiltering, order 1 = trilinear), ``mode='nearest'``, coordinates
clipped to the valid range, out-of-bounds voxels filled from the fixed
volume. The prefilter is three fp32 matrix products with per-axis dense
inverses built on the host; the sampling is ``ops/warp_kernel.py``.
"""

from functools import lru_cache

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.ops.warp_kernel import map_coords, map_coords_plain

_SPLINE_PAD = 12  # matches scipy's _prepad_for_spline_filter for mode='nearest'


@lru_cache(maxsize=64)
def _bspline_prefilter_mat_np(n: int) -> np.ndarray:
    """Combined edge-pad + cubic-B-spline prefilter matrix, shape (n+3, n).

    Reproduces scipy.ndimage.map_coordinates(order=3, mode='nearest')
    coefficient handling: scipy edge-pads the input by 12 samples,
    spline-filters the padded signal, and evaluates taps in the padded
    array. Row r of the returned matrix yields the spline coefficient at
    original tap position r-1 (taps -1..n+1 are all a clipped coordinate's
    4-tap window can touch), so evaluation needs no index clipping.
    """
    if n == 1:
        return np.ones((4, 1), dtype=np.float64)
    npad = n + 2 * _SPLINE_PAD
    B = np.zeros((npad, npad), dtype=np.float64)
    idx = np.arange(npad)
    for off, w in ((-1, 1.0 / 6.0), (0, 2.0 / 3.0), (1, 1.0 / 6.0)):
        j = np.clip(idx + off, 0, npad - 1)
        np.add.at(B, (idx, j), w)
    Binv = np.linalg.inv(B)
    pad = np.zeros((npad, n), dtype=np.float64)
    pad[np.arange(npad), np.clip(np.arange(npad) - _SPLINE_PAD, 0, n - 1)] = 1.0
    return (Binv @ pad)[_SPLINE_PAD - 1: _SPLINE_PAD + n + 2]


@lru_cache(maxsize=64)
def _prefilter_matrix(n, dtype, device):
    return torch.as_tensor(_bspline_prefilter_mat_np(n), dtype=dtype).to(device)


def bspline_prefilter(vol, dtype=None):
    """Extended spline coefficients of a (Z,Y,X) volume -> (Z+3, Y+3, X+3),
    computed and returned in ``dtype`` (None: the volume's).

    Index [i+1] along each axis holds the coefficient for tap position i.
    """
    vol = vol.to(dtype or vol.dtype)
    Z, Y, X = vol.shape
    pz, py, px = (_prefilter_matrix(n, vol.dtype, vol.device)
                  for n in (Z, Y, X))
    a = (vol.reshape(Z * Y, X) @ px.T).reshape(Z, Y, X + 3)
    b = torch.matmul(py, a)                                  # (Z, Y+3, X+3)
    return (pz @ b.reshape(Z, -1)).reshape(Z + 3, Y + 3, X + 3)


def _pad_far_edge(vol):
    """Edge-pad by one sample at the far face of every axis: the +1 taps of
    trilinear sampling at the last index have weight 0 there."""
    vol = torch.cat([vol, vol[-1:]], dim=0)
    vol = torch.cat([vol, vol[:, -1:]], dim=1)
    return torch.cat([vol, vol[:, :, -1:]], dim=2)


def map_coordinates_cubic(vol, coord_z, coord_y, coord_x, use_kernels=True):
    """scipy map_coordinates(vol, [cz,cy,cx], order=3, mode='nearest') for
    in-range coordinates."""
    sample = map_coords if use_kernels else map_coords_plain
    return sample(bspline_prefilter(vol), coord_z, coord_y, coord_x, 3)


def map_coordinates_linear(vol, coord_z, coord_y, coord_x, use_kernels=True):
    """Trilinear sampling, mode='nearest' for in-range coordinates."""
    sample = map_coords if use_kernels else map_coords_plain
    return sample(_pad_far_edge(vol), coord_z, coord_y, coord_x, 1)


def sample_coords(u, v, w):
    """Sampling coordinates (cz, cy, cx) of a backward warp by the (Z,Y,X)
    displacements (u, v, w), clamped to the volume, and the mask of voxels
    whose displaced position leaves it."""
    Z, Y, X = u.shape
    grid_z, grid_y, grid_x = torch.meshgrid(
        *(torch.arange(n, dtype=u.dtype, device=u.device) for n in (Z, Y, X)),
        indexing="ij")
    map_x = grid_x + u
    map_y = grid_y + v
    map_z = grid_z + w
    oob = ((map_x < 0) | (map_x >= X) | (map_y < 0) | (map_y >= Y)
           | (map_z < 0) | (map_z >= Z))
    # OOB voxels are overwritten from ``f1`` by the caller; their
    # coordinates are don't-cares, set to the identity grid
    cx = torch.where(oob, grid_x, map_x.clamp(0, X - 1)).contiguous()
    cy = torch.where(oob, grid_y, map_y.clamp(0, Y - 1)).contiguous()
    cz = torch.where(oob, grid_z, map_z.clamp(0, Z - 1)).contiguous()
    return cz, cy, cx, oob


def warp(f2, u, v, w, f1, order=3, use_kernels=True):
    """Backward-warp ``f2`` by (u, v, w); OOB voxels come from ``f1``.

    Tensors on one device: f2/f1 (Z,Y,X) or (Z,Y,X,C), u/v/w (Z,Y,X)
    displacements in x/y/z voxel units.
    """
    squeeze = f2.dim() == 3
    if squeeze:
        f2 = f2[..., None]
        f1 = f1[..., None]
    C = f2.shape[-1]
    cz, cy, cx, oob = sample_coords(u, v, w)
    sample = {3: map_coordinates_cubic, 1: map_coordinates_linear}[order]
    warped = torch.stack(
        [sample(f2[..., c].contiguous(), cz, cy, cx, use_kernels)
         for c in range(C)], dim=-1)
    warped = torch.where(oob[..., None], f1.to(warped.dtype), warped)
    return warped[..., 0] if squeeze else warped


def imregister_wrapper(f2_level, u, v, w, f1_level,
                       interpolation_method="cubic", device=None,
                       use_kernels=True):
    """Backward-warp the moving volume by (u,v,w); OOB voxels from fixed.

    Shapes (Z,Y,X) or (Z,Y,X,C); u/v/w are (Z,Y,X) displacements in
    x/y/z voxel units; numpy arrays or tensors. ``device`` None means
    'cuda' (raises without CUDA). ``use_kernels=False`` runs the plain
    PyTorch sampling on any device (the reference the kernel is held to).
    """
    method = interpolation_method.lower()
    if method not in ("cubic", "linear"):
        raise ValueError("Unsupported interpolation method. Use 'linear' or 'cubic'.")
    dev = resolve_device(device)
    u = torch.as_tensor(u, device=dev)
    v, w, f2, f1 = (torch.as_tensor(a, device=dev).to(u.dtype)
                    for a in (v, w, f2_level, f1_level))
    return warp(f2, u, v, w, f1, 3 if method == "cubic" else 1, use_kernels)
