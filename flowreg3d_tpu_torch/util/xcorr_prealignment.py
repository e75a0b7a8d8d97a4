"""Rigid (dx, dy, dz) prealignment from phase correlation of projections.

Counterpart of ``flowreg3d_tpu/util/xcorr_prealignment.py``: collapse the
channels by weight, take the XY and XZ mean projections, downscale them to
``target_hw`` with the fused Gauss-cubic resize, subtract the mean, apply a
Hann window, then subpixel phase correlation with upsampling and
disambiguation; the result is ``-[dx, dy, dz]`` (the backward-warp
convention).

``estimate_rigid_xcorr_device`` (the JAX package's traced form) takes and
returns tensors and stays on their device, so the executors' cc prealign
(warp by w_init, this estimate, combine, warp again) never waits for the
host; ``estimate_rigid_xcorr_3d`` is the host-facing wrapper.
"""

from functools import lru_cache

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.ops.resize import resize_volume
from flowreg3d_tpu_torch.ops.xcorr import phase_xcorr_shift


def _collapse_channels(vol, weight_vec):
    """(Z,Y,X[,C]) -> (Z,Y,X) by weighted channel mean."""
    if vol.dim() == 3:
        return vol
    if vol.shape[3] == 1:
        return vol[..., 0]
    if weight_vec is None:
        return vol.mean(dim=3)
    w = weight_vec.to(vol.dtype).reshape(-1)
    return torch.tensordot(vol, w / w.sum(), dims=([3], [0]))


@lru_cache(maxsize=64)
def _hann(n, device):
    return torch.as_tensor(np.hanning(n).astype(np.float32)).to(device)


def _windowed(img):
    img = img.to(torch.float32)
    img = img - img.mean()
    h0, h1 = (_hann(n, img.device) for n in img.shape)
    return img * (h0[:, None] * h1[None, :])


def _resize2d(img, out_hw):
    return resize_volume(img[None, ...], (1, out_hw[0], out_hw[1]),
                         per_axis=True)[0]


def estimate_rigid_xcorr_device(ref_vol, mov_vol, target_hw=(256, 256),
                                target_z=None, up=10, normalization="phase",
                                disambiguate=True, weight_vec=None):
    """Rigid-shift estimate of (Z,Y,X) or (Z,Y,X,C) tensors on one device;
    ``weight_vec`` an optional (C,) tensor of channel weights. Returns
    ``-[dx, dy, dz]``, a (3,) float32 tensor on that device."""
    ref_vol = _collapse_channels(ref_vol, weight_vec)
    mov_vol = _collapse_channels(mov_vol, weight_vec)

    Z, H, W = ref_vol.shape
    Th = H if target_hw is None else min(H, int(target_hw[0]))
    Tw = W if target_hw is None else min(W, int(target_hw[1]))
    sy, sx = H / Th, W / Tw

    pxy_r = ref_vol.mean(dim=0)
    pxy_m = mov_vol.mean(dim=0)
    if (Th, Tw) != (H, W):
        pxy_r = _resize2d(pxy_r, (Th, Tw))
        pxy_m = _resize2d(pxy_m, (Th, Tw))
    s_xy = phase_xcorr_shift(_windowed(pxy_r), _windowed(pxy_m),
                             upsample_factor=int(up),
                             normalization=normalization,
                             disambiguate=bool(disambiguate))
    dy = s_xy[0] * sy
    dx = s_xy[1] * sx

    Tz = Z if target_z is None else min(Z, int(target_z))
    sz = Z / Tz
    pxz_r = ref_vol.mean(dim=1)
    pxz_m = mov_vol.mean(dim=1)
    if Tz != Z or Tw != W:
        pxz_r = _resize2d(pxz_r, (Tz, Tw))
        pxz_m = _resize2d(pxz_m, (Tz, Tw))
    s_xz = phase_xcorr_shift(_windowed(pxz_r), _windowed(pxz_m),
                             upsample_factor=int(up),
                             normalization=normalization,
                             disambiguate=bool(disambiguate))
    dz = s_xz[0] * sz

    return -torch.stack([dx, dy, dz]).to(torch.float32)


def estimate_rigid_xcorr_3d(ref_vol, mov_vol, target_hw=(256, 256),
                            target_z=None, up=10, normalization="phase",
                            disambiguate=True, weight=None, device=None):
    """The rigid shift of ``mov_vol`` relative to ``ref_vol`` (arrays or
    tensors, (Z,Y,X) or (Z,Y,X,C)) as ``-[dx, dy, dz]`` float32 numpy: the
    backward-warp displacement that maps moving onto reference.
    ``device`` None means 'cuda'."""
    dev = resolve_device(device)
    ref_t, mov_t = (torch.as_tensor(np.asarray(v, np.float32), device=dev)
                    for v in (ref_vol, mov_vol))
    wvec = None
    if ref_t.dim() == 4 and ref_t.shape[3] > 1 and weight is not None:
        wvec = torch.as_tensor(np.asarray(weight, np.float32).reshape(-1),
                               device=dev)
    if isinstance(target_hw, int):
        target_hw = (target_hw, target_hw)
    return estimate_rigid_xcorr_device(
        ref_t, mov_t, target_hw=target_hw, target_z=target_z, up=up,
        normalization=normalization, disambiguate=disambiguate,
        weight_vec=wvec).cpu().numpy()
