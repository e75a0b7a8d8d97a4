"""Subpixel phase cross-correlation with ``torch.fft``.

Counterpart of ``flowreg3d_tpu/ops/xcorr.py`` (skimage's
``phase_cross_correlation``): the cross-power spectrum (optionally
phase-normalised), the coarse peak of its inverse FFT, then the
Guizar-Sicairos upsampled-DFT refinement as two small complex matrix
products, and an optional real-space disambiguation of the n-periodic
shift (skimage's ``disambiguate=True``). ``phase_xcorr_shift`` stays on the
tensors' device: the peaks are found with ``argmax`` and the candidate
shifts applied by index gathers, so it never waits for the host.
"""

import math

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device


def _upsampled_dft_2d(data, region, up, offsets):
    """Upsampled inverse DFT of the (H, W) spectrum ``data`` over a
    (rh, rw) region starting at ``offsets`` (a (2,) tensor)."""
    H, W = data.shape
    rh, rw = region

    def kernel(n, r, offset):
        freqs = torch.fft.fftfreq(n, device=data.device) * n
        samples = torch.arange(r, dtype=torch.float32,
                               device=data.device) - offset
        return torch.exp((-2j * math.pi / (n * up))
                         * samples[:, None] * freqs[None, :])

    kr = kernel(H, rh, offsets[0])
    kc = kernel(W, rw, offsets[1])
    return kr @ data @ kc.T


def _unravel(flat, width):
    """(row, col) of a flat index, as float32."""
    return torch.stack([torch.div(flat, width, rounding_mode="floor"),
                        flat % width]).to(torch.float32)


def _phase_xcorr_core(ref, mov, upsample_factor=1, normalization="phase"):
    H, W = ref.shape
    F1 = torch.fft.fft2(ref)
    F2 = torch.fft.fft2(mov)
    R = F1 * torch.conj(F2)
    if normalization == "phase":
        R = R / torch.clamp(torch.abs(R), min=1e-20)

    cc = torch.fft.ifft2(R)
    peak = _unravel(torch.argmax(torch.abs(cc)), W)
    shift = torch.stack([torch.where(p > n / 2.0, p - n, p)
                         for p, n in zip(peak, (H, W))])

    if upsample_factor > 1:
        up = float(upsample_factor)
        shift = torch.round(shift * up) / up
        region = int(np.ceil(up * 1.5))
        dftshift = float(np.fix(region / 2.0))
        offsets = dftshift - shift * up
        cc_up = torch.conj(_upsampled_dft_2d(torch.conj(R), (region, region),
                                             up, offsets))
        peak_up = _unravel(torch.argmax(torch.abs(cc_up)), region)
        shift = shift + (peak_up - dftshift) / up
    return shift


def _roll_rows_cols(x, sr, sc):
    """``x`` rolled by the integer tensors (sr, sc) along (rows, cols), by
    index gathers (no host read of the shifts)."""
    H, W = x.shape
    rows = (torch.arange(H, device=x.device) - sr) % H
    cols = (torch.arange(W, device=x.device) - sc) % W
    return x.index_select(0, rows).index_select(1, cols)


def _overlap_corr(ref, mov, sr, sc):
    """Pearson correlation of ref with mov rolled by (sr, sc) on the overlap
    of the two; -inf where the overlap is thinner than 2."""
    H, W = ref.shape
    rows = torch.arange(H, device=ref.device)[:, None]
    cols = torch.arange(W, device=ref.device)[None, :]
    mov_sh = _roll_rows_cols(mov, sr, sc)
    valid = ((rows >= torch.clamp(sr, min=0))
             & (rows < H + torch.clamp(sr, max=0))
             & (cols >= torch.clamp(sc, min=0))
             & (cols < W + torch.clamp(sc, max=0)))
    cnt = torch.clamp(valid.sum(), min=1).to(ref.dtype)
    validf = valid.to(ref.dtype)
    am = (ref * validf).sum() / cnt
    bm = (mov_sh * validf).sum() / cnt
    a = (ref - am) * validf
    b = (mov_sh - bm) * validf
    denom = torch.sqrt((a * a).sum() * (b * b).sum())
    score = torch.where(denom > 0, (a * b).sum() / denom,
                        torch.full_like(denom, -math.inf))
    too_small = ((H - torch.abs(sr)) < 2) | ((W - torch.abs(sc)) < 2)
    return torch.where(too_small, torch.full_like(score, -math.inf), score)


def _disambiguate(ref, mov, shift):
    """The best of the four candidate shifts (s mod n, s mod n - n per axis)
    by the real-space correlation of the overlapping regions."""
    H, W = ref.shape
    cr = torch.stack([shift[0] % H, (shift[0] % H) - H])
    cc = torch.stack([shift[1] % W, (shift[1] % W) - W])
    # (r0, r0, r1, r1) and (c0, c1, c0, c1) by views: an index list would
    # be uploaded from the host, which a CUDA-graph capture refuses
    cand_r = cr[:, None].expand(2, 2).reshape(4)
    cand_c = cc[None, :].expand(2, 2).reshape(4)
    scores = torch.stack([
        _overlap_corr(ref, mov, torch.round(cand_r[k]).to(torch.int64),
                      torch.round(cand_c[k]).to(torch.int64))
        for k in range(4)])
    # gathered at a one-element index: a 0-d index tensor would be read on
    # the host
    best = torch.argmax(scores).reshape(1)
    return torch.cat([cand_r.index_select(0, best),
                      cand_c.index_select(0, best)])


def phase_xcorr_shift(ref, mov, upsample_factor=1, normalization="phase",
                      disambiguate=False):
    """Shift (row, col), a (2,) float32 tensor on the inputs' device, that
    registers ``mov`` onto ``ref`` (two (H, W) tensors)."""
    ref = ref.to(torch.float32)
    mov = mov.to(torch.float32)
    shift = _phase_xcorr_core(ref, mov, upsample_factor=int(upsample_factor),
                              normalization=normalization)
    if disambiguate:
        shift = _disambiguate(ref, mov, shift)
    return shift


def phase_cross_correlation(reference_image, moving_image, upsample_factor=1,
                            normalization="phase", disambiguate=False,
                            device=None):
    """Shift (row, col) that registers moving_image onto reference_image
    (skimage's convention: reference ~ shift(moving, +shift)). Returns
    (shift, error, phasediff); the last two are placeholders, as in the
    JAX package. ``device`` None means 'cuda'."""
    dev = resolve_device(device)
    ref, mov = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                for a in (reference_image, moving_image))
    shift = phase_xcorr_shift(ref, mov, upsample_factor=int(upsample_factor),
                              normalization=normalization,
                              disambiguate=bool(disambiguate))
    return shift.cpu().numpy(), 0.0, 0.0
