"""The plain reference of the cc prealignment, and of a recording registered
under it (``OFOptions(cc_initialization=True)``).

The published method (flowreg3D ``core/optical_flow_3d.py:91-145``; the
phase correlation is Guizar-Sicairos, Thurman and Fienup, Opt. Lett. 33(2),
2008, as skimage's ``phase_cross_correlation`` has it): each frame is
aligned rigidly to the reference before the variational solve, which then
solves only the non-rigid residual.

- The rigid shift of a moving volume against the reference: the channels
  collapsed by the normalised weight vector; the XY and XZ mean projections;
  each downscaled to ``cc_hw`` (XY) and to ``cc_hw[1]`` wide (XZ, all planes
  kept) by the fused Gaussian + Keys-cubic resize with a sigma per axis; the
  mean removed and a Hann window applied; the phase-normalised cross-power
  spectrum, its inverse FFT's peak, refined to 1/``cc_up`` pixel by the
  upsampled DFT over a 1.5-pixel region (two complex matrix products), and
  the period disambiguated; the projections' shifts scaled back to voxels.
  The result is ``-[dx, dy, dz]``, the backward-warp displacement.
- A frame: (1) the preprocessed frame warped trilinearly by ``w_init``; (2)
  the rigid shift of that against the preprocessed reference; (3)
  ``w_combined = w_init + shift``; (4) the preprocessed frame warped
  trilinearly by ``w_combined``; (5) the flow of that aligned frame from a
  zero flow (``plain.flow``); (6) the total flow, flow + ``w_combined``; (7)
  the raw frame warped back by the total flow, cubic, rounded and clipped to
  the input's integer type.
- A recording (``check_frames_cc``): batch 0 starts from a zero flow (there
  is no initial-flow pass under cc); batch k > 0 from the mean of the total
  flows of the last <= 20 frames of batch k - 1.

Departures from the published method:

- The disambiguation of the n-periodic peak picks, of the four candidates
  (s mod n or s mod n - n along each axis), the one whose overlap of the
  reference and the moving image, rolled by the candidate rounded to whole
  pixels, correlates best (Pearson); an overlap of 2 rows or columns is
  enough to compete. skimage shifts the moving image by the subpixel
  estimate and compares the tiles of the positive and negative splits (of
  more than 2 pixels). The two pick alike for any shift well inside half a
  period whose overlap correlates better than the thin wrapped strip of the
  other candidate; a strip of a Hann-windowed image can correlate near 1,
  since the window's own profile dominates it, and then both pick the strip.
- The program collapses the channels by their plain mean: its pipeline hands
  the executor a weight volume, not a vector. For the configuration's equal
  weights the two agree bit for bit.

Every operation is float32 and in the order of the program's own, so that
the two agree bit for bit on one device: the chosen peaks are discrete, and
in the configuration's regime a one-ulp change of an input moves the flow by
pixels. ``mm`` is the precision of every matrix product, the resizes' and
the upsampled DFT's complex ones: ``plain.fp32_matmul`` (TF32 off) or
``plain.tf32_matmul``, the control.
"""

import math

import numpy as np
import torch

from portbench.reference import plain
from portbench.reference.pipeline import (batch_ranges, gaussian, normalize,
                                          preprocess)


def cmatmul(a, b, mm=plain.fp32_matmul):
    """The complex product ``a @ b`` (complex64): float32 products and sums,
    TF32 off; under ``plain.tf32_matmul`` the real and imaginary parts of
    both operands are first rounded to TF32, as tensor cores round them."""
    if mm is plain.tf32_matmul:
        a, b = (torch.complex(plain.to_tf32(x.resolve_conj().real),
                              plain.to_tf32(x.resolve_conj().imag))
                for x in (a, b))
    return plain.fp32_matmul(a, b)


def resize_per_axis(vol, out_size, mm, sigma_coeff=0.6):
    """``plain.resize_volume`` with the anti-alias sigma taken per axis
    (``sigma_coeff`` over that axis's scale where it shrinks, else none):
    the three products x, y, z of (Z,Y,X) to ``out_size``. The pyramid's
    resize takes the smallest scale's sigma on every axis, which would blur
    the planes the XZ projection keeps."""
    x = vol.to(torch.float32)[..., None]
    Z, Y, X, C = x.shape
    od, oh, ow = (int(s) for s in out_size)
    rz, ry, rx = (plain._resize_matrix(
        n, m, sigma_coeff / (m / n) if m < n else 0.0, x.device)
        for n, m in ((Z, od), (Y, oh), (X, ow)))
    x = mm(x.permute(0, 1, 3, 2).reshape(Z * Y * C, X), rx.T)
    x = x.reshape(Z, Y, C, ow).permute(0, 1, 3, 2)
    x = mm(ry, x.reshape(Z, Y, ow * C))
    x = mm(rz, x.reshape(Z, oh * ow * C))
    return x.reshape(od, oh, ow, C)[..., 0]


def resize_plane(img, out_hw, mm):
    """A 2-D (H, W) image resized to ``out_hw``, as a volume of one plane."""
    return resize_per_axis(img[None], (1,) + tuple(out_hw), mm)[0]


def windowed(img):
    """The image less its mean, times a separable Hann window."""
    img = img.to(torch.float32)
    img = img - img.mean()
    h0, h1 = (torch.as_tensor(np.hanning(n).astype(np.float32))
              .to(img.device) for n in img.shape)
    return img * (h0[:, None] * h1[None, :])


def _peak(cc, width):
    """(row, col) of the largest magnitude of ``cc``, float32."""
    row, col = divmod(int(torch.argmax(torch.abs(cc))), width)
    return torch.tensor([row, col], dtype=torch.float32, device=cc.device)


def _dft_kernel(n, r, offset, up, device):
    """(r, n): exp(-2 pi i (sample - offset) freq / (n up)) over the
    region's samples and the spectrum's frequencies."""
    freqs = torch.fft.fftfreq(n, device=device) * n
    samples = torch.arange(r, dtype=torch.float32, device=device) - offset
    return torch.exp((-2j * math.pi / (n * up))
                     * samples[:, None] * freqs[None, :])


def phase_shift(ref, mov, up, mm=plain.fp32_matmul):
    """(row, col) float32 shift that registers ``mov`` onto ``ref`` (two
    (H, W) images): the phase correlation's peak, refined by the upsampled
    DFT to 1/``up`` pixel."""
    H, W = ref.shape
    R = torch.fft.fft2(ref) * torch.conj(torch.fft.fft2(mov))
    R = R / torch.clamp(torch.abs(R), min=1e-20)
    peak = _peak(torch.fft.ifft2(R), W)
    shift = torch.stack([torch.where(p > n / 2.0, p - n, p)
                         for p, n in zip(peak, (H, W))])
    if up <= 1:
        return shift
    up = float(up)
    shift = torch.round(shift * up) / up
    region = int(np.ceil(up * 1.5))
    centre = float(np.fix(region / 2.0))
    offsets = centre - shift * up
    kr = _dft_kernel(H, region, offsets[0], up, ref.device)
    kc = _dft_kernel(W, region, offsets[1], up, ref.device)
    cc_up = torch.conj(cmatmul(cmatmul(kr, torch.conj(R), mm), kc.T, mm))
    return shift + (_peak(cc_up, region) - centre) / up


def _overlap_corr(ref, mov, sr, sc):
    """Pearson correlation of ``ref`` and ``mov`` rolled by whole pixels
    (sr, sc), over the rows and columns the roll does not wrap (a mask over
    the whole image, float32); -inf where that overlap is thinner than 2 or
    flat."""
    H, W = ref.shape
    if H - abs(sr) < 2 or W - abs(sc) < 2:
        return -math.inf
    rolled = torch.roll(mov, (sr, sc), dims=(0, 1))
    valid = torch.zeros((H, W), dtype=ref.dtype, device=ref.device)
    valid[max(sr, 0):H + min(sr, 0), max(sc, 0):W + min(sc, 0)] = 1
    count = valid.sum()
    a = (ref - (ref * valid).sum() / count) * valid
    b = (rolled - (rolled * valid).sum() / count) * valid
    denom = torch.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else -math.inf


def disambiguate(ref, mov, shift):
    """The candidate shift, s mod n or s mod n - n along each axis, whose
    whole-pixel roll correlates best on the overlap (the first of equals, in
    the order (r0, c0), (r0, c1), (r1, c0), (r1, c1))."""
    H, W = ref.shape
    cand_r = [shift[0] % H, (shift[0] % H) - H]
    cand_c = [shift[1] % W, (shift[1] % W) - W]
    pairs = [(r, c) for r in cand_r for c in cand_c]
    scores = [_overlap_corr(ref, mov, int(torch.round(r)), int(torch.round(c)))
              for r, c in pairs]
    return torch.stack(pairs[scores.index(max(scores))])


def rigid_shift(ref_vol, mov_vol, weight, cc_hw, cc_up, mm=plain.fp32_matmul):
    """``-[dx, dy, dz]`` (a (3,) float32 tensor) that maps ``mov_vol`` onto
    ``ref_vol`` rigidly, two (Z,Y,X,C) volumes; ``weight`` the channels'
    weights."""
    C = ref_vol.shape[-1]
    w = np.asarray(weight, np.float32).reshape(-1)[:C]
    w = torch.as_tensor(w / w.sum()).to(ref_vol.device)
    ref, mov = ((v * w).sum(dim=-1) for v in (ref_vol, mov_vol))
    Z, H, W = ref.shape
    Th, Tw = min(H, int(cc_hw[0])), min(W, int(cc_hw[1]))
    projections = []
    for axis, size in ((0, (Th, Tw)), (1, (Z, Tw))):
        a, b = ref.mean(dim=axis), mov.mean(dim=axis)
        if tuple(a.shape) != size:
            a, b = resize_plane(a, size, mm), resize_plane(b, size, mm)
        a, b = windowed(a), windowed(b)
        projections.append(disambiguate(a, b, phase_shift(a, b, cc_up, mm)))
    s_xy, s_xz = projections
    dy, dx = s_xy[0] * (H / Th), s_xy[1] * (W / Tw)
    dz = s_xz[0]
    return -torch.stack([dx, dy, dz]).to(torch.float32)


def register_frame(raw, proc, ref_raw, ref_proc, w_init, wvol, params, weight,
                   cc_hw, cc_up, mm=plain.fp32_matmul):
    """Steps 1-7 of one frame: (total flow (Z,Y,X,3), registered float32
    (Z,Y,X,C), unrounded); ``raw`` and ``proc`` the frame raw and
    preprocessed, ``w_init`` the batch's initial flow."""
    partial = plain.warp(proc, w_init[..., 0], w_init[..., 1],
                         w_init[..., 2], ref_proc, mm, 1)
    combined = w_init + rigid_shift(ref_proc, partial, weight, cc_hw, cc_up,
                                    mm)
    aligned = plain.warp(proc, combined[..., 0], combined[..., 1],
                         combined[..., 2], ref_proc, mm, 1)
    residual = plain.flow(ref_proc, aligned, torch.zeros_like(combined),
                          wvol, params, mm)
    total = residual + combined
    reg = plain.warp(raw, total[..., 0], total[..., 1], total[..., 2],
                     ref_raw, mm, 3)
    return total, reg


def check_frames_cc(frames, reference, program_flows, sample, params, weight,
                    sigma, buffer_size, device, mm=plain.fp32_matmul,
                    cc_hw=(256, 256), cc_up=10):
    """``reference/pipeline.check_frames`` under cc: the reference's (total
    flow, registered float64) of each frame in ``sample``. Batch 0 starts
    from a zero flow; a frame of batch k > 0 from the mean of the program's
    total flows (``program_flows``, numpy (T,Z,Y,X,3)) over the last <= 20
    frames of batch k - 1, which the comparison follows."""
    info = np.iinfo(frames.dtype)
    ref_raw = torch.as_tensor(np.asarray(reference, np.float32)).to(device)
    ref_proc = gaussian(normalize(ref_raw, ref_raw), sigma)
    Z, Y, X, C = ref_raw.shape
    wvol = plain.weight_volume(weight, (Z, Y, X), C, device)
    ranges = batch_ranges(frames.shape[0], buffer_size)
    out = {}
    for t in sorted(sample):
        k = next(i for i, (a, b) in enumerate(ranges) if a <= t < b)
        a, b = ranges[k]
        raw = torch.as_tensor(frames[a:b].astype(np.float32)).to(device)
        proc = preprocess(raw, ref_raw, sigma)
        if k == 0:
            w_init = torch.zeros((Z, Y, X, 3), dtype=torch.float32,
                                 device=device)
        else:
            pa, pb = ranges[k - 1]
            w_init = torch.as_tensor(
                program_flows[pa:pb]).to(device)[-20:].mean(dim=0)
        total, reg = register_frame(raw[t - a], proc[t - a], ref_raw,
                                    ref_proc, w_init, wvol, params, weight,
                                    cc_hw, cc_up, mm)
        reg = torch.clamp(torch.round(reg), info.min, info.max)
        out[t] = (total, reg.to(torch.float64))
        del raw, proc
    return out
