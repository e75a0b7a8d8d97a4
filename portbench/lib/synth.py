"""The general generator of the benchmark's inputs, on the device, from a seed.

A scene is a volume of Gaussian blobs per channel: each voxel holds a blob
centre with probability ``density``, of brightness uniform in [0.5, 1.5), and
the centres are blurred by a Gaussian of ``sigma_zyx`` voxels, then scaled to a
peak of 1. A frame is the scene moved by a smooth, non-rigid displacement: a
drift uniform in +-``drift_zyx`` voxels plus ``waves`` plane sine waves, each of
amplitude uniform in +-``deform_zyx`` voxels per axis, ``cycles`` periods over
the volume in a random direction and a random phase, sampled trilinearly, with
noise added. Every seed draws the same number of values of the same sizes, so
the work does not depend on the seed.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed, device):
    """A torch.Generator on ``device`` seeded with ``seed`` (any whole number
    up to 2**64 - 1)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def gauss_taps(sigma):
    """scipy.ndimage.gaussian_filter1d's taps (truncate 4)."""
    if sigma <= 0:
        return np.ones(1)
    r = int(4.0 * float(sigma) + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def blur(vol, sigma_zyx):
    """Separable Gaussian over the three trailing axes of ``vol``, edge sample
    repeated at the boundary, as weighted sums of shifted slices."""
    nd = vol.dim()
    for axis, s in zip((nd - 3, nd - 2, nd - 1), sigma_zyx):
        k = gauss_taps(s)
        if len(k) == 1:
            continue
        r = len(k) // 2
        n = vol.shape[axis]
        i = torch.arange(-r, n + r, device=vol.device) % (2 * n)
        i = torch.where(i >= n, 2 * n - 1 - i, i)
        xp = vol.index_select(axis, i)
        out = xp.narrow(axis, 0, n) * float(k[0])
        for j in range(1, len(k)):
            out = out + xp.narrow(axis, j, n) * float(k[j])
        vol = out
    return vol


def scene(g, shape, scene_spec):
    """(Z, Y, X, C) float32 blob volume on the generator's device."""
    dev = g.device
    chans = []
    for density, sigma in zip(scene_spec["density"], scene_spec["sigma_zyx"]):
        centres = torch.rand(shape, generator=g, device=dev) < density
        bright = torch.rand(shape, generator=g, device=dev) + 0.5
        vol = blur(torch.where(centres, bright, torch.zeros_like(bright)),
                   sigma)
        chans.append(vol / vol.max())
    return torch.stack(chans, dim=-1)


def displacement(g, shape, motion):
    """(Z, Y, X, 3) displacement in voxels, last axis [dx, dy, dz]."""
    dev = g.device
    Z, Y, X = shape
    drift = (torch.rand(3, generator=g, device=dev) * 2 - 1) * torch.tensor(
        motion["drift_zyx"], device=dev)
    grids = torch.meshgrid(*(torch.linspace(0, 1, n, device=dev)
                             for n in (Z, Y, X)), indexing="ij")
    disp = [torch.full(shape, 0.0, device=dev) + drift[k] for k in range(3)]
    lo, hi = motion["cycles"]
    amp_max = torch.tensor(motion["deform_zyx"], device=dev)
    for _ in range(int(motion["waves"])):
        direction = torch.randn(3, generator=g, device=dev)
        direction = direction / direction.norm()
        cycles = lo + (hi - lo) * torch.rand(1, generator=g, device=dev)
        phase = 2 * math.pi * torch.rand(1, generator=g, device=dev)
        amp = (torch.rand(3, generator=g, device=dev) * 2 - 1) * amp_max
        arg = 2 * math.pi * cycles * (direction[0] * grids[0]
                                      + direction[1] * grids[1]
                                      + direction[2] * grids[2]) + phase
        wave = torch.sin(arg)
        for k in range(3):
            disp[k] = disp[k] + amp[k] * wave
    dz, dy, dx = disp
    return torch.stack([dx, dy, dz], dim=-1)


def moved(vol, disp):
    """``vol`` (Z, Y, X, C) sampled at x + disp(x), trilinear, the edge
    sample repeated outside."""
    Z, Y, X, _ = vol.shape
    dev = vol.device
    gz, gy, gx = torch.meshgrid(*(torch.arange(n, device=dev,
                                               dtype=torch.float32)
                                  for n in (Z, Y, X)), indexing="ij")
    grid = torch.stack([2 * (gx + disp[..., 0]) / (X - 1) - 1,
                        2 * (gy + disp[..., 1]) / (Y - 1) - 1,
                        2 * (gz + disp[..., 2]) / (Z - 1) - 1], dim=-1)
    out = F.grid_sample(vol.permute(3, 0, 1, 2)[None], grid[None],
                        mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out[0].permute(1, 2, 3, 0)


def noisy(g, vol, sigma):
    return vol + sigma * torch.randn(vol.shape, generator=g, device=g.device)


def to_u16_on_host(frames):
    """A float tensor of camera counts as a host uint16 numpy array, rounded
    and clipped: cast to int32 on the device, downloaded as its low halves."""
    counts = frames.round().clamp(0, 65535).to(torch.int32).contiguous()
    low = counts.view(torch.int16).reshape(counts.shape + (2,))[..., 0]
    return low.contiguous().cpu().numpy().view(np.uint16)
