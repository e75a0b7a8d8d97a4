"""Synthetic ground-truth 3D displacement fields.

Counterpart of ``flowreg3d_tpu/motion_generation/motion_generators.py``:
six flow augmentors (rotation, translation, scan jitter, expansion, random
smooth, shear) composed by ``FlowGenerator3D``, four presets, a forward
volume warp by trilinear splatting and a backward warp.

- The augmentors, the generator and the presets are the JAX package's
  code unchanged: host numpy drawing from an explicit
  ``numpy.random.Generator`` (``rng`` argument), so one seed gives the JAX
  package's fields and masks bit for bit.
- ``warp_volume_splat3d`` (the splat the reference's own example harness
  uses in place of ``scipy.interpolate.griddata``) scatters in float64 on
  the device; ``warp_volume_backward`` is the port's ``imregister_wrapper``.
  Both take ``device=None``, meaning 'cuda'; numpy in, numpy out.

Flow layout: (Z, Y, X, 3) with last axis [dx, dy, dz].
"""

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.ops.warp import imregister_wrapper


def _as_rng(rng):
    if rng is None:
        return np.random.default_rng()
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(int(rng))
    return rng


def _centered_grids(shape, center):
    p, m, n = shape
    Z, Y, X = np.meshgrid(
        np.arange(p, dtype=np.float32) - center[0],
        np.arange(m, dtype=np.float32) - center[1],
        np.arange(n, dtype=np.float32) - center[2],
        indexing="ij",
    )
    return Z, Y, X


class Rotational3DFlowAugmentor:
    """Rigid rotational flow about the (jittered) volume center.

    Parity: reference motion_generators.py:69-152. Rotation planes: 'xy'
    (about Z), 'xz' (about Y), 'yz' (about X), composed in that order.
    """

    def __init__(self, max_rot_deg=10, center=None, p=0.2, center_jitter=5,
                 axes=("xy", "xz", "yz")):
        self.max_rot_deg = max_rot_deg
        self.center = center
        self.p = p
        self.center_jitter = center_jitter
        self.axes = axes

    def __call__(self, flow, rng=None):
        rng = _as_rng(rng)
        if rng.random() > self.p:
            return flow
        shape = flow.shape[:3]
        center = (np.asarray(self.center, np.float64) if self.center is not None
                  else np.array(shape, np.float64) / 2.0)
        center = center + rng.uniform(-self.center_jitter, self.center_jitter, 3)
        Z, Y, X = _centered_grids(shape, center)

        Xr, Yr, Zr = X.copy(), Y.copy(), Z.copy()
        for plane in ("xy", "xz", "yz"):
            if plane not in self.axes:
                continue
            ang = np.radians(rng.uniform(-self.max_rot_deg, self.max_rot_deg))
            c, s = np.cos(ang), np.sin(ang)
            if plane == "xy":
                Xr, Yr = c * Xr - s * Yr, s * Xr + c * Yr
            elif plane == "xz":
                Xr, Zr = c * Xr - s * Zr, s * Xr + c * Zr
            else:
                Yr, Zr = c * Yr - s * Zr, s * Yr + c * Zr

        flow[..., 0] += Xr - X
        flow[..., 1] += Yr - Y
        flow[..., 2] += Zr - Z
        return flow


class Translational3DFlowAugmentor:
    """Uniform rigid translation (reference motion_generators.py:155-180)."""

    def __init__(self, max_disp=10, p=0.3):
        self.max_disp = max_disp
        self.p = p

    def __call__(self, flow, rng=None):
        rng = _as_rng(rng)
        if rng.random() > self.p:
            return flow
        dz, dy, dx = rng.uniform(-self.max_disp, self.max_disp, 3)
        flow[..., 0] += dx
        flow[..., 1] += dy
        flow[..., 2] += dz
        return flow


class Jitter3DFlowAugmentor:
    """Sinusoidal scan-artifact jitter (reference motion_generators.py:183-233).

    Mirrors the reference's component mapping, including its quirk that the
    x-axis wave perturbs the dz component (:219-221).
    """

    def __init__(self, max_magnitude=2, max_periods=5, min_periods=2, p=0.9,
                 axes=("x", "y", "z")):
        self.max_magnitude = max_magnitude
        self.max_periods = max_periods
        self.min_periods = min_periods
        self.p = p
        self.axes = axes

    def __call__(self, flow, rng=None):
        rng = _as_rng(rng)
        if rng.random() > self.p:
            return flow
        p, m, n = flow.shape[:3]
        axis_len = {"x": n, "y": m, "z": p}
        # (component index, broadcast shape) per axis
        axis_comp = {"x": 2, "y": 1, "z": 2}
        for axis in self.axes:
            if rng.random() >= 0.5:
                continue
            periods = rng.uniform(self.min_periods, self.max_periods)
            phase = rng.uniform(0, 2 * np.pi)
            magnitude = rng.uniform(1, self.max_magnitude)
            wave = magnitude * np.sin(
                np.linspace(phase, periods * 2 * np.pi + phase, axis_len[axis]))
            comp = axis_comp[axis]
            if axis == "x":
                flow[..., comp] += wave[None, None, :]
            elif axis == "y":
                flow[..., comp] += wave[None, :, None]
            else:
                flow[..., comp] += wave[:, None, None]
        return flow


class Expansion3DFlowAugmentor:
    """Anisotropic expansion/contraction about a jittered center.

    Parity: reference motion_generators.py:236-301.
    """

    def __init__(self, max_magnitude=0.05, min_magnitude=None, center=None,
                 center_jitter=5, p=0.4, anisotropic=True):
        self.max_magnitude = max_magnitude
        self.min_magnitude = (-max_magnitude if min_magnitude is None
                              else min_magnitude)
        self.center = center
        self.center_jitter = center_jitter
        self.p = p
        self.anisotropic = anisotropic

    def __call__(self, flow, rng=None):
        rng = _as_rng(rng)
        if rng.random() > self.p:
            return flow
        shape = flow.shape[:3]
        center = (np.asarray(self.center, np.float64) if self.center is not None
                  else np.array(shape, np.float64) / 2.0)
        center = center + rng.uniform(-self.center_jitter, self.center_jitter, 3)
        if self.anisotropic:
            mz, my, mx = rng.uniform(self.min_magnitude, self.max_magnitude, 3)
        else:
            mz = my = mx = rng.uniform(self.min_magnitude, self.max_magnitude)
        Z, Y, X = _centered_grids(shape, center)
        flow[..., 0] += X * mx
        flow[..., 1] += Y * my
        flow[..., 2] += Z * mz
        return flow


class Random3DFlowAugmentor:
    """Smooth random flow: Gaussian-filtered white noise, standardized then
    scaled to a random magnitude (reference motion_generators.py:304-346)."""

    def __init__(self, p=0.3, min_sigma=2, max_sigma=10, max_magnitude=3):
        self.p = p
        self.min_sigma = min_sigma
        self.max_sigma = max_sigma
        self.max_magnitude = max_magnitude

    def __call__(self, flow, rng=None):
        rng = _as_rng(rng)
        if rng.random() > self.p:
            return flow
        shape = flow.shape[:3]
        noise = rng.standard_normal(shape + (3,))
        sigma = rng.uniform(self.min_sigma, self.max_sigma)
        for i in range(3):
            noise[..., i] = gaussian_filter(noise[..., i], sigma=sigma)
        noise -= noise.mean(axis=(0, 1, 2), keepdims=True)
        std = noise.std(axis=(0, 1, 2), keepdims=True)
        std[std == 0] = 1.0
        noise /= std
        noise *= rng.uniform(0, self.max_magnitude)
        flow += noise
        return flow


class Shear3DFlowAugmentor:
    """Planar shear fields (reference motion_generators.py:349-392)."""

    def __init__(self, max_shear=0.1, p=0.3, planes=("xy", "xz", "yz")):
        self.max_shear = max_shear
        self.p = p
        self.planes = planes

    def __call__(self, flow, rng=None):
        rng = _as_rng(rng)
        if rng.random() > self.p:
            return flow
        p, m, n = flow.shape[:3]
        Z, Y, X = np.meshgrid(
            np.arange(p, dtype=np.float32),
            np.arange(m, dtype=np.float32),
            np.arange(n, dtype=np.float32),
            indexing="ij",
        )
        for plane in self.planes:
            if rng.random() >= 0.5:
                continue
            shear = rng.uniform(-self.max_shear, self.max_shear)
            if plane == "xy":
                flow[..., 0] += shear * Y
            elif plane == "xz":
                flow[..., 0] += shear * Z
            else:
                flow[..., 1] += shear * Z
        return flow


class FlowGenerator3D:
    """Composes augmentors into a ground-truth flow + invalid-region mask.

    Parity: reference motion_generators.py:395-449. ``rng`` (Generator or
    int seed) makes generation deterministic.
    """

    def __init__(self, augmentors=None):
        self.augmentors = list(augmentors) if augmentors else []

    def add_augmentor(self, augmentor):
        self.augmentors.append(augmentor)
        return self

    def __call__(self, depth=64, height=128, width=128, rng=None):
        rng = _as_rng(rng)
        flow = np.zeros((depth, height, width, 3), dtype=np.float32)
        for augmentor in self.augmentors:
            flow = augmentor(flow, rng=rng)
        Z, Y, X = np.meshgrid(
            np.arange(depth, dtype=np.float32),
            np.arange(height, dtype=np.float32),
            np.arange(width, dtype=np.float32),
            indexing="ij",
        )
        invalid = (
            (Z + flow[..., 2] < 0) | (Z + flow[..., 2] >= depth)
            | (Y + flow[..., 1] < 0) | (Y + flow[..., 1] >= height)
            | (X + flow[..., 0] < 0) | (X + flow[..., 0] >= width)
        )
        return flow, invalid


def warp_volume_splat3d(volume, flow, device=None):
    """Forward-warp by trilinear splatting (scatter-add with weight renorm).

    Each source voxel deposits its value at ``x + flow(x)`` over the 8
    surrounding grid nodes; accumulated values are divided by accumulated
    weights. Voxels mapped outside the grid and zero-weight corners are
    dropped; nodes whose weight is not above 1e-12 are 0.

    numpy in, numpy out, as in the JAX package; the scatter runs in
    float64 on ``device`` (None means 'cuda') with ``index_add_`` into flat
    accumulators, so its summation order is the device's (CUDA atomics),
    not ``np.add.at``'s. Floating input keeps its dtype; other input comes
    back as float64.
    """
    vol = np.asarray(volume)
    dev = resolve_device(device)
    has_c = vol.ndim == 4
    v = vol if has_c else vol[..., None]
    Zd, Yd, Xd, C = v.shape
    f = torch.as_tensor(np.asarray(flow)).to(device=dev, dtype=torch.float64)

    def axis(n, shape):
        return torch.arange(n, dtype=torch.float64, device=dev).reshape(shape)

    tz = (axis(Zd, (Zd, 1, 1)) + f[..., 2]).reshape(-1)
    ty = (axis(Yd, (1, Yd, 1)) + f[..., 1]).reshape(-1)
    tx = (axis(Xd, (1, 1, Xd)) + f[..., 0]).reshape(-1)
    del f
    z0, y0, x0 = (torch.floor(t) for t in (tz, ty, tx))
    fz, fy, fx = tz - z0, ty - y0, tx - x0
    z0, y0, x0 = (t.to(torch.int64) for t in (z0, y0, x0))
    del tz, ty, tx

    vals = torch.as_tensor(np.ascontiguousarray(v)).to(
        device=dev, dtype=torch.float64).reshape(-1, C)
    acc = torch.zeros((Zd * Yd * Xd, C), dtype=torch.float64, device=dev)
    wacc = torch.zeros(Zd * Yd * Xd, dtype=torch.float64, device=dev)

    for dz in (0, 1):
        wz = fz if dz else 1.0 - fz
        zz = z0 + dz
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            yy = y0 + dy
            for dx in (0, 1):
                wx = fx if dx else 1.0 - fx
                xx = x0 + dx
                wgt = wz * wy * wx
                ok = ((zz >= 0) & (zz < Zd) & (yy >= 0) & (yy < Yd)
                      & (xx >= 0) & (xx < Xd) & (wgt > 0))
                lin = ((zz[ok] * Yd + yy[ok]) * Xd + xx[ok])
                w_ok = wgt[ok]
                wacc.index_add_(0, lin, w_ok)
                acc.index_add_(0, lin, vals[ok] * w_ok[:, None])

    nz = wacc > 1e-12
    out = torch.where(nz[:, None], acc / torch.where(nz, wacc, 1.0)[:, None],
                      torch.zeros((), dtype=torch.float64, device=dev))
    out = out.reshape(Zd, Yd, Xd, C).cpu().numpy()
    if not has_c:
        out = out[..., 0]
    if np.issubdtype(vol.dtype, np.floating):
        return out.astype(vol.dtype)
    return out


# The griddata-based reference entry point maps to splatting here (same
# forward-warp semantics, tractable cost); see module docstring.
warp_volume_3d = warp_volume_splat3d


def warp_volume_backward(volume, flow, interpolation_method="linear",
                         device=None, use_kernels=True):
    """Backward-warp ``volume`` by ``flow`` on ``device`` (None means
    'cuda'): displaced(x) = volume(x + flow(x)), out-of-grid voxels from
    ``volume`` itself; the port's ``imregister_wrapper`` (the
    ``map_coords_f32`` kernel on CUDA with ``use_kernels``). float32 numpy
    out."""
    v = np.asarray(volume, np.float32)
    f = np.asarray(flow, np.float32)
    out = imregister_wrapper(v, f[..., 0], f[..., 1], f[..., 2], v,
                             interpolation_method=interpolation_method,
                             device=device, use_kernels=use_kernels)
    return out.cpu().numpy()


def get_default_3d_generator():
    """Preset parity: reference motion_generators.py:452-462."""
    return FlowGenerator3D([
        Rotational3DFlowAugmentor(max_rot_deg=5),
        Translational3DFlowAugmentor(max_disp=10),
        Random3DFlowAugmentor(),
        Expansion3DFlowAugmentor(),
        Jitter3DFlowAugmentor(),
        Shear3DFlowAugmentor(),
    ])


def get_low_disp_3d_generator():
    """Preset parity: reference motion_generators.py:465-476."""
    return FlowGenerator3D([
        Translational3DFlowAugmentor(max_disp=5),
        Rotational3DFlowAugmentor(max_rot_deg=2),
        Random3DFlowAugmentor(max_magnitude=1.5),
        Expansion3DFlowAugmentor(max_magnitude=0.02),
        Translational3DFlowAugmentor(max_disp=1, p=1.0),
        Rotational3DFlowAugmentor(max_rot_deg=0.5, p=1.0),
        Jitter3DFlowAugmentor(max_magnitude=1),
    ])


def get_test_3d_generator():
    """Preset parity: reference motion_generators.py:479-484."""
    return FlowGenerator3D([
        Translational3DFlowAugmentor(max_disp=5, p=1.0),
        Rotational3DFlowAugmentor(max_rot_deg=3, p=1.0),
    ])


def get_high_disp_3d_generator():
    """Preset parity: reference motion_generators.py:487-495."""
    return FlowGenerator3D([
        Expansion3DFlowAugmentor(max_magnitude=0.15, p=1.0),
        Expansion3DFlowAugmentor(max_magnitude=0.1, p=1.0),
        Jitter3DFlowAugmentor(max_magnitude=3, p=1.0),
        Translational3DFlowAugmentor(max_disp=8, p=1.0),
        Rotational3DFlowAugmentor(max_rot_deg=3, p=1.0),
        Random3DFlowAugmentor(max_magnitude=2.5, p=1.0),
    ])
