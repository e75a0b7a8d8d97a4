"""Coarse-to-fine pyramid for 3D variational optical flow.

Counterpart of ``flowreg3d_tpu/core/pyramid.py``: per-axis pyramid depth
(min-dim shrunk by eta until round(min_dim) < 10), level sizes
``round(dim*eta^min(i,max_axis))``, grid spacings ``h = orig/level`` for
the stencils, flow kept in original-resolution units and divided by h
before warping, alpha scaled by ``eta^(-i/2)`` except at min_level, a 5^3
median of the increments when min(level size) > 5, and a final upsample
when min_level > 0. Each level: resize -> warp by the current flow ->
motion tensor -> SOR solve -> median -> accumulate.

The schedule is computed on the host; PyTorch runs the levels eagerly.
With ``use_kernels=True`` every level's warp, sweeps and median go through
the CUDA kernels on CUDA tensors (their plain versions on CPU tensors);
``use_kernels=False`` runs the plain PyTorch versions on any device.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.core.motion_tensor import MOTION_TENSORS, pad_edge
from flowreg3d_tpu_torch.core.solver import (compute_flow_level_cl,
                                             data_exponents)
from flowreg3d_tpu_torch.ops.median_kernel import (median5_plain,
                                                   median_filter_5x5x5_batched,
                                                   mirror_pad2)
from flowreg3d_tpu_torch.ops.resize import resize_volume
from flowreg3d_tpu_torch.ops.warp import warp

_I = (slice(1, -1),) * 3


def warping_depth(eta, levels, p, m, n):
    """Pyramid depth: shrink min-dim by eta until round(.) < 10 (ref :77-85)."""
    min_dim = min(p, m, n)
    depth = 0
    for _ in range(levels):
        depth += 1
        min_dim *= eta
        if round(min_dim) < 10:
            break
    return depth


def add_boundary(f):
    """Pad a volume by one voxel on each side with edge values (ref :88-89)."""
    return pad_edge(f)


def level_schedule(shape_zyx, eta, levels, min_level):
    """Static (host-side) level plan: list of (level_index, level_size, h).

    Returns levels ordered coarse -> fine, plus the effective min_level.
    """
    p, m, n = shape_zyx
    mlz = warping_depth(eta, levels, p, m, n)
    mly = warping_depth(eta, levels, m, n, p)
    mlx = warping_depth(eta, levels, n, p, m)
    cap = min(mlx, mly, mlz) * 4
    mlz, mly, mlx = min(mlz, cap), min(mly, cap), min(mlx, cap)
    top = max(mlx, mly, mlz)
    if top <= min_level:
        min_level = top - 1
    if min_level < 0:
        min_level = 0
    plan = []
    for i in range(top, min_level - 1, -1):
        size = (
            int(round(p * eta ** min(i, mlz))),
            int(round(m * eta ** min(i, mly))),
            int(round(n * eta ** min(i, mlx))),
        )
        h = (p / size[0], m / size[1], n / size[2])
        plan.append((i, size, h))
    return plan, min_level, top


def _normalize_weight(weight, shape, n_channels, dtype, device):
    """Reference weight semantics (core/optical_flow_3d.py:351-381)."""
    p, m, n = shape
    if weight is None:
        return torch.full((p, m, n, n_channels), 1.0 / n_channels,
                          dtype=dtype, device=device)
    weight = torch.as_tensor(weight).to(device=device, dtype=dtype)
    if weight.dim() == 1:
        wv = np.asarray(weight.cpu(), dtype=np.float64)
        if len(wv) < n_channels:
            ww = np.full(n_channels, 1.0 / n_channels)
            ww[: len(wv)] = wv
            wv = ww
        elif len(wv) > n_channels:
            wv = wv[:n_channels]
        wv = wv / wv.sum()
        return torch.as_tensor(wv, dtype=dtype, device=device).reshape(
            1, 1, 1, -1).expand(p, m, n, n_channels)
    if weight.dim() == 3:
        return weight[..., None].expand(p, m, n, n_channels)
    return weight.expand(p, m, n, n_channels)


def _median_increments(du, dv, dw, use_kernels):
    """5^3-median-filter the interiors of the three increments, one launch."""
    stacked = torch.stack([du[_I], dv[_I], dw[_I]])
    med = (median_filter_5x5x5_batched(stacked) if use_kernels
           else median5_plain(mirror_pad2(stacked)))
    for f, m in zip((du, dv, dw), med):
        f[_I] = m
    return du, dv, dw


def level_alpha(alpha, i, eff_min_level, eta):
    """Level i's smoothness weights: alpha scaled by eta^(-i/2), except at
    the finest level solved."""
    alpha_scaling = 1.0 if i == eff_min_level else eta ** (-0.5 * i)
    return tuple(alpha_scaling * a for a in alpha)


def level_step(f1, f2, u, v, w, weight, h, alpha, motion_tensor, iterations,
               update_lag, a_vec, a_smooth, use_kernels):
    """One level after its resizes: warp ``f2`` by the current flow, the
    motion tensor, the SOR solve, the median of the increments; returns the
    accumulated flow (u, v, w), each with its one-voxel ring. f1/f2/weight
    (p,m,n,C) level volumes, h = (hz, hy, hx)."""
    hz, hy, hx = h
    # warp by the current flow so the solver sees the residual
    tmp = warp(f2, u[_I] / hx, v[_I] / hy, w[_I] / hz, f1, 3, use_kernels)
    Jc = torch.stack([
        torch.stack(motion_tensor(f1[..., c], tmp[..., c], hz, hy, hx))
        for c in range(f1.shape[-1])], dim=1)          # (10, C, p, m, n)
    weight = torch.nn.functional.pad(weight.movedim(-1, 0),
                                     (1, 1, 1, 1, 1, 1))
    du, dv, dw = compute_flow_level_cl(
        Jc, weight, u, v, w, alpha, iterations, update_lag, a_vec, a_smooth,
        hx, hy, hz, use_kernels=use_kernels)
    if min(f1.shape[:3]) > 5:
        du, dv, dw = _median_increments(du, dv, dw, use_kernels)
    return u + du, v + dv, w + dw


def pyramid_config_key(shape, n_channels, alpha=(2.0, 2.0, 2.0),
                       update_lag=10, iterations=20, min_level=0, levels=50,
                       eta=0.8, a_smooth=0.5, a_data=0.45,
                       const_assumption="gc", dtype=torch.float32,
                       use_kernels=True):
    """Hashable static-config tuple for ``build_pyramid``; the fields of the
    JAX package's key, with ``use_kernels`` in place of ``use_pallas``."""
    alpha = tuple(float(a) for a in np.broadcast_to(
        np.asarray(alpha, np.float64), (3,)))
    if isinstance(a_data, (list, tuple, np.ndarray)):
        a_data_key = tuple(float(a) for a in np.asarray(a_data).ravel())
        if len(a_data_key) == 1:
            a_data_key = a_data_key * n_channels
    else:
        a_data_key = (float(a_data),) * n_channels
    return (tuple(int(s) for s in shape), int(n_channels), alpha,
            int(update_lag), int(iterations), int(min_level), int(levels),
            float(eta), float(a_smooth), a_data_key, const_assumption,
            str(dtype).removeprefix("torch."), bool(use_kernels))


def build_pyramid(shape, n_channels, alpha, update_lag, iterations,
                  min_level, levels, eta, a_smooth, a_data, const_assumption,
                  dtype_name, use_kernels=True, *, device=None):
    """The pyramid for one static configuration (``pyramid_config_key``).

    Returns ``pyramid(fixed, moving, uvw, weight) -> flow``: fixed/moving
    (Z,Y,X,C), uvw (Z,Y,X,3) initial flow, weight (Z,Y,X,C); tensors on
    ``device`` (None means 'cuda', which raises without CUDA).
    """
    dev = resolve_device(device)
    dtype = getattr(torch, dtype_name)
    p, m, n = shape
    plan, eff_min_level, _ = level_schedule(shape, eta, levels, min_level)
    motion_tensor = MOTION_TENSORS[const_assumption]
    # uploaded once here: a level that copied from the host could not be
    # captured in a CUDA graph (parallel/executors.py)
    a_vec = data_exponents(
        np.asarray(a_data if isinstance(a_data, tuple)
                   else (a_data,) * n_channels, dtype=np.float64),
        n_channels, dtype, dev)

    def pyramid(fixed, moving, uvw, weight):
        for name, t in (("fixed", fixed), ("moving", moving), ("uvw", uvw),
                        ("weight", weight)):
            if t.device != dev:
                raise ValueError(f"pyramid: {name} on {t.device}, "
                                 f"pyramid built for {dev}")
        u = v = w = None
        for step, (i, size, (hz, hy, hx)) in enumerate(plan):
            f1_level = resize_volume(fixed, size, dtype=dtype)
            f2_level = resize_volume(moving, size, dtype=dtype)
            if step == 0:
                u, v, w = (add_boundary(resize_volume(uvw[..., k], size,
                                                      dtype=dtype))
                           for k in range(3))
            else:
                u, v, w = (add_boundary(resize_volume(f[_I], size,
                                                      dtype=dtype))
                           for f in (u, v, w))
            u, v, w = level_step(
                f1_level, f2_level, u, v, w,
                resize_volume(weight, size, dtype=dtype), (hz, hy, hx),
                level_alpha(alpha, i, eff_min_level, eta), motion_tensor,
                iterations, update_lag, a_vec, a_smooth, use_kernels)

        flow = torch.stack([u[_I], v[_I], w[_I]], dim=-1)
        if eff_min_level > 0:
            flow = torch.stack(
                [resize_volume(flow[..., k], (p, m, n), dtype=dtype)
                 for k in range(3)], dim=-1)
        return flow

    return pyramid


def get_displacement(fixed, moving, alpha=(2.0, 2.0, 2.0), update_lag=10,
                     iterations=20, min_level=0, levels=50, eta=0.8,
                     a_smooth=0.5, a_data=0.45, const_assumption="gc",
                     uvw=None, weight=None, dtype=torch.float32, device=None,
                     use_kernels=True):
    """Dense 3D flow (Z,Y,X,3)=[dx,dy,dz] from fixed to moving.

    fixed/moving: (Z,Y,X) or (Z,Y,X,C) arrays or tensors. ``device`` None
    means 'cuda' and raises without CUDA; ``device='cpu'`` runs the plain
    PyTorch path. ``use_kernels=False`` runs the plain path on any device.
    """
    dev = resolve_device(device)
    fixed = torch.as_tensor(fixed).to(device=dev, dtype=dtype)
    moving = torch.as_tensor(moving).to(device=dev, dtype=dtype)
    if fixed.dim() == 3:
        fixed = fixed[..., None]
        moving = moving[..., None]
    p, m, n, n_channels = fixed.shape
    if uvw is None:
        uvw = torch.zeros((p, m, n, 3), dtype=dtype, device=dev)
    else:
        uvw = torch.as_tensor(uvw).to(device=dev, dtype=dtype)
    weight = _normalize_weight(weight, (p, m, n), n_channels, dtype, dev)
    key = pyramid_config_key(
        (p, m, n), n_channels, alpha, update_lag, iterations, min_level,
        levels, eta, a_smooth, a_data, const_assumption, dtype, use_kernels)
    return build_pyramid(*key, device=dev)(fixed, moving, uvw, weight)
