"""Finite-difference stencils with numpy/MATLAB gradient semantics.

Counterpart of ``flowreg3d_tpu/ops/gradients.py``: central differences in
the interior, one-sided at the boundaries (``np.gradient``), and second
differences that are zero on the boundary faces.
"""

import torch


def gradient_axis(f, axis, spacing=1.0):
    """np.gradient along one axis: central interior, one-sided boundaries."""
    n = f.shape[axis]
    if n < 2:
        return torch.zeros_like(f)
    interior = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) / (
        2.0 * spacing)
    first = (f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)) / spacing
    last = (f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)) / spacing
    return torch.cat([first, interior, last], dim=axis)


def gradient_zyx(f, hz=1.0, hy=1.0, hx=1.0):
    """np.gradient(f, hz, hy, hx) over the three leading axes."""
    return (gradient_axis(f, 0, hz), gradient_axis(f, 1, hy),
            gradient_axis(f, 2, hx))


def second_diff_zyx(f, hz, hy, hx):
    """Second differences per axis, zero at the boundaries -> (fxx, fyy, fzz)."""
    fxx = torch.zeros_like(f)
    fyy = torch.zeros_like(f)
    fzz = torch.zeros_like(f)
    fxx[:, :, 1:-1] = (f[:, :, :-2] - 2.0 * f[:, :, 1:-1] + f[:, :, 2:]) / (
        hx * hx)
    fyy[:, 1:-1, :] = (f[:, :-2, :] - 2.0 * f[:, 1:-1, :] + f[:, 2:, :]) / (
        hy * hy)
    fzz[1:-1, :, :] = (f[:-2, :, :] - 2.0 * f[1:-1, :, :] + f[2:, :, :]) / (
        hz * hz)
    return fxx, fyy, fzz


def divergence(flow, hz=1.0, hy=1.0, hx=1.0):
    """du/dx + dv/dy + dw/dz of a (Z,Y,X,3) flow field ([dx,dy,dz] order)."""
    return (gradient_axis(flow[..., 0], 2, hx)
            + gradient_axis(flow[..., 1], 1, hy)
            + gradient_axis(flow[..., 2], 0, hz))
