"""2D red-black SOR level solver (the legacy 2D path), pure PyTorch.

Counterpart of ``flowreg3d_tpu/core/solver2d.py`` (``core.compute_flow``):
nonlinear point-wise SOR on the 2D Euler-Lagrange system: the data term's
psi lagged, updated every ``update_lag`` iterations; flow-driven smoothness
diffusivity every iteration (its gradients are clamped central differences,
not the 3D solver's stencil); omega 1.95; Neumann boundaries; red then black.
The JAX package has no Pallas kernel here, so neither has the port; on CUDA
``compute_flow`` replays one CUDA graph per configuration and device
(``_graph.BodyGraph``, JAX's jitted ``_solve2d``).

J entries: 2D motion tensor (J11, J22, J33, J12, J13, J23) with the
convention J = [[J11, J12, J13], [J12, J22, J23], [J13, J23, J33]] over
(u, v, 1): J13/J23 are the data-term couplings and J33 the constant.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch import _graph
from flowreg3d_tpu_torch._device import resolve_device

OMEGA = 1.95
EPS_PSI = 1e-6
EPS_SMOOTH = 1e-5


def set_boundary_2d(f):
    """Neumann ring, in place: rows first, then columns."""
    f[0, :] = f[1, :]
    f[-1, :] = f[-2, :]
    f[:, 0] = f[:, 1]
    f[:, -1] = f[:, -2]
    return f


def _cgrad(f, axis, h):
    """Central difference along ``axis``, the neighbours clamped to the
    array (one-sided halves at the faces)."""
    n = f.shape[axis]
    i = torch.arange(n, device=f.device)
    fp = f.index_select(axis, torch.clamp(i + 1, max=n - 1))
    fm = f.index_select(axis, torch.clamp(i - 1, min=0))
    return (fp - fm) / (2.0 * h)


def _psi_smooth(u, du, v, dv, a, hx, hy):
    g = torch.zeros_like(u)
    for comp, dcomp in ((u, du), (v, dv)):
        cc = comp + dcomp
        for axis, h in ((0, hy), (1, hx)):
            d = _cgrad(cc, axis, h)
            g = g + d * d
    return a * (torch.clamp(g, min=0.0) + EPS_SMOOTH) ** (a - 1.0)


def _interior(f):
    return f[1:-1, 1:-1]


def _nbr(f):
    return dict(xm=f[1:-1, :-2], xp=f[1:-1, 2:],
                ym=f[:-2, 1:-1], yp=f[2:, 1:-1])


def _solve2d(Jt, weight, u, v, alpha, a_data, a_smooth, hx, hy,
             iterations, update_lag, a_smooth_is_one):
    """Jt: (6, m, n, C) stacked [J11, J22, J33, J12, J13, J23]; every
    argument but the three ints and the flag a tensor of u's dtype."""
    _, m, n, C = Jt.shape
    J11, J22, J33, J12, J13, J23 = Jt.unbind(0)

    du = torch.zeros_like(u)
    dv = torch.zeros_like(u)
    ax = alpha[0] / (hx * hx)
    ay = alpha[1] / (hy * hy)
    a_vec = a_data.reshape(1, 1, C)

    jj = torch.arange(m - 2, device=u.device)[:, None]
    ii = torch.arange(n - 2, device=u.device)[None, :]
    red = ((jj + ii) % 2) == 0

    def tick(du, dv):
        d_u = du[..., None]
        d_v = dv[..., None]
        E = (J11 * d_u * d_u + J22 * d_v * d_v + 2 * J12 * d_u * d_v
             + 2 * J13 * d_u + 2 * J23 * d_v + J33)
        E = torch.clamp(E, min=0.0)
        psi = torch.where(a_vec != 1.0,
                          a_vec * (E + EPS_PSI) ** (a_vec - 1.0),
                          torch.ones_like(E))
        S = weight * psi
        return (torch.sum(S * J11, -1), torch.sum(S * J22, -1),
                torch.sum(S * J12, -1), torch.sum(S * J13, -1),
                torch.sum(S * J23, -1))

    def smooth_weights(du, dv):
        if a_smooth_is_one:
            full = torch.ones((m - 2, n - 2), dtype=u.dtype, device=u.device)
            return dict(xm=full * ax, xp=full * ax, ym=full * ay,
                        yp=full * ay)
        psi = _psi_smooth(u, du, v, dv, a_smooth, hx, hy)
        c = _interior(psi)
        nb = _nbr(psi)
        return dict(xm=0.5 * (c + nb["xm"]) * ax,
                    xp=0.5 * (c + nb["xp"]) * ax,
                    ym=0.5 * (c + nb["ym"]) * ay,
                    yp=0.5 * (c + nb["yp"]) * ay)

    def half(mask, du, dv, SJ, sw):
        SJ11, SJ22, SJ12, SJ13, SJ23 = SJ
        duI = _interior(du)
        dvI = _interior(dv)
        nu = -(_interior(SJ13) + _interior(SJ12) * dvI)
        nv = -(_interior(SJ23) + _interior(SJ12) * duI)
        sw_sum = sw["xm"] + sw["xp"] + sw["ym"] + sw["yp"]

        def comp(base, inc, nd, dd, old):
            tot = base + inc
            nb = _nbr(tot)
            baseI = _interior(base)
            num = nd + sum(sw[k] * (nb[k] - baseI) for k in sw)
            den = dd + sw_sum
            frac = torch.where(den != 0, num / den, torch.zeros_like(den))
            new = (1.0 - OMEGA) * old + OMEGA * frac
            return torch.where(mask, new, old)

        new_du = comp(u, du, nu, _interior(SJ11), duI)
        new_dv = comp(v, dv, nv, _interior(SJ22), dvI)
        du = du.clone()
        dv = dv.clone()
        du[1:-1, 1:-1] = new_du
        dv[1:-1, 1:-1] = new_dv
        return set_boundary_2d(du), set_boundary_2d(dv)

    SJ = tick(du, dv)
    for it in range(iterations):
        if it % update_lag == 0:
            SJ = tick(du, dv)
        du = set_boundary_2d(du)
        dv = set_boundary_2d(dv)
        sw = smooth_weights(du, dv)
        du, dv = half(red, du, dv, SJ, sw)
        du, dv = half(~red, du, dv, SJ, sw)
    return du, dv


def flow2d_solver(shape, n_channels, alpha, iterations, update_lag, a_data,
                  a_smooth, hx, hy, dtype, device):
    """``compute_flow``'s host work done once: its scalars as tensors on
    ``device`` (uploaded here). Returns ``solve(Jt, weight, u, v) -> (du,
    dv)``, Jt (6,m,n,C), which uploads nothing (capturable in a CUDA
    graph)."""
    def scalar(x):
        return torch.as_tensor(np.array(x, np.float64), device=device).to(
            dtype)

    consts = (scalar(alpha), scalar(np.broadcast_to(
        np.asarray(a_data, np.float64), (n_channels,))), scalar(a_smooth),
        scalar(hx), scalar(hy))
    flag = float(a_smooth) == 1.0

    def solve(Jt, weight, u, v):
        alpha_t, a_data_t, a_smooth_t, hx_t, hy_t = consts
        return _solve2d(Jt, weight, u, v, alpha_t, a_data_t, a_smooth_t,
                        hx_t, hy_t, int(iterations), int(update_lag), flag)

    return solve


def compute_flow(J_entries, weight, u, v, alpha=(2.0, 2.0), iterations=20,
                 update_lag=5, a_data=0.45, a_smooth=1.0, hx=1.0, hy=1.0,
                 device=None):
    """Solve one 2D level; returns (du, dv) tensors on ``device`` (None
    means 'cuda') in u's dtype.

    J_entries: 6 arrays (m, n, C) in order [J11, J22, J33, J12, J13, J23];
    weight (m, n, C); u, v (m, n) accumulated flow with boundary ring;
    numpy arrays or tensors. On CUDA the solve replays one CUDA graph per
    configuration and device (``_graph.BodyGraph`` of ``flow2d_solver``'s
    body, kind ``"flow2d"``, captured on the first call: the JAX package's
    jitted ``_solve2d``); elsewhere it runs eagerly.
    """
    dev = resolve_device(device)
    u = torch.as_tensor(u, device=dev)
    dtype = u.dtype
    C = np.shape(J_entries[0])[-1]
    key = (tuple(u.shape), int(C),
           tuple(float(a) for a in np.asarray(alpha, np.float64).ravel()),
           int(iterations), int(update_lag),
           tuple(float(a) for a in np.asarray(a_data, np.float64).ravel()),
           float(a_smooth), float(hx), float(hy),
           str(dtype).removeprefix("torch."))
    v = torch.as_tensor(v, device=dev).to(dtype)
    Jt = torch.stack([torch.as_tensor(j, device=dev).to(dtype)
                      for j in J_entries])
    inputs = (Jt, torch.as_tensor(weight, device=dev).to(dtype), u, v)

    def solver():
        return flow2d_solver(tuple(u.shape), C, alpha, iterations,
                             update_lag, a_data, a_smooth, hx, hy, dtype, dev)

    if dev.type == "cuda":
        graph = _graph.cached("flow2d", key, dev, lambda: _graph.BodyGraph(
            solver(), [(x.shape, dtype) for x in inputs], dev))
        return graph.run(*inputs)
    return solver()(*inputs)
