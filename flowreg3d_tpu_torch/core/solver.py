"""Nonlinear red-black SOR level solver for the 3D Euler-Lagrange system.

Counterpart of ``flowreg3d_tpu/core/solver.py``. Per pyramid level it
solves for the flow increment (du,dv,dw): a data term whose psi_data is
re-linearised every ``update_lag`` iterations (``tick_update``), a
smoothness term with constant (``a_smooth == 1``) or flow-driven
diffusivity, SOR relaxation omega=1.95 and Neumann (copy) boundaries.

Two formulations:
- ``a_smooth == 1``: per tick block, ``tick_update`` in PyTorch, then
  ``update_lag`` red+black iterations of ``core/solver_kernel.py`` with
  the base flow's Laplacian folded into the data terms: the CUDA kernel
  on CUDA tensors, its plain version on CPU tensors or with
  ``use_kernels=False``;
- ``a_smooth != 1``: the JAX package's XLA formulation, unfolded, in
  plain PyTorch (``half_sweep``). On CUDA it runs only with
  ``use_kernels=False``: its kernel (the psi sweep) is not ported yet.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch.core.solver_kernel import (_parity_mask,
                                                    _scalar_type,
                                                    base_laplacian, fold_base,
                                                    sweep_iterations)

OMEGA = 1.95
EPS_PSI = 1e-6
EPS_SMOOTH = 1e-5

_I = (slice(1, -1),) * 3


def set_boundary_3d(f):
    """Neumann copy boundaries, in place on ``f``; returns ``f``."""
    f[:, 0, :] = f[:, 1, :]
    f[:, -1, :] = f[:, -2, :]
    f[:, :, 0] = f[:, :, 1]
    f[:, :, -1] = f[:, :, -2]
    f[0] = f[1]
    f[-1] = f[-2]
    return f


def _psi_smooth_field(u, du, v, dv, w, dw, a, hx, hy, hz):
    """Flow-driven diffusivity a*(|grad(u+du,v+dv,w+dw)|^2+eps)^(a-1), with
    clamped-index central differences over the full grid."""
    def cgrad(f, axis, h):
        n = f.shape[axis]
        fp = torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)],
                       dim=axis)
        fm = torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)],
                       dim=axis)
        return (fp - fm) / (2.0 * h)

    g = torch.zeros_like(u)
    for comp, dcomp in ((u, du), (v, dv), (w, dw)):
        cc = comp + dcomp
        for axis, h in ((0, hz), (1, hy), (2, hx)):
            d = cgrad(cc, axis, h)
            g = g + d * d
    g = torch.clamp(g, min=0.0)
    return a * (g + EPS_SMOOTH) ** (a - 1.0)


def _nbr(f):
    """Six neighbour views of the interior of a full-grid tensor."""
    return dict(
        xm=f[1:-1, 1:-1, :-2], xp=f[1:-1, 1:-1, 2:],
        ym=f[1:-1, :-2, 1:-1], yp=f[1:-1, 2:, 1:-1],
        zm=f[:-2, 1:-1, 1:-1], zp=f[2:, 1:-1, 1:-1],
    )


def tick_update(Jc, weight, a_data, du, dv, dw):
    """psi_data re-linearisation, reduced over channels.

    Jc (10,C,p,m,n) [J11,J22,J33,J44,J12,J13,J23,J14,J24,J34], weight
    (C,p,m,n), a_data (C,) -> the 9 terms [SJ11,SJ22,SJ33,SJ12,SJ13,SJ23,
    SJ14,SJ24,SJ34], each (p,m,n).
    """
    J11, J22, J33, J44, J12, J13, J23, J14, J24, J34 = Jc
    du4, dv4, dw4 = du[None], dv[None], dw[None]
    E = (J11 * du4 * du4 + J22 * dv4 * dv4 + J33 * dw4 * dw4
         + 2.0 * J12 * du4 * dv4 + 2.0 * J13 * du4 * dw4
         + 2.0 * J23 * dv4 * dw4
         + 2.0 * J14 * du4 + 2.0 * J24 * dv4 + 2.0 * J34 * dw4 + J44)
    E = torch.clamp(E, min=0.0)
    a = a_data.reshape(-1, 1, 1, 1)
    psi = torch.where(a != 1.0, a * (E + EPS_PSI) ** (a - 1.0),
                      torch.ones_like(E))
    S = weight * psi
    return tuple(torch.sum(S * J, 0)
                 for J in (J11, J22, J33, J12, J13, J23, J14, J24, J34))


def half_sweep(mask, du, dv, dw, u, v, w, SJ, sw):
    """One masked half-sweep over the unfolded base + increment stencil;
    returns new (du, dv, dw) with Neumann rings applied."""
    SJ11, SJ22, SJ33, SJ12, SJ13, SJ23, SJ14, SJ24, SJ34 = SJ
    duI, dvI, dwI = du[_I], dv[_I], dw[_I]
    nu_data = -(SJ14[_I] + SJ12[_I] * dvI + SJ13[_I] * dwI)
    nv_data = -(SJ24[_I] + SJ12[_I] * duI + SJ23[_I] * dwI)
    nw_data = -(SJ34[_I] + SJ13[_I] * duI + SJ23[_I] * dvI)
    sw_sum = sw["xm"] + sw["xp"] + sw["ym"] + sw["yp"] + sw["zm"] + sw["zp"]

    def sweep_component(base, inc, num_data, den_data, old):
        # per direction: w * (base_nbr + inc_nbr - base_ctr); the centre
        # unknown appears only in the denominator
        nb = _nbr(base + inc)
        baseI = base[_I]
        num = num_data
        for k in ("xm", "xp", "ym", "yp", "zm", "zp"):
            num = num + sw[k] * (nb[k] - baseI)
        den = den_data + sw_sum
        frac = torch.where(den != 0, num / den, torch.zeros_like(den))
        new = (1.0 - OMEGA) * old + OMEGA * frac
        return torch.where(mask, new, old)

    out = []
    for base, inc, num_data, den_data, old in (
            (u, du, nu_data, SJ11[_I], duI), (v, dv, nv_data, SJ22[_I], dvI),
            (w, dw, nw_data, SJ33[_I], dwI)):
        new = sweep_component(base, inc, num_data, den_data, old)
        f = inc.clone()
        f[_I] = new
        out.append(set_boundary_3d(f))
    return tuple(out)


def _smooth_weights(u, v, w, du, dv, dw, a_smooth, ax, ay, az, hx, hy, hz):
    psi = _psi_smooth_field(u, du, v, dv, w, dw, a_smooth, hx, hy, hz)
    psiC = psi[_I]
    nb = _nbr(psi)
    scale = dict(xm=ax, xp=ax, ym=ay, yp=ay, zm=az, zp=az)
    return {k: 0.5 * (psiC + nb[k]) * scale[k] for k in scale}


def _solve_unfolded(Jc, weight, a_vec, u, v, w, a_smooth, ax, ay, az, hx, hy,
                 hz, iterations, update_lag):
    red = _parity_mask(*u.shape, 0, u.device)
    black = ~red
    du, dv, dw = (torch.zeros_like(u) for _ in range(3))
    SJ = None
    for it in range(iterations):
        if it % update_lag == 0:
            SJ = tick_update(Jc, weight, a_vec, du, dv, dw)
        du, dv, dw = (set_boundary_3d(f) for f in (du, dv, dw))
        sw = _smooth_weights(u, v, w, du, dv, dw, a_smooth, ax, ay, az,
                             hx, hy, hz)
        du, dv, dw = half_sweep(red, du, dv, dw, u, v, w, SJ, sw)
        du, dv, dw = half_sweep(black, du, dv, dw, u, v, w, SJ, sw)
    return du, dv, dw


def _solve_folded(Jc, weight, a_vec, u, v, w, ax, ay, az, iterations,
                  update_lag, use_kernels):
    laps = [base_laplacian(b, ax, ay, az) for b in (u, v, w)]
    duvw = torch.zeros((3,) + tuple(u.shape), dtype=u.dtype, device=u.device)
    n_full, rem = divmod(int(iterations), int(update_lag))
    for k_iters in [update_lag] * n_full + ([rem] if rem else []):
        SJ = tick_update(Jc, weight, a_vec, duvw[0], duvw[1], duvw[2])
        sweep_iterations(duvw, fold_base(SJ, laps), ax, ay, az, k_iters,
                         use_kernels)
    return tuple(set_boundary_3d(duvw[k].clone()) for k in range(3))


def compute_flow_level_cl(J_entries, weight, u, v, w, alpha, iterations,
                          update_lag, a_data, a_smooth, hx, hy, hz,
                          use_kernels=True):
    """Solve one level, channel-leading layout.

    J_entries: 10 tensors (C,p,m,n) [J11,J22,J33,J44,J12,J13,J23,J14,J24,
    J34] or one (10,C,p,m,n) stack; weight (C,p,m,n); u,v,w (p,m,n)
    accumulated flow with its one-voxel ring; alpha 3-sequence; a_data
    (C,) or scalar. Returns (du, dv, dw), each (p,m,n).
    """
    dtype, device = u.dtype, u.device
    t = _scalar_type(dtype)
    Jc = torch.stack(list(J_entries)).to(dtype)
    weight = weight.to(dtype).reshape(Jc.shape[1:])
    a_vec = torch.as_tensor(np.asarray(a_data, np.float64).reshape(-1),
                            dtype=dtype, device=device)
    a_vec = a_vec.expand(Jc.shape[1]) if a_vec.numel() == 1 else a_vec
    ax, ay, az = (float(t(a) / (t(h) * t(h)))
                  for a, h in zip(np.asarray(alpha, np.float64).reshape(3),
                                  (hx, hy, hz)))
    hx, hy, hz = (float(t(h)) for h in (hx, hy, hz))
    a_smooth = float(t(a_smooth))
    if a_smooth == 1.0:
        return _solve_folded(Jc, weight, a_vec, u, v, w, ax, ay, az,
                             iterations, update_lag, use_kernels)
    if use_kernels and device.type == "cuda":
        raise NotImplementedError(
            "a_smooth != 1 (flow-driven diffusivity) has no CUDA kernel yet: "
            "ROADMAP.md Queue 2 item 5 (solver_pallas.py:_sweep_kernel_psi). "
            "Pass use_kernels=False to run the plain PyTorch solver.")
    return _solve_unfolded(Jc, weight, a_vec, u, v, w, a_smooth, ax, ay, az,
                        hx, hy, hz, iterations, update_lag)


def compute_flow_level(J_entries, weight, u, v, w, alpha, iterations,
                       update_lag, a_data, a_smooth, hx, hy, hz,
                       use_kernels=True):
    """Solve one level; J_entries are 10 tensors (p,m,n,C), weight
    (p,m,n,C). Same semantics as ``compute_flow_level_cl``."""
    Jc = [j.movedim(-1, 0) for j in J_entries]
    return compute_flow_level_cl(Jc, weight.movedim(-1, 0), u, v, w, alpha,
                                 iterations, update_lag, a_data, a_smooth,
                                 hx, hy, hz, use_kernels)
