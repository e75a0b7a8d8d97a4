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
- ``a_smooth != 1``: per tick block, ``tick_update``, then ``update_lag``
  psi -> red -> black iterations of ``core/solver_psi_kernel.py`` on the
  unfolded base flow (the JAX package's XLA scheme: psi from the pre-red
  increments, reused for black): one cooperative launch of
  ``sor_iterations_psi_f32`` on CUDA tensors, its plain loop on CPU
  tensors or with ``use_kernels=False``.

Neither sweep writes the increments' ring; ``set_boundary_3d`` sets it on
the result. On CUDA the public ``compute_flow_level`` / ``_cl`` replay one
CUDA graph per configuration and device (JAX's jitted ``_solve``); the
pyramid's levels call ``solve_level_cl``, captured inside the pyramid's own
graph.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch import _graph
from flowreg3d_tpu_torch.core.solver_kernel import (_scalar_type,
                                                    base_laplacian, fold_base,
                                                    sweep_iterations)
from flowreg3d_tpu_torch.core.solver_psi_kernel import (psi_params,
                                                        set_boundary_3d,
                                                        sweep_iterations_psi)

EPS_PSI = 1e-6


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


def _blocks(iterations, update_lag):
    """Iteration counts of the tick blocks: psi_data is re-linearised every
    ``update_lag`` iterations."""
    n_full, rem = divmod(int(iterations), int(update_lag))
    return [int(update_lag)] * n_full + ([rem] if rem else [])


def _solve_psi(Jc, weight, a_vec, u, v, w, a_smooth, ax, ay, az, hx, hy, hz,
               iterations, update_lag, use_kernels):
    base = torch.stack([u, v, w])
    duvw = torch.zeros_like(base)
    # the kernel's scratch, or the plain loop's psi: one a level
    kernel = use_kernels and base.is_cuda
    scratch = torch.empty_like(base) if kernel else None
    psi = None if kernel else torch.empty_like(u)
    params = psi_params(a_smooth, hx, hy, hz, u.dtype) + (ax, ay, az)
    for k_iters in _blocks(iterations, update_lag):
        SJ = tick_update(Jc, weight, a_vec, duvw[0], duvw[1], duvw[2])
        sweep_iterations_psi(duvw, base, torch.stack(SJ), params, k_iters,
                             use_kernels, psi, scratch)
    return tuple(set_boundary_3d(duvw[k].clone()) for k in range(3))


def _solve_folded(Jc, weight, a_vec, u, v, w, ax, ay, az, iterations,
                  update_lag, use_kernels):
    laps = [base_laplacian(b, ax, ay, az) for b in (u, v, w)]
    duvw = torch.zeros((3,) + tuple(u.shape), dtype=u.dtype, device=u.device)
    for k_iters in _blocks(iterations, update_lag):
        SJ = tick_update(Jc, weight, a_vec, duvw[0], duvw[1], duvw[2])
        sweep_iterations(duvw, fold_base(SJ, laps), ax, ay, az, k_iters,
                         use_kernels)
    return tuple(set_boundary_3d(duvw[k].clone()) for k in range(3))


def data_exponents(a_data, n_channels, dtype, device):
    """The data term's exponents as a (C,) tensor on ``device``.

    ``a_data``: scalar, sequence or array (uploaded here), or a tensor
    already on ``device``, passed through. ``build_pyramid`` uploads once
    per pyramid, so that no level copies from the host: a level must be
    capturable in a CUDA graph.
    """
    if isinstance(a_data, torch.Tensor):
        a_vec = a_data.to(device=device, dtype=dtype).reshape(-1)
    else:
        a_vec = torch.as_tensor(np.asarray(a_data, np.float64).reshape(-1),
                                dtype=dtype, device=device)
    return a_vec.expand(n_channels) if a_vec.numel() == 1 else a_vec


def level_solver(shape, n_channels, alpha, iterations, update_lag, a_data,
                 a_smooth, hx, hy, hz, dtype, device, use_kernels=True):
    """One level solve's host work done once: the stencil weights and grid
    spacings rounded in ``dtype``, the regime, and the exponents on
    ``device`` (``data_exponents``; a tensor passes through; None: given
    to each solve). Returns ``solve(Jc, weight, u, v, w, a=None) -> (du,
    dv, dw)``: Jc (10,C,p,m,n) and weight (C,p,m,n) of u's dtype, ``a``
    the exponents as a tensor on u's device when ``a_data`` is None; it
    uploads nothing, so a CUDA graph can capture it."""
    t = _scalar_type(dtype)
    a_vec = (None if a_data is None
             else data_exponents(a_data, n_channels, dtype, device))
    ax, ay, az = (float(t(a) / (t(h) * t(h)))
                  for a, h in zip(np.asarray(alpha, np.float64).reshape(3),
                                  (hx, hy, hz)))
    hx, hy, hz = (float(t(h)) for h in (hx, hy, hz))
    a_smooth = float(t(a_smooth))

    def solve(Jc, weight, u, v, w, a=None):
        a = a_vec if a is None else data_exponents(a, n_channels, dtype,
                                                   device)
        if a_smooth == 1.0:
            return _solve_folded(Jc, weight, a, u, v, w, ax, ay, az,
                                 iterations, update_lag, use_kernels)
        return _solve_psi(Jc, weight, a, u, v, w, a_smooth, ax, ay, az,
                          hx, hy, hz, iterations, update_lag, use_kernels)

    return solve


def solve_level_cl(J_entries, weight, u, v, w, alpha, iterations,
                   update_lag, a_data, a_smooth, hx, hy, hz,
                   use_kernels=True):
    """``compute_flow_level_cl`` run eagerly, on any device: the pyramid's
    level solve (captured inside its graph) and the CPU path."""
    Jc = torch.stack(list(J_entries)).to(u.dtype)
    weight = weight.to(u.dtype).reshape(Jc.shape[1:])
    return level_solver(u.shape, Jc.shape[1], alpha, iterations, update_lag,
                        a_data, a_smooth, hx, hy, hz, u.dtype, u.device,
                        use_kernels)(Jc, weight, u, v, w)


def level_config_key(shape, n_channels, alpha, iterations, update_lag,
                     a_data, a_smooth, hx, hy, hz, dtype, use_kernels):
    """Hashable static configuration of one level solve: host values, or
    ``"tensor"`` for exponents given as a tensor (a graph input then)."""
    if isinstance(a_data, torch.Tensor):
        a_data = "tensor"
    else:
        a_data = tuple(float(a) for a in np.asarray(a_data,
                                                     np.float64).ravel())
        a_data = a_data * n_channels if len(a_data) == 1 else a_data
    return (tuple(int(s) for s in shape), int(n_channels),
            tuple(float(a) for a in np.broadcast_to(
                np.asarray(alpha, np.float64), (3,))),
            int(iterations), int(update_lag), a_data, float(a_smooth),
            float(hx), float(hy), float(hz),
            str(dtype).removeprefix("torch."), bool(use_kernels))


def compute_flow_level_cl(J_entries, weight, u, v, w, alpha, iterations,
                          update_lag, a_data, a_smooth, hx, hy, hz,
                          use_kernels=True):
    """Solve one level, channel-leading layout.

    J_entries: 10 tensors (C,p,m,n) [J11,J22,J33,J44,J12,J13,J23,J14,J24,
    J34] or one (10,C,p,m,n) stack; weight (C,p,m,n); u,v,w (p,m,n)
    accumulated flow with its one-voxel ring; alpha 3-sequence; a_data
    (C,) or scalar, or a tensor on the flow's device (``data_exponents``).
    On CUDA the solve replays one CUDA graph per configuration and device
    (``_graph.BodyGraph`` of ``level_solver``'s body, kind ``"level"``,
    captured on the first call: the JAX package's jitted ``_solve``);
    elsewhere it runs eagerly (``solve_level_cl``). Returns (du, dv, dw),
    each (p,m,n).
    """
    if u.device.type != "cuda":
        return solve_level_cl(J_entries, weight, u, v, w, alpha, iterations,
                              update_lag, a_data, a_smooth, hx, hy, hz,
                              use_kernels)
    Jc = (J_entries if isinstance(J_entries, torch.Tensor)
          else torch.stack(list(J_entries)))
    C, dtype = Jc.shape[1], u.dtype
    key = level_config_key(u.shape, C, alpha, iterations, update_lag, a_data,
                           a_smooth, hx, hy, hz, dtype, use_kernels)
    inputs = [Jc, weight.reshape(Jc.shape[1:]), u, v, w]
    if key[5] == "tensor":           # the exponents are an input too
        inputs.append(a_data.reshape(-1).expand(C))
    graph = _graph.cached("level", key, u.device, lambda: _graph.BodyGraph(
        level_solver(u.shape, C, alpha, iterations, update_lag,
                     None if key[5] == "tensor" else a_data, a_smooth, hx,
                     hy, hz, dtype, u.device, use_kernels),
        [(x.shape, dtype) for x in inputs], u.device))
    return graph.run(*inputs)


def compute_flow_level(J_entries, weight, u, v, w, alpha, iterations,
                       update_lag, a_data, a_smooth, hx, hy, hz,
                       use_kernels=True):
    """Solve one level; J_entries are 10 tensors (p,m,n,C), weight
    (p,m,n,C). Same semantics as ``compute_flow_level_cl``."""
    Jc = [j.movedim(-1, 0) for j in J_entries]
    return compute_flow_level_cl(Jc, weight.movedim(-1, 0), u, v, w, alpha,
                                 iterations, update_lag, a_data, a_smooth,
                                 hx, hy, hz, use_kernels)
