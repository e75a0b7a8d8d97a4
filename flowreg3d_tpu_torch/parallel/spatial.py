"""Z-sharded level solver: the volume's z-rows split over a list of devices,
one-voxel halos exchanged between neighbouring slabs.

Counterpart of ``flowreg3d_tpu/parallel/spatial.py``. JAX runs one program
per device under ``shard_map`` and moves the halos with ``lax.ppermute``;
the port keeps one controller that holds a list of shards (``devices``, a
device may repeat: ``parallel/mesh.py``) and moves each halo row with one
``peer_copy`` into the neighbour's preallocated ghost row.

Each shard holds a slab of pz interior rows with one ghost row a side: the
increments duvw and the base flow (3, pz+2, M, N), the data terms and the
weight. An iteration is, as in JAX: exchange the increments' ghost rows,
the diffusivity psi (``a_smooth != 1``) on every slab and the exchange of
its ghost rows, the red half-sweep, exchange, the black half-sweep. The
sweeps are the kernels of ``csrc/sor_psi.cu`` in slab mode
(``core/solver_psi_kernel.py``, ``slab=(z_off, z_lo, z_hi)``): the
constant-weight half-sweep (``sor_halfsweep_const_f32``) at ``a_smooth ==
1``, as JAX's sharded solve uses the unfolded stencil with weights a_dir,
and ``psi_field_f32`` + ``sor_halfsweep_psi_f32`` otherwise; the data term
(``tick_update``) is the port's plain one on each slab, as on the
single-device path. The global z-faces take the Neumann rule inside the
kernels, so a face's ghost row is never read; rows past the volume's last
(shard padding) stay inert. The kernels' ``den != 0`` guard, which the JAX
sweep lacks, makes a difference only at den = 0, which alpha > 0 excludes.

``slab_solver`` and ``build_level_sharded`` do the host work once per
configuration; on CUDA ``compute_flow_level_sharded`` replays one CUDA graph
of the level per configuration and device list (``_graph.BodyGraph`` of
``build_level_sharded``'s body, kind ``"sharded_level"``: JAX's
``jax.jit(shard_map(...))``), whose nodes are the exchanges' copies and the
kernels.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch import _graph
from flowreg3d_tpu_torch.core.solver import (_blocks, data_exponents,
                                             level_config_key, tick_update)
from flowreg3d_tpu_torch.core.solver_kernel import _scalar_type
from flowreg3d_tpu_torch.core.solver_psi_kernel import (halfsweep,
                                                        halfsweep_plain,
                                                        halfsweep_psi,
                                                        halfsweep_psi_plain,
                                                        psi_field,
                                                        psi_field_plain,
                                                        psi_params,
                                                        set_boundary_3d)
from flowreg3d_tpu_torch.parallel.mesh import batch_devices, peer_copy


# the Z-shards' devices are the mesh's (a device may repeat)
spatial_devices = batch_devices


def exchange_ghosts(fields):
    """Refresh the ghost z-rows of each shard's (..., pz+2, M, N) block: row
    0 from the previous shard's last interior row, row -1 from the next
    shard's first. There is no wrap-around; the volume's faces keep theirs
    (the kernels apply the Neumann rule there)."""
    for k, f in enumerate(fields):
        if k > 0:
            peer_copy(f[..., 0, :, :], fields[k - 1][..., -2, :, :])
        if k < len(fields) - 1:
            peer_copy(f[..., -1, :, :], fields[k + 1][..., 1, :, :])
    return fields


def exchange_psi(psi, z_offs, p_int):
    """The psi exchange of JAX ``_psi_sharded``: a ghost row takes the
    neighbour's psi unless it is a global ring row (row 0 of the first
    shard, row -1 of a shard that reaches the ring at p_int + 1), which
    keeps the value computed with the Neumann rule."""
    for k, (f, z_off) in enumerate(zip(psi, z_offs)):
        if k > 0:
            peer_copy(f[0], psi[k - 1][-2])
        if z_off + f.shape[0] - 1 < p_int + 1:
            peer_copy(f[-1], psi[k + 1][1])
    return psi


def edge_fix(base, z_off, p_int):
    """Rows of a shard's ringed base block past the volume's last interior
    row take that row (the Neumann copy the sweep at p_int reads), as JAX
    ``spatial_pyramid._solve_sharded_local``'s ``edge_fix``."""
    P = base.shape[-3]
    zh = min(max(p_int - z_off, 0), P - 1)
    if zh < P - 1:
        base[..., zh + 1:, :, :] = base[..., zh:zh + 1, :, :]
    return base


def slab_solver(z_offs, p_int, alpha, iterations, update_lag, a_vecs,
                a_smooth, hx, hy, hz, dtype, use_kernels=True):
    """The sharded SOR level solve, its host work done once: the stencil
    weights and psi parameters rounded in ``dtype``, the slabs' (z_off,
    z_lo, z_hi), the tick blocks. ``a_vecs``: the data exponents on each
    shard's device (``data_exponents``), uploaded by the caller once.

    Returns ``solve(Jc, weight, base) -> duvw``, per shard k: Jc[k]
    (10,C,P_k,M,N) data tensors, weight[k] (C,P_k,M,N), base[k] (3,P_k,M,N)
    ringed base flow with its ghost rows filled, on the shard's device;
    z_offs[k] the global ringed row of its local row 0; p_int the volume's
    interior rows. duvw[k] (3,P_k,M,N) are the increments of each shard
    (interior rows 1..pz; ring not written). ``solve`` copies nothing from
    the host and reads nothing back: it is capturable in a CUDA graph.
    """
    t = _scalar_type(dtype)
    ax, ay, az = (float(t(a) / (t(h) * t(h)))
                  for a, h in zip(np.asarray(alpha, np.float64).reshape(3),
                                  (hx, hy, hz)))
    a_smooth = float(t(a_smooth))
    slabs = [(z_off, 1 if z_off == 0 else 0, p_int - z_off)
             for z_off in z_offs]
    blocks = _blocks(iterations, update_lag)
    if a_smooth == 1.0:
        sweep = halfsweep if use_kernels else halfsweep_plain
    else:
        field = psi_field if use_kernels else psi_field_plain
        sweep = halfsweep_psi if use_kernels else halfsweep_psi_plain
        params = psi_params(a_smooth, hx, hy, hz, dtype)

    def solve(Jc, weight, base):
        duvw = [torch.zeros_like(b) for b in base]
        if a_smooth == 1.0:
            def red_black(parity):
                for d, b, sj, slab in zip(duvw, base, SJ, slabs):
                    sweep(d, b, sj, ax, ay, az, parity, slab)
        else:
            psi = [torch.empty_like(b[0]) for b in base]

            def red_black(parity):
                for d, b, sj, p, slab in zip(duvw, base, SJ, psi, slabs):
                    sweep(d, b, sj, p, ax, ay, az, parity, slab)

        for k_iters in blocks:
            SJ = [torch.stack(tick_update(j, w, a_vecs[d.device], d[0], d[1],
                                          d[2]))
                  for j, w, d in zip(Jc, weight, duvw)]
            for _ in range(k_iters):
                exchange_ghosts(duvw)
                if a_smooth != 1.0:
                    for d, b, p, slab in zip(duvw, base, psi, slabs):
                        field(d, b, *params, out=p, slab=slab)
                    exchange_psi(psi, z_offs, p_int)
                red_black(0)
                exchange_ghosts(duvw)
                red_black(1)
        return duvw

    return solve


def build_level_sharded(key, devices):
    """The Z-sharded level solve of one configuration (``level_config_key``)
    over ``devices``, its host work (the split, the exponents on each
    shard's device, ``slab_solver``'s) done here once.

    Returns ``level(J, weight, u, v, w) -> (du, dv, dw)``: J 10 tensors
    (p,m,n,C) or their (10,p,m,n,C) stack, weight (p,m,n,C), u/v/w
    (p,m,n), all of the configuration's dtype; the result on u's device. The p - 2 interior z-rows are split
    in slabs of ceil((p-2) / n) rows, the last padded with inert rows; each
    slab keeps one ghost row a side.
    """
    (shape, C, alpha, iterations, update_lag, a_data, a_smooth, hx, hy, hz,
     dtype_name, use_kernels) = key
    dtype = getattr(torch, dtype_name)
    devices = batch_devices(devices)
    n = len(devices)
    p_int = shape[0] - 2
    pz = -(-p_int // n)
    pad = pz * n - p_int
    z_offs = [k * pz for k in range(n)]
    a_vecs = {d: data_exponents(np.asarray(a_data, np.float64), C, dtype, d)
              for d in dict.fromkeys(devices)}
    solve = slab_solver(z_offs, p_int, alpha, iterations, update_lag, a_vecs,
                        a_smooth, hx, hy, hz, dtype, use_kernels)

    def blocks(f):
        # rows appended past the bottom ring (edge copies) are inert
        fp = torch.cat([f, f[-1:].expand((pad,) + tuple(f.shape[1:]))])
        return [fp[k * pz:k * pz + pz + 2].to(dev).contiguous()
                for k, dev in enumerate(devices)]

    def level(J, weight, u, v, w):
        Jc = torch.stack([j.movedim(-1, 0) for j in J])  # (10, C, p, m, n)
        Jc_b = [b.movedim(0, 2).contiguous()
                for b in blocks(Jc.movedim(2, 0))]       # (10, C, P_k, m, n)
        w_b = [b.movedim(-1, 0).contiguous() for b in blocks(weight)]
        base_b = blocks(torch.stack([u, v, w]).movedim(1, 0))
        base_b = [b.movedim(0, 1).contiguous() for b in base_b]
        duvw = solve(Jc_b, w_b, base_b)
        interior = torch.cat([d[:, 1:-1].to(u.device) for d in duvw],
                             dim=1)[:, :p_int]
        full = torch.cat([interior[:, :1], interior, interior[:, -1:]], dim=1)
        return tuple(set_boundary_3d(full[k].clone()) for k in range(3))

    return level


def compute_flow_level_sharded(J_entries, weight, u, v, w, alpha, iterations,
                               update_lag, a_data, hx=1.0, hy=1.0, hz=1.0,
                               devices=None, a_smooth=1.0, use_kernels=True):
    """Z-sharded level solve (both a_smooth regimes).

    Same contract as ``core/solver.compute_flow_level``: J_entries 10
    tensors or arrays (p,m,n,C) [J11,J22,J33,J44,J12,J13,J23,J14,J24,J34]
    and weight (p,m,n,C) on boundary-ringed grids, u/v/w (p,m,n) tensors.
    The p - 2 interior z-rows are split over ``devices``
    (``batch_devices``; None: every card) in slabs of ceil((p-2) / n) rows
    (``build_level_sharded``). On CUDA the solve replays one CUDA graph per
    configuration and device list (kind ``"sharded_level"``, captured on
    the first call); on the CPU it runs eagerly. Returns (du, dv, dw), each
    (p,m,n) with its ring set, on u's device.
    """
    devices = batch_devices(devices, u.device)
    dtype = u.dtype
    if isinstance(a_data, torch.Tensor):
        a_data = a_data.cpu().numpy()       # the exponents are configuration
    J = torch.stack([torch.as_tensor(j).to(device=u.device, dtype=dtype)
                     for j in J_entries])
    weight = torch.as_tensor(weight).to(device=u.device, dtype=dtype)
    v, w = (x.to(dtype) for x in (v, w))
    key = level_config_key(tuple(u.shape), J.shape[-1], alpha, iterations,
                           update_lag, a_data, a_smooth, hx, hy, hz, dtype,
                           use_kernels)
    inputs = (J, weight, u, v, w)
    if u.device.type == "cuda":
        graph = _graph.cached(
            "sharded_level", (key, u.device), tuple(devices),
            lambda: _graph.BodyGraph(build_level_sharded(key, devices),
                                     [(x.shape, dtype) for x in inputs],
                                     u.device, devices))
        return graph.run(*inputs)
    return build_level_sharded(key, devices)(*inputs)
