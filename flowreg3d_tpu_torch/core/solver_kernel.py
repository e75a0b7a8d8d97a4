"""Constant-diffusivity SOR tick blocks: the CUDA kernel
``sor_iterations_f32`` (csrc/sor_halfsweep.cu), its plain PyTorch version,
and the host side.

Counterpart of ``flowreg3d_tpu/core/solver_pallas.py:sweep_iterations_pallas``
(and its y-tiled ``_sweep_iterations_ty``). The base flow enters a level's
update only through its weighted Laplacian, which is constant over the
level, so the host folds it into the SJ14/24/34 data terms and the kernel
reads 12 fields: the stacked increments duvw (3,P,M,N) and SJ (9,P,M,N)
in the order [SJ11,SJ22,SJ33,SJ12,SJ13,SJ23,SJ14,SJ24,SJ34]. One
cooperative launch runs a whole tick block (``n_iters`` red+black
iterations); its plain version is the loop of ``sor_halfsweep_plain``
half-sweeps. ``sor_iterations`` takes the plain version only for CPU
tensors, and for CUDA tensors launches the kernel or raises.
"""

import ctypes

import numpy as np
import torch

from flowreg3d_tpu_torch import _ext

OMEGA = 1.95


def _scalar_type(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _stencil_sum(ax, ay, az, dtype):
    """2 (ax + ay + az) rounded as the kernel computes it."""
    t = _scalar_type(dtype)
    return float(t(2.0) * (t(ax) + t(ay) + t(az)))


def _parity_mask(P, M, N, parity, device):
    """(P-2, M-2, N-2) mask of interior cells with (z+y+x) % 2 == parity."""
    z, y, x = (torch.arange(1, n - 1, device=device) for n in (P, M, N))
    return ((z[:, None, None] + y[None, :, None] + x[None, None, :]) % 2
            == parity)


def _clamped_nbr_sum(f, ax, ay, az):
    """Weighted 6-neighbour sum over an interior block; a neighbour across a
    Neumann face reads the centre value."""
    xm = torch.cat([f[..., :1], f[..., :-1]], dim=-1)
    xp = torch.cat([f[..., 1:], f[..., -1:]], dim=-1)
    ym = torch.cat([f[:, :1], f[:, :-1]], dim=1)
    yp = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
    zm = torch.cat([f[:1], f[:-1]], dim=0)
    zp = torch.cat([f[1:], f[-1:]], dim=0)
    return ax * (xm + xp) + ay * (ym + yp) + az * (zm + zp)


def sor_halfsweep_plain(duvw, sj, ax, ay, az, parity):
    """Plain version of the kernel: one half-sweep in place on ``duvw``."""
    _, P, M, N = duvw.shape
    c = duvw[:, 1:-1, 1:-1, 1:-1]
    s = sj[:, 1:-1, 1:-1, 1:-1]
    du, dv, dw = c[0], c[1], c[2]
    sw = _stencil_sum(ax, ay, az, duvw.dtype)
    nu = -(s[6] + s[3] * dv + s[4] * dw) + _clamped_nbr_sum(du, ax, ay, az)
    nv = -(s[7] + s[3] * du + s[5] * dw) + _clamped_nbr_sum(dv, ax, ay, az)
    nw = -(s[8] + s[4] * du + s[5] * dv) + _clamped_nbr_sum(dw, ax, ay, az)
    new = torch.stack([
        (1.0 - OMEGA) * du + OMEGA * nu / (s[0] + sw),
        (1.0 - OMEGA) * dv + OMEGA * nv / (s[1] + sw),
        (1.0 - OMEGA) * dw + OMEGA * nw / (s[2] + sw),
    ])
    mask = _parity_mask(P, M, N, parity, duvw.device)
    c.copy_(torch.where(mask, new, c))
    return duvw


def sor_iterations_plain(duvw, sj, ax, ay, az, n_iters):
    """Plain version of the kernel: ``n_iters`` red+black iterations of
    ``sor_halfsweep_plain`` in place on ``duvw``."""
    for _ in range(n_iters):
        sor_halfsweep_plain(duvw, sj, ax, ay, az, 0)
        sor_halfsweep_plain(duvw, sj, ax, ay, az, 1)
    return duvw


def sor_iterations(duvw, sj, ax, ay, az, n_iters):
    """One tick block, ``n_iters`` red (parity 0) + black (1) iterations in
    place on ``duvw``: one kernel launch on CUDA tensors."""
    if duvw.device != sj.device:
        raise ValueError(f"sor_iterations: duvw on {duvw.device}, sj on "
                         f"{sj.device}")
    if duvw.device.type == "cpu":
        return sor_iterations_plain(duvw, sj, ax, ay, az, n_iters)
    _ext.check_cuda(duvw, "sor_iterations duvw", 4, torch.float32)
    _ext.check_cuda(sj, "sor_iterations sj", 4, torch.float32)
    _, P, M, N = duvw.shape
    if duvw.shape[0] != 3 or sj.shape != (9, P, M, N) or min(P, M, N) < 3:
        raise ValueError(f"sor_iterations: duvw {tuple(duvw.shape)} / sj "
                         f"{tuple(sj.shape)}; want (3,P,M,N) / (9,P,M,N), "
                         "P,M,N >= 3")
    if n_iters <= 0:
        return duvw
    with torch.cuda.device(duvw.device):
        rc = _ext.lib().sor_iterations_f32(
            duvw.data_ptr(), sj.data_ptr(), P, M, N, float(ax), float(ay),
            float(az), int(n_iters), _ext.stream_of(duvw))
    _ext.raise_on_error(rc, "sor_iterations_f32")
    sor_iterations.launches += 1
    return duvw


sor_iterations.launches = 0

SOR_MODES = {1: "SJ on chip", 2: "SJ streamed"}


def sor_plan(shape, device=None):
    """How ``sor_iterations_f32`` runs at duvw shape (3,P,M,N) or (P,M,N)
    on a CUDA device: mode, blocks, threads, rows and shared bytes a
    block."""
    P, M, N = shape[-3:]
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _ext.raise_on_error(_ext.lib().sor_iterations_plan(P, M, N, out),
                            "sor_iterations_plan")
    mode, blocks, threads, rows, smem = out
    return dict(mode=SOR_MODES[mode], blocks=blocks, threads=threads,
                rows_per_block=rows, shared_bytes=smem)


def base_laplacian(b, ax, ay, az):
    """Weighted Laplacian of a base-flow component over the full grid.

    Rolls wrap at the ring; wrapped values land only on ring cells, which
    the sweep never updates.
    """
    return (ax * (torch.roll(b, 1, 2) + torch.roll(b, -1, 2) - 2.0 * b)
            + ay * (torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 2.0 * b)
            + az * (torch.roll(b, 1, 0) + torch.roll(b, -1, 0) - 2.0 * b))


def fold_base(SJ, laps):
    """Stack the 9 reduced data terms with the base Laplacians folded into
    SJ14/24/34 -> contiguous (9, P, M, N)."""
    return torch.stack([*SJ[:6], SJ[6] - laps[0], SJ[7] - laps[1],
                        SJ[8] - laps[2]])


def sweep_iterations(duvw, sj, ax, ay, az, n_iters, use_kernels=True):
    """One tick block of ``n_iters`` red+black iterations in place: one
    launch (``use_kernels=False``: the plain version on any device)."""
    sweep = sor_iterations if use_kernels else sor_iterations_plain
    return sweep(duvw, sj, ax, ay, az, n_iters)
