"""Flow-driven-diffusivity SOR sweeps: the CUDA kernels of csrc/sor_psi.cu
and csrc/sor_psi_iterations.cu, their plain PyTorch versions, and the host
side.

Counterpart of ``flowreg3d_tpu/core/solver_pallas.py``:
``sweep_iterations_pallas_psi`` (and its y-tiled ``_sweep_iterations_psi_ty``)
is ``sor_iterations_psi``, one cooperative launch a tick block, whose plain
version is the loop ``sor_iterations_psi_plain``; ``halfsweep_pallas_psi``
is ``halfsweep_psi``; ``halfsweep_pallas`` (one ``a_smooth == 1``
half-sweep on the unfolded base) is ``halfsweep``. Fields are stacked: the
increments ``duvw`` and the base flow ``base`` (3,P,M,N), the data terms
``sj`` (9,P,M,N) in the order [SJ11,SJ22,SJ33,SJ12,SJ13,SJ23,SJ14,SJ24,
SJ34], the diffusivity ``psi`` (P,M,N). One iteration is ``psi_field``
from the pre-red increments, then the red and the black half-sweep with
that psi. The Z-sharded solver (``parallel/spatial.py``) runs the three
phases apart, in slab mode, to exchange ghost rows between them.

No kernel writes the increments' ring: ``psi_field`` reads the increments at
per-axis clamped indices and the half-sweeps take ``base_ghost + inc_centre``
across a Neumann face, which is what ``set_boundary_3d`` would have put
there. The caller applies ``set_boundary_3d`` to the result.

Every function takes an optional ``slab = (z_off, z_lo, z_hi)`` for a
z-slab of the volume with one ghost row a side (the Z-sharded solver,
``parallel/spatial.py``): ``z_off`` the global z of local row 0 (the
red-black parity is the volume's), ``z_lo`` the local row of the volume's
low face (1, or 0 when row 0 is a neighbour's row), ``z_hi`` the volume's
last interior row in local terms (rows past it are inert, the high face
applies there). The default, the whole volume, is ``(0, 1, P - 2)``.

Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises, and counts the launch.
"""

import ctypes

import torch

from flowreg3d_tpu_torch import _ext
from flowreg3d_tpu_torch.core.solver_kernel import _parity_mask, _scalar_type

OMEGA = 1.95
EPS_SMOOTH = 1e-5

_I = (slice(1, -1),) * 3
_DIRS = ("xm", "xp", "ym", "yp", "zm", "zp")


def set_boundary_3d(f):
    """Neumann copy boundaries over the last three axes, in place on ``f``
    ((P,M,N) or a (K,P,M,N) stack); returns ``f``."""
    f[..., 0, :] = f[..., 1, :]
    f[..., -1, :] = f[..., -2, :]
    f[..., :, 0] = f[..., :, 1]
    f[..., :, -1] = f[..., :, -2]
    f[..., 0, :, :] = f[..., 1, :, :]
    f[..., -1, :, :] = f[..., -2, :, :]
    return f


def psi_params(a_smooth, hx, hy, hz, dtype=torch.float32):
    """(a, a - 1, 0.5/hx, 0.5/hy, 0.5/hz), rounded in ``dtype`` as the
    kernel receives them."""
    t = _scalar_type(dtype)
    a = t(a_smooth)
    return (float(a), float(a - t(1.0)),
            *(float(t(0.5) / t(h)) for h in (hx, hy, hz)))


def _nbr(f):
    """Six neighbour views of the interior of a full-grid (P,M,N) tensor."""
    return dict(
        xm=f[1:-1, 1:-1, :-2], xp=f[1:-1, 1:-1, 2:],
        ym=f[1:-1, :-2, 1:-1], yp=f[1:-1, 2:, 1:-1],
        zm=f[:-2, 1:-1, 1:-1], zp=f[2:, 1:-1, 1:-1],
    )


def _clamped_shift(f, axis, step):
    """f at index i + step along ``axis``, the index clamped to the grid."""
    n = f.shape[axis]
    if step > 0:
        return torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)],
                         dim=axis)
    return torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)],
                     dim=axis)


def _slab(slab, P):
    """(z_off, z_lo, z_hi) of a slab; None is the whole volume."""
    return (0, 1, P - 2) if slab is None else tuple(int(v) for v in slab)


def _clamp_rows(f, lo, hi):
    """``f`` (..., P, M, N) with each z-row q replaced by row clamp(q, lo,
    hi)."""
    P = f.shape[-3]
    idx = torch.arange(P, device=f.device).clamp(lo, hi)
    return f.index_select(-3, idx)


def _set_faces(duvw, z_lo, z_hi):
    """The increments with the ring's values a sweep reads: y and x Neumann
    copies, and the z-faces a slab holds (row 0 from row 1 at the low face,
    the rows past ``z_hi`` from row ``z_hi``); the neighbours' ghost rows
    stay as they are."""
    P = duvw.shape[-3]
    if (z_lo, z_hi) == (1, P - 2):
        return set_boundary_3d(duvw.clone())
    f = duvw.clone()
    f[..., 0, :] = f[..., 1, :]
    f[..., -1, :] = f[..., -2, :]
    f[..., :, 0] = f[..., :, 1]
    f[..., :, -1] = f[..., :, -2]
    i_lo = 1 if z_lo == 1 else 0
    return _clamp_rows(f, i_lo, min(max(z_hi, i_lo), P - 1))


def psi_field_plain(duvw, base, a, expo, ihx, ihy, ihz, out=None,
                    slab=None):
    """Plain version of ``psi_field_f32``: a * (|grad(base + inc)|^2 + eps)
    ^ (a - 1) over the full grid, inc read with its ring set by
    ``set_boundary_3d``; rsqrt when a - 1 == -0.5. In a slab the increment's
    z is clamped to [z_lo, z_hi] and the grid's to [0, z_hi + 1]."""
    P = duvw.shape[-3]
    _, z_lo, z_hi = _slab(slab, P)
    tot = base + _set_faces(duvw, z_lo, z_hi)
    g_hi = min(max(z_hi + 1, 0), P - 1)
    if g_hi < P - 1:
        tot = _clamp_rows(tot, 0, g_hi)
    g = torch.zeros_like(tot[0])
    for c in range(3):
        for axis, ih in ((0, ihz), (1, ihy), (2, ihx)):
            d = (_clamped_shift(tot[c], axis, 1)
                 - _clamped_shift(tot[c], axis, -1)) * ih
            g = g + d * d
    s = g + EPS_SMOOTH
    psi = a * (torch.rsqrt(s) if expo == -0.5 else torch.pow(s, expo))
    if out is None:
        return psi
    return out.copy_(psi)


def _halfsweep_plain(duvw, base, sj, weights, sw_sum, parity, slab=None):
    """One masked half-sweep in place on the interior of ``duvw``; weights
    and sw_sum are tensors over the interior or Python floats. In a slab
    only rows 1..z_hi are updated."""
    P = duvw.shape[-3]
    z_off, z_lo, z_hi = _slab(slab, P)
    tot = base + _set_faces(duvw, z_lo, z_hi)
    c = duvw[(slice(None),) + _I]
    s = sj[(slice(None),) + _I]
    du, dv, dw = c[0], c[1], c[2]
    num_data = (-(s[6] + s[3] * dv + s[4] * dw),
                -(s[7] + s[3] * du + s[5] * dw),
                -(s[8] + s[4] * du + s[5] * dv))
    new = []
    for k, old in enumerate((du, dv, dw)):
        nb = _nbr(tot[k])
        base_c = base[k][_I]
        num = num_data[k]
        for d in _DIRS:
            num = num + weights[d] * (nb[d] - base_c)
        den = s[k] + sw_sum
        frac = torch.where(den != 0, num / den, torch.zeros_like(den))
        new.append((1.0 - OMEGA) * old + OMEGA * frac)
    mask = _parity_mask(*duvw.shape[1:], parity, duvw.device, z_off)
    if z_hi < P - 2:
        mask[max(z_hi, 0):] = False
    c.copy_(torch.where(mask, torch.stack(new), c))
    return duvw


def halfsweep_psi_plain(duvw, base, sj, psi, ax, ay, az, parity, slab=None):
    """Plain version of ``sor_halfsweep_psi_f32``: weights
    0.5 (psi_c + psi_nbr) a_dir."""
    pc = psi[_I]
    nb = _nbr(psi)
    scale = dict(xm=ax, xp=ax, ym=ay, yp=ay, zm=az, zp=az)
    weights = {d: 0.5 * (pc + nb[d]) * scale[d] for d in _DIRS}
    sw_sum = weights["xm"]
    for d in _DIRS[1:]:
        sw_sum = sw_sum + weights[d]
    return _halfsweep_plain(duvw, base, sj, weights, sw_sum, parity, slab)


def halfsweep_plain(duvw, base, sj, ax, ay, az, parity, slab=None):
    """Plain version of ``sor_halfsweep_const_f32``: weights a_dir."""
    t = _scalar_type(duvw.dtype)
    weights = dict(xm=ax, xp=ax, ym=ay, yp=ay, zm=az, zp=az)
    sw_sum = t(ax)
    for d in _DIRS[1:]:
        sw_sum = sw_sum + t(weights[d])
    return _halfsweep_plain(duvw, base, sj, weights, float(sw_sum), parity,
                            slab)


def _check_stacks(name, duvw, base, sj=None, psi=None):
    tensors = [t for t in (duvw, base, sj, psi) if t is not None]
    if any(t.device != duvw.device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}"
                         "; want one device")
    if duvw.device.type == "cpu":
        return False
    _ext.check_cuda(duvw, f"{name} duvw", 4, torch.float32)
    _ext.check_cuda(base, f"{name} base", 4, torch.float32)
    if sj is not None:
        _ext.check_cuda(sj, f"{name} sj", 4, torch.float32)
    if psi is not None:
        _ext.check_cuda(psi, f"{name} psi", 3, torch.float32)
    _, P, M, N = duvw.shape
    if (duvw.shape[0] != 3 or base.shape != duvw.shape
            or (sj is not None and sj.shape != (9, P, M, N))
            or (psi is not None and psi.shape != (P, M, N))
            or min(P, M, N) < 3):
        raise ValueError(
            f"{name}: duvw {tuple(duvw.shape)}, base {tuple(base.shape)}, sj "
            f"{None if sj is None else tuple(sj.shape)}, psi "
            f"{None if psi is None else tuple(psi.shape)}; want (3,P,M,N), "
            "(3,P,M,N), (9,P,M,N), (P,M,N), P,M,N >= 3")
    return True


def psi_field(duvw, base, a, expo, ihx, ihy, ihz, out=None, slab=None):
    """Diffusivity psi (P,M,N) of base + duvw; into ``out`` when given."""
    if not _check_stacks("psi_field", duvw, base, psi=out):
        return psi_field_plain(duvw, base, a, expo, ihx, ihy, ihz, out, slab)
    _, P, M, N = duvw.shape
    _, z_lo, z_hi = _slab(slab, P)
    if out is None:
        out = torch.empty((P, M, N), dtype=duvw.dtype, device=duvw.device)
    with torch.cuda.device(duvw.device):
        rc = _ext.lib().psi_field_f32(
            duvw.data_ptr(), base.data_ptr(), out.data_ptr(), P, M, N,
            float(a), float(expo), float(ihx), float(ihy), float(ihz),
            z_lo, z_hi, _ext.stream_of(duvw))
    _ext.raise_on_error(rc, "psi_field_f32")
    psi_field.launches += 1
    return out


def halfsweep_psi(duvw, base, sj, psi, ax, ay, az, parity, slab=None):
    """One red (parity 0) or black (1) psi half-sweep, in place on duvw."""
    if not _check_stacks("halfsweep_psi", duvw, base, sj, psi):
        return halfsweep_psi_plain(duvw, base, sj, psi, ax, ay, az, parity,
                                   slab)
    _, P, M, N = duvw.shape
    with torch.cuda.device(duvw.device):
        rc = _ext.lib().sor_halfsweep_psi_f32(
            duvw.data_ptr(), base.data_ptr(), sj.data_ptr(), psi.data_ptr(),
            P, M, N, float(ax), float(ay), float(az), int(parity),
            *_slab(slab, P), _ext.stream_of(duvw))
    _ext.raise_on_error(rc, "sor_halfsweep_psi_f32")
    halfsweep_psi.launches += 1
    return duvw


def halfsweep(duvw, base, sj, ax, ay, az, parity, slab=None):
    """One constant-weight (a_smooth == 1) half-sweep on the unfolded base,
    in place on duvw."""
    if not _check_stacks("halfsweep", duvw, base, sj):
        return halfsweep_plain(duvw, base, sj, ax, ay, az, parity, slab)
    _, P, M, N = duvw.shape
    with torch.cuda.device(duvw.device):
        rc = _ext.lib().sor_halfsweep_const_f32(
            duvw.data_ptr(), base.data_ptr(), sj.data_ptr(), P, M, N,
            float(ax), float(ay), float(az), int(parity), *_slab(slab, P),
            _ext.stream_of(duvw))
    _ext.raise_on_error(rc, "sor_halfsweep_const_f32")
    halfsweep.launches += 1
    return duvw


psi_field.launches = 0
halfsweep_psi.launches = 0
halfsweep.launches = 0


def sor_iterations_psi_plain(duvw, base, sj, params, n_iters, psi=None):
    """Plain version of ``sor_iterations_psi_f32``: ``n_iters`` psi -> red
    -> black iterations of ``psi_field_plain`` and ``halfsweep_psi_plain``
    in place on ``duvw``; ``psi`` an optional (P,M,N) buffer."""
    a, expo, ihx, ihy, ihz, ax, ay, az = params
    for _ in range(n_iters):
        psi = psi_field_plain(duvw, base, a, expo, ihx, ihy, ihz, out=psi)
        halfsweep_psi_plain(duvw, base, sj, psi, ax, ay, az, 0)
        halfsweep_psi_plain(duvw, base, sj, psi, ax, ay, az, 1)
    return duvw


def sor_iterations_psi(duvw, base, sj, params, n_iters, scratch=None,
                       mode=None):
    """One tick block of ``n_iters`` psi -> red -> black iterations in place
    on ``duvw`` (whole volume): one cooperative launch on CUDA tensors.
    params: psi_params(...) + (ax, ay, az). ``scratch``: a (3,P,M,N)
    buffer the kernel works in (allocated here when None); its contents
    are overwritten. ``mode``: None runs the plan's mode for the level's
    size; a name in ``PSI_MODES`` asks for that one (to compare them)."""
    if not _check_stacks("sor_iterations_psi", duvw, base, sj):
        return sor_iterations_psi_plain(duvw, base, sj, params, n_iters)
    if scratch is None:
        scratch = torch.empty_like(duvw)
    _ext.check_cuda(scratch, "sor_iterations_psi scratch", 4, torch.float32)
    if (scratch.shape != duvw.shape or scratch.device != duvw.device
            or scratch.data_ptr() == duvw.data_ptr()):
        raise ValueError(f"sor_iterations_psi: scratch {tuple(scratch.shape)}"
                         f" on {scratch.device}; want a second "
                         f"{tuple(duvw.shape)} buffer on {duvw.device}")
    if n_iters <= 0:
        return duvw
    _, P, M, N = duvw.shape
    with torch.cuda.device(duvw.device):
        rc = _ext.lib().sor_iterations_psi_f32(
            duvw.data_ptr(), scratch.data_ptr(), base.data_ptr(),
            sj.data_ptr(), P, M, N, *(float(p) for p in params),
            int(n_iters), _mode_code(mode), _ext.stream_of(duvw))
    _ext.raise_on_error(rc, "sor_iterations_psi_f32")
    sor_iterations_psi.launches += 1
    return duvw


sor_iterations_psi.launches = 0

PSI_MODES = {1: "phases in turn", 2: "streamed"}


def _mode_code(mode):
    if mode is None:
        return 0
    codes = {v: k for k, v in PSI_MODES.items()}
    if mode not in codes:
        raise ValueError(f"sor_iterations_psi: mode {mode!r}; want None or "
                         f"one of {sorted(codes)}")
    return codes[mode]


def psi_tick_plan(shape, device=None, mode=None):
    """How ``sor_iterations_psi_f32`` runs at duvw shape (3,P,M,N) or
    (P,M,N) on a CUDA device (in ``mode``, None: by size): mode, blocks,
    threads a block, planes a z-chunk, chunks and (y, x) tiles of a work
    item, dynamic shared bytes a block."""
    P, M, N = shape[-3:]
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        _ext.raise_on_error(_ext.lib().sor_iterations_psi_plan(
            P, M, N, _mode_code(mode), out), "sor_iterations_psi_plan")
    plan = dict(zip(("mode", "blocks", "threads", "z_chunk", "chunks",
                     "tiles", "shared_bytes"), out))
    plan["mode"] = PSI_MODES[plan["mode"]]
    return plan


def sweep_iterations_psi(duvw, base, sj, params, n_iters, use_kernels=True,
                         psi=None, scratch=None):
    """One tick block of ``n_iters`` psi -> red -> black iterations in place
    on ``duvw``: one launch of ``sor_iterations_psi`` (``scratch`` its
    working buffer), or with ``use_kernels=False`` the plain loop on any
    device (``psi`` its diffusivity buffer)."""
    if use_kernels:
        return sor_iterations_psi(duvw, base, sj, params, n_iters, scratch)
    return sor_iterations_psi_plain(duvw, base, sj, params, n_iters, psi)
