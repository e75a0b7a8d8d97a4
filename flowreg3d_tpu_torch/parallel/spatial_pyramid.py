"""Z-sharded full pyramid: ``get_displacement`` for volumes beyond one card.

Counterpart of ``flowreg3d_tpu/parallel/spatial_pyramid.py``, with its
static plan, on one controller and a list of shards (``parallel/mesh.py``:
a device may repeat) instead of ``shard_map``:

- **Fine levels** (z-extent >= 4 * n_shards) are sharded, ceil(z / n) rows
  a shard, the last padded with rows whose results are dropped. The
  stencil stages run on halo-extended slabs and are cropped: the motion
  tensor on a ``symmetric`` halo of ``halo`` rows, the 5^3 median on a
  ``reflect`` halo of 2 (``median5_f32`` on the extended slab). Resizes and
  the cubic warp's z-prefilter contract z with **ring matmuls**: each step
  multiplies the slab a shard holds by the matching block of a static
  matrix, then every shard passes its slab to the previous one. The SOR
  solve is ``parallel/spatial.solve_slabs`` (the slab-mode kernels).
- **Coarse levels** run replicated: computed once, on the first shard's
  device, by the single-device level (``core/pyramid.level_step``), which
  every shard would compute alike.
- The level warp samples z within +-``halo_w`` rows of a shard's own
  (``map_coords_f32`` on the halo-extended coefficient window); a flow
  that needs more clears the returned ``valid`` flag, and the caller
  recomputes that volume on one device.

Halos, ring steps and the gathers onto the first shard move by
``peer_copy`` (counted). Tensors of a shard live on its device; the result
is gathered onto the first shard's device.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from flowreg3d_tpu_torch.core.motion_tensor import MOTION_TENSORS
from flowreg3d_tpu_torch.core.pyramid import (add_boundary, level_alpha,
                                              level_schedule, level_step)
from flowreg3d_tpu_torch.core.solver import data_exponents
from flowreg3d_tpu_torch.ops.median_kernel import median5, median5_plain
from flowreg3d_tpu_torch.ops.resize import _axis_sigmas, _resize_matrix_np
from flowreg3d_tpu_torch.ops.warp import _bspline_prefilter_mat_np
from flowreg3d_tpu_torch.ops.warp_kernel import map_coords, map_coords_plain
from flowreg3d_tpu_torch.parallel.mesh import (batch_devices, peer_copy,
                                               replicate)
from flowreg3d_tpu_torch.parallel.spatial import (edge_fix, exchange_ghosts,
                                                  solve_slabs)

_DEF_HALO = 4     # redundant-stencil halo (max stencil radius is 4)
_DEF_HALO_W = 6   # warp z-sampling halo (max |w|/hz the warp can express)
_I = (slice(1, -1),) * 3


# -- static matrices ----------------------------------------------------------

def _sym_pad_rows(M, rows_needed):
    """Extend a (out, in) matrix so padded output rows reproduce np.pad
    'symmetric' of the true output (row z_out + j == row z_out - 1 - j)."""
    out_len = M.shape[0]
    extra = rows_needed - out_len
    if extra <= 0:
        return M[:rows_needed]
    refl = [M[out_len - 1 - (j % out_len)] for j in range(extra)]
    return np.concatenate([M, np.stack(refl)], axis=0)


# The z, y and x matrices below are named by (make, args) pairs, so that
# ``_dev_mat`` builds and uploads each once a device.

def _resize_mat(in_shape, out_shape, axis):
    """The dense fused-Gauss-cubic resize matrix of one axis (pyramid sigma
    rule)."""
    sigma = _axis_sigmas(in_shape, out_shape, 0.6, False)[axis]
    return _resize_matrix_np(in_shape[axis], out_shape[axis], float(sigma))


def _z_mat(in_shape, out_shape, cols, rows):
    """The z resize matrix with zero columns for the input's shard padding
    (``cols`` in all) and symmetric rows for the output's (``rows``)."""
    Mz = _resize_mat(in_shape, out_shape, 0)
    return _sym_pad_rows(np.pad(Mz, ((0, 0), (0, cols - in_shape[0]))), rows)


def _prefilter_z_mat(z_len, pz, n, halo_w):
    """The z prefilter of a sharded level with ``halo_w`` rows above: the
    ring matmul's rows [k*pz, k*pz + pz + 2 halo_w + 4) are shard k's
    coefficient window. One row more than JAX's window, so that
    ``map_coords``' clamp to the window never moves a sample the window
    holds."""
    Mpre = _bspline_prefilter_mat_np(z_len)               # (z + 3, z)
    return np.pad(Mpre, ((halo_w, pz * n + halo_w + 4 - Mpre.shape[0]),
                         (0, pz * n - z_len)))


@lru_cache(maxsize=1024)
def _dev_mat(make, args, device, dtype):
    """The numpy matrix ``make(*args)`` as a tensor on ``device``, built
    and uploaded once."""
    return torch.as_tensor(make(*args), dtype=dtype).to(device)


@lru_cache(maxsize=1024)
def _mirror_rows(k, pz, H, mode, z_total, device):
    """Row index of shard k's extended slab (pz + 2H rows) after the
    numpy-pad fold of global rows outside [0, z_total); None if no row
    moves."""
    g = np.arange(pz + 2 * H) - H + k * pz
    if mode == "symmetric":
        src = np.where(g < 0, -1 - g,
                       np.where(g >= z_total, 2 * z_total - 1 - g, g))
    elif mode == "reflect":
        src = np.where(g < 0, -g, np.where(g >= z_total, 2 * z_total - 2 - g,
                                           g))
    else:  # edge
        src = np.clip(g, 0, z_total - 1)
    loc = np.clip(src - k * pz + H, 0, pz + 2 * H - 1)
    if np.array_equal(loc, np.arange(pz + 2 * H)):
        return None
    return torch.as_tensor(loc, dtype=torch.long).to(device)


# -- collectives on a list of shards ------------------------------------------

def _halo_exchange(slabs, H, mode, z_total):
    """Extend each shard's (pz, ...) slab with H neighbour rows a side.

    Shard k holds global rows [k*pz, (k+1)*pz). Every extended row whose
    global index lies outside [0, z_total), the volume's face halos and
    the shard padding past its end, then takes the numpy pad ``mode``
    ('symmetric', 'reflect' or 'edge') by a gather from the extended slab.
    """
    n, pz = len(slabs), slabs[0].shape[0]
    out = []
    for k, f in enumerate(slabs):
        ext = f.new_empty((pz + 2 * H,) + tuple(f.shape[1:]))
        ext[H:H + pz].copy_(f)
        if k > 0:
            peer_copy(ext[:H], slabs[k - 1][pz - H:])
        if k < n - 1:
            peer_copy(ext[H + pz:], slabs[k + 1][:H])
        idx = _mirror_rows(k, pz, H, mode, z_total, f.device)
        out.append(ext if idx is None else ext.index_select(0, idx))
    return out


def _z_contract(M, x):
    """M (o, r) applied to the leading axis of x (r, ...) -> (o, ...)."""
    return (M @ x.reshape(x.shape[0], -1)).reshape(
        (M.shape[0],) + tuple(x.shape[1:]))


def _ring_matmul_z(x, M, rows_per_dev, out_rows_per_dev, out_stride=None):
    """Sharded z-contraction: shard k gets M[k*stride : k*stride + out_rows]
    @ x, x being the concatenation of the shards' slabs (rows_per_dev rows
    each). Ring step s: shard k multiplies the slab it holds (shard (k+s) %
    n's) by its block of M, then takes the next shard's slab; peak memory
    is a slab and the output. ``M`` is a (make, args) pair
    (``_dev_mat``)."""
    n = len(x)
    stride = out_rows_per_dev if out_stride is None else out_stride
    mats = [_dev_mat(*M, xk.device, xk.dtype)[k * stride:k * stride
                                              + out_rows_per_dev]
            for k, xk in enumerate(x)]
    acc = [None] * n
    cur = list(x)
    for s in range(n):
        for k in range(n):
            src = (k + s) % n
            part = _z_contract(mats[k][:, src * rows_per_dev:
                                       (src + 1) * rows_per_dev], cur[k])
            acc[k] = part if s == 0 else acc[k] + part
        if s < n - 1:
            nxt = [torch.empty_like(c, memory_format=torch.contiguous_format)
                   for c in cur]
            for k in range(n):
                peer_copy(nxt[k], cur[(k + 1) % n])
            cur = nxt
    return acc


def _replicated_from_sharded(x, M, rows_per_dev, home):
    """M @ x (x sharded) on ``home``: each shard's partial product, summed
    there in shard order. ``M`` is a (make, args) pair."""
    acc = None
    for k, xk in enumerate(x):
        part = _z_contract(_dev_mat(*M, xk.device, xk.dtype)[
            :, k * rows_per_dev:(k + 1) * rows_per_dev], xk)
        if k > 0 or part.device != home:
            part = peer_copy(torch.empty_like(part, device=home), part)
        acc = part if acc is None else acc + part
    return acc


# -- local stages -------------------------------------------------------------

def _apply_yx(x, My, Mx):
    """The y then x resize passes of a (z, Y, X, ...) tensor; ``My``, ``Mx``
    are (make, args) pairs."""
    My = _dev_mat(*My, x.device, x.dtype)
    Mx = _dev_mat(*Mx, x.device, x.dtype)
    z, Y, X = x.shape[:3]
    t = torch.matmul(My, x.reshape(z, Y, -1))            # (z, h, X * c)
    t = torch.matmul(Mx, t.reshape(z * My.shape[0], X, -1))
    return t.reshape((z, My.shape[0], Mx.shape[0]) + tuple(x.shape[3:]))


def _prefilter_yx(x):
    """The x then y cubic-B-spline prefilter passes of a (z, Y, X) slab ->
    (z, Y + 3, X + 3), as ``ops/warp.bspline_prefilter`` orders them."""
    z, Y, X = x.shape
    px = _dev_mat(_bspline_prefilter_mat_np, (X,), x.device, x.dtype)
    py = _dev_mat(_bspline_prefilter_mat_np, (Y,), x.device, x.dtype)
    t = (x.reshape(z * Y, X) @ px.T).reshape(z, Y, X + 3)
    return torch.matmul(py, t)


def _warp_local(coeff, f1, uvw, z_start, halo_w, size, h, use_kernels):
    """Tricubic warp of a shard's rows from its coefficient window.

    ``coeff`` (pz + 2 halo_w + 4, Y + 3, X + 3): the level's B-spline
    coefficients of z-taps [z_start - halo_w - 1, ...). f1 (pz, Y, X) the
    fixed slab, uvw (pz, Y, X, 3) the flow in original units. As JAX, the
    coordinate is clamped to the level, then located in the window; a row
    of the level (not shard padding) whose taps leave JAX's window clears
    the flag. Returns (warped (pz, Y, X), valid 0-d bool tensor).
    """
    Zl, Yl, Xl = size
    hz, hy, hx = h
    pz = f1.shape[0]
    dt, dev = uvw.dtype, uvw.device
    gz = (torch.arange(pz, dtype=dt, device=dev) + z_start)[:, None, None]
    gy = torch.arange(Yl, dtype=dt, device=dev)[None, :, None]
    gx = torch.arange(Xl, dtype=dt, device=dev)[None, None, :]
    mx = gx + uvw[..., 0] / hx
    my = gy + uvw[..., 1] / hy
    mz = gz + uvw[..., 2] / hz
    oob = ((mx < 0) | (mx >= Xl) | (my < 0) | (my >= Yl)
           | (mz < 0) | (mz >= Zl))
    cx = torch.where(oob, gx, mx.clamp(0, Xl - 1)).contiguous()
    cy = torch.where(oob, gy, my.clamp(0, Yl - 1)).contiguous()
    cz = torch.where(oob, gz, mz.clamp(0, Zl - 1))
    lo = z_start - halo_w
    lz = torch.floor(cz) - lo
    ok = ((lz >= 0) & (lz <= pz + 2 * halo_w - 1)) | (gz >= Zl)
    sample = map_coords if use_kernels else map_coords_plain
    out = sample(coeff, (cz - lo).contiguous(), cy, cx, 3)
    return torch.where(oob, f1, out), ok.all()


def _median_sharded(d, z_total, use_kernels):
    """5^3 medians of the three increments' slabs, d[k] (3, pz, Y, X),
    'reflect' at the volume's faces: one launch a shard."""
    ext = _halo_exchange([x.transpose(0, 1) for x in d], 2, "reflect",
                         z_total)
    out = []
    for x in ext:
        xp = F.pad(x.transpose(0, 1), (2, 2, 2, 2), mode="reflect")
        xp = xp.contiguous()
        out.append(median5(xp) if use_kernels else median5_plain(xp))
    return out


# -- the pyramid --------------------------------------------------------------

def _shard_z(x, pz, devices, dtype):
    """(Z, ...) array or tensor -> slabs of pz rows on the shards' devices,
    the last edge-padded."""
    x = torch.as_tensor(x)
    pad = pz * len(devices) - x.shape[0]
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return [x[k * pz:(k + 1) * pz].to(device=dev, dtype=dtype).contiguous()
            for k, dev in enumerate(devices)]


def get_displacement_sharded(fixed, moving, devices=None,
                             alpha=(2.0, 2.0, 2.0), update_lag=10,
                             iterations=20, min_level=0, levels=50, eta=0.8,
                             a_data=0.45, const_assumption="gc", uvw=None,
                             weight=None, halo=_DEF_HALO, halo_w=_DEF_HALO_W,
                             dtype=torch.float32, a_smooth=1.0, device=None,
                             use_kernels=True):
    """Z-sharded drop-in for ``get_displacement`` (both a_smooth regimes),
    with JAX ``get_displacement_sharded``'s defaults.

    fixed/moving (Z,Y,X) or (Z,Y,X,C), arrays or tensors. ``devices``: the
    shards (``batch_devices``; None: every card when ``device`` is CUDA,
    None meaning 'cuda'). ``weight`` a per-channel vector (C,) or a volume
    (Z,Y,X,C), sharded with the inputs (None: 1/C). ``use_kernels=False``
    runs the kernels' plain versions. Returns (flow (Z,Y,X,3) on the first
    shard's device, valid): ``valid`` (0-d bool tensor) is False when a
    level's warp needed z-samples beyond ``halo_w`` rows; recompute that
    volume on one device then.
    """
    devices = batch_devices(devices, device)
    n, home = len(devices), devices[0]
    fixed, moving = torch.as_tensor(fixed), torch.as_tensor(moving)
    if fixed.dim() == 3:
        fixed, moving = fixed[..., None], moving[..., None]
    Z, Y, X, C = fixed.shape
    pz_in = -(-Z // n)

    fixed_s = _shard_z(fixed, pz_in, devices, dtype)
    moving_s = _shard_z(moving, pz_in, devices, dtype)
    if uvw is None:
        uvw_s = [torch.zeros((pz_in, Y, X, 3), dtype=dtype, device=d)
                 for d in devices]
    else:
        uvw_s = _shard_z(uvw, pz_in, devices, dtype)
    if weight is None:
        weight_s = [torch.full((pz_in, Y, X, C), 1.0 / C, dtype=dtype,
                               device=d) for d in devices]
    elif torch.as_tensor(weight).dim() == 1:
        weight_s = [torch.as_tensor(weight).to(device=d, dtype=dtype)
                    .reshape(1, 1, 1, C).expand(pz_in, Y, X, C)
                    .contiguous() for d in devices]
    else:
        weight_s = _shard_z(weight, pz_in, devices, dtype)

    plan, eff_min_level, _ = level_schedule((Z, Y, X), eta, levels,
                                            min_level)
    motion_tensor = MOTION_TENSORS[const_assumption]
    a_data_arr = np.asarray(a_data, np.float64).reshape(-1)
    if a_data_arr.size == 1:
        a_data_arr = np.repeat(a_data_arr, C)
    a_home = data_exponents(a_data_arr, C, dtype, home)

    def from_input(slabs, size, sharded, pz_l):
        """A level volume from the full-resolution sharded input (z first,
        then the local y and x passes on the smaller z-extent)."""
        My, Mx = ((_resize_mat, ((Z, Y, X), size, a)) for a in (1, 2))
        Mz = (_z_mat, ((Z, Y, X), size, pz_in * n,
                       pz_l * n if sharded else size[0]))
        if sharded:
            return [_apply_yx(z, My, Mx)
                    for z in _ring_matmul_z(slabs, Mz, pz_in, pz_l)]
        return _apply_yx(_replicated_from_sharded(slabs, Mz, pz_in, home),
                         My, Mx)

    def resize_flow(x, prev, size_to, to_sharded, pz_to):
        """Between-level flow resize of the (…, 3) interior flow."""
        size_from, from_sharded, pz_from = prev
        My, Mx = ((_resize_mat, (size_from, size_to, a)) for a in (1, 2))
        Mz = (_z_mat, (size_from, size_to,
                       pz_from * n if from_sharded else size_from[0],
                       pz_to * n if to_sharded else size_to[0]))
        if from_sharded and to_sharded:
            z = _ring_matmul_z(x, Mz, pz_from, pz_to)
        elif from_sharded:
            z = _replicated_from_sharded(x, Mz, pz_from, home)
        elif to_sharded:
            on = replicate(x, devices)
            z = [_z_contract(_dev_mat(*Mz, dev, dtype)[
                k * pz_to:(k + 1) * pz_to], on[dev])
                for k, dev in enumerate(devices)]
        else:
            z = _z_contract(_dev_mat(*Mz, home, dtype), x)
        if to_sharded:
            return [_apply_yx(zk, My, Mx) for zk in z]
        return _apply_yx(z, My, Mx)

    flow = None
    prev = None
    valid = [torch.ones((), dtype=torch.bool, device=d) for d in devices]
    for step, (i, size, h) in enumerate(plan):
        sharded = size[0] >= 4 * n
        pz_l = -(-size[0] // n) if sharded else size[0]
        alpha_l = level_alpha(alpha, i, eff_min_level, eta)
        f1 = from_input(fixed_s, size, sharded, pz_l)
        f2 = from_input(moving_s, size, sharded, pz_l)
        wt = from_input(weight_s, size, sharded, pz_l)
        if step == 0:
            flow = from_input(uvw_s, size, sharded, pz_l)
        else:
            flow = resize_flow(flow, prev, size, sharded, pz_l)
        prev = (size, sharded, pz_l)

        if not sharded:
            u, v, w = level_step(
                f1, f2, *(add_boundary(flow[..., c]) for c in range(3)), wt,
                h, alpha_l, motion_tensor, iterations, update_lag, a_home,
                a_smooth, use_kernels)
            flow = torch.stack([u[_I], v[_I], w[_I]], dim=-1)
            continue

        hz, hy, hx = h
        z_offs = [k * pz_l for k in range(n)]
        # -- warp the moving slabs by the running flow ----------------------
        Mpre = (_prefilter_z_mat, (size[0], pz_l, n, halo_w))
        warped = [[] for _ in range(n)]
        for c in range(C):
            coeff = _ring_matmul_z([_prefilter_yx(s[..., c]) for s in f2],
                                   Mpre, pz_l, pz_l + 2 * halo_w + 4,
                                   out_stride=pz_l)
            for k in range(n):
                out, ok = _warp_local(coeff[k], f1[k][..., c], flow[k],
                                      z_offs[k], halo_w, size, h,
                                      use_kernels)
                warped[k].append(out)
                valid[k] = valid[k] & ok
        tmp = [torch.stack(wk, dim=-1) for wk in warped]

        # -- motion tensor on halo-extended slabs ---------------------------
        f1e = _halo_exchange(f1, halo, "symmetric", size[0])
        tmpe = _halo_exchange(tmp, halo, "symmetric", size[0])
        crop = slice(halo, halo + pz_l + 2)
        Jc = [torch.stack([
            torch.stack([j[crop] for j in motion_tensor(
                a[..., c], b[..., c], hz, hy, hx)])
            for c in range(C)], dim=1) for a, b in zip(f1e, tmpe)]
        wt_r = [F.pad(x.movedim(-1, 0), (1, 1, 1, 1, 1, 1)) for x in wt]

        # -- solve on the slabs ---------------------------------------------
        base = exchange_ghosts([
            torch.stack([add_boundary(x[..., c]) for c in range(3)])
            for x in flow])
        for b, z_off in zip(base, z_offs):
            edge_fix(b, z_off, size[0])
        duvw = solve_slabs(Jc, wt_r, base, z_offs, size[0], alpha_l,
                           iterations, update_lag, a_data_arr, a_smooth, hx,
                           hy, hz, use_kernels)
        d = [x[(slice(None),) + _I] for x in duvw]          # (3, pz, Y, X)
        if min(size) > 5:
            d = _median_sharded(d, size[0], use_kernels)
        flow = [x + dk.movedim(0, -1) for x, dk in zip(flow, d)]

    # -- the full-resolution flow, gathered onto the first shard ---------------
    if eff_min_level > 0 or prev[0] != (Z, Y, X) or not prev[1]:
        flow = resize_flow(flow, prev, (Z, Y, X), True, pz_in)
    out = torch.empty((n * pz_in, Y, X, 3), dtype=dtype, device=home)
    for k, fk in enumerate(flow):
        peer_copy(out[k * pz_in:(k + 1) * pz_in], fk)
    ok = torch.empty(n, dtype=torch.bool, device=home)
    for k, vk in enumerate(valid):
        peer_copy(ok[k], vk)
    return out[:Z], ok.all()
