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

``build_sharded_pyramid`` does the host work of a configuration once (the
schedule, the device tables, the exponents) and returns the body; on CUDA
``get_displacement_sharded`` replays it as one CUDA graph per configuration
and device list (``_graph.BodyGraph``, JAX's ``jax.jit(shard_map(...))``),
the spatial executor one graph of a frame (``parallel/executors.py``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from flowreg3d_tpu_torch import _graph
from flowreg3d_tpu_torch.core.motion_tensor import MOTION_TENSORS
from flowreg3d_tpu_torch.core.pyramid import (add_boundary, level_alpha,
                                              level_schedule, level_step,
                                              pyramid_config_key)
from flowreg3d_tpu_torch.core.solver import data_exponents
from flowreg3d_tpu_torch.ops.median_kernel import median5, median5_plain
from flowreg3d_tpu_torch.ops.resize import _axis_sigmas, _resize_matrix_np
from flowreg3d_tpu_torch.ops.warp import _bspline_prefilter_mat_np
from flowreg3d_tpu_torch.ops.warp_kernel import map_coords, map_coords_plain
from flowreg3d_tpu_torch.parallel.mesh import (batch_devices, peer_copy,
                                               replicate)
from flowreg3d_tpu_torch.parallel.spatial import (edge_fix, exchange_ghosts,
                                                  slab_solver)

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


# The z, y and x matrices below are named by (make, args) pairs; the
# builder uploads each once to every shard's device, and the stages below
# take such a matrix as a dict device -> tensor.

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

def _halo_exchange(slabs, H, rows):
    """Extend each shard's (pz, ...) slab with H neighbour rows a side.

    Shard k holds global rows [k*pz, (k+1)*pz). Every extended row whose
    global index lies outside the volume, its face halos and the shard
    padding past its end, then takes a numpy pad mode by a gather from the
    extended slab: ``rows[k]``, shard k's ``_mirror_rows`` (None: no row
    moves).
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
        out.append(ext if rows[k] is None else ext.index_select(0, rows[k]))
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
    is a slab and the output. ``M``: the matrix on each shard's device."""
    n = len(x)
    stride = out_rows_per_dev if out_stride is None else out_stride
    mats = [M[xk.device][k * stride:k * stride + out_rows_per_dev]
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
    there in shard order. ``M``: the matrix on each shard's device."""
    acc = None
    for k, xk in enumerate(x):
        part = _z_contract(M[xk.device][:, k * rows_per_dev:
                                        (k + 1) * rows_per_dev], xk)
        if k > 0 or part.device != home:
            part = peer_copy(torch.empty_like(part, device=home), part)
        acc = part if acc is None else acc + part
    return acc


# -- local stages -------------------------------------------------------------

def _apply_yx(x, My, Mx):
    """The y then x resize passes of a (z, Y, X, ...) tensor; ``My``, ``Mx``
    the matrices on each device."""
    My, Mx = My[x.device], Mx[x.device]
    z, Y, X = x.shape[:3]
    t = torch.matmul(My, x.reshape(z, Y, -1))            # (z, h, X * c)
    t = torch.matmul(Mx, t.reshape(z * My.shape[0], X, -1))
    return t.reshape((z, My.shape[0], Mx.shape[0]) + tuple(x.shape[3:]))


def _prefilter_yx(x, py, px):
    """The x then y cubic-B-spline prefilter passes of a (z, Y, X) slab ->
    (z, Y + 3, X + 3), as ``ops/warp.bspline_prefilter`` orders them;
    ``py``, ``px`` the prefilter matrices on each device."""
    z, Y, X = x.shape
    py, px = py[x.device], px[x.device]
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


def _median_sharded(d, rows, use_kernels):
    """5^3 medians of the three increments' slabs, d[k] (3, pz, Y, X),
    'reflect' at the volume's faces (``rows``: the halo's mirror rows of
    each shard): one launch a shard."""
    ext = _halo_exchange([x.transpose(0, 1) for x in d], 2, rows)
    out = []
    for x in ext:
        xp = F.pad(x.transpose(0, 1), (2, 2, 2, 2), mode="reflect")
        xp = xp.contiguous()
        out.append(median5(xp) if use_kernels else median5_plain(xp))
    return out


# -- the pyramid --------------------------------------------------------------

def _shard_slabs(x, pz, devices):
    """(Z, ...) tensor -> slabs of pz rows on the shards' devices, the last
    edge-padded."""
    pad = pz * len(devices) - x.shape[0]
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return [x[k * pz:(k + 1) * pz].to(dev).contiguous()
            for k, dev in enumerate(devices)]


def build_sharded_pyramid(key, devices, halo=_DEF_HALO, halo_w=_DEF_HALO_W):
    """The Z-sharded pyramid of one static configuration
    (``core/pyramid.pyramid_config_key``) over ``devices``.

    All host work is done here once: the level schedule, each level's
    split and z offsets, the data exponents on every shard's device, the
    slab solver's constants (``parallel/spatial.slab_solver``) and every
    device table (the resize, z and prefilter matrices and the mirror-row
    gathers). Returns ``pyramid(fixed, moving, uvw, weight) ->
    (flow, valid)``: fixed/moving (Z,Y,X,C), uvw (Z,Y,X,3) and weight (C,)
    or (Z,Y,X,C), tensors of the configuration's dtype on the first shard's
    device, sharded inside; flow (Z,Y,X,3) there and ``valid`` a 0-d bool
    tensor there (False when a level's warp needed z-samples beyond
    ``halo_w`` rows). The body uploads nothing and reads nothing back.
    """
    (shape, C, alpha, update_lag, iterations, min_level, levels, eta,
     a_smooth, a_data, const_assumption, dtype_name, use_kernels) = key
    dtype = getattr(torch, dtype_name)
    devices = batch_devices(devices)
    n, home = len(devices), devices[0]
    distinct = list(dict.fromkeys(devices))
    Z, Y, X = shape
    pz_in = -(-Z // n)
    plan, eff_min_level, _ = level_schedule(shape, eta, levels, min_level)
    motion_tensor = MOTION_TENSORS[const_assumption]
    a_vecs = {d: data_exponents(np.asarray(a_data, np.float64), C, dtype, d)
              for d in distinct}
    def on_devices(make, *args):
        M = make(*args)
        return {d: torch.as_tensor(M, dtype=dtype).to(d) for d in distinct}

    def resize_mats(size_from, size_to, from_rows, to_rows):
        return (on_devices(_resize_mat, size_from, size_to, 1),
                on_devices(_resize_mat, size_from, size_to, 2),
                on_devices(_z_mat, size_from, size_to, from_rows, to_rows))

    def mirror_rows(pz, H, mode, z_total):
        return [_mirror_rows(k, pz, H, mode, z_total, d)
                for k, d in enumerate(devices)]

    steps = []
    prev = dict(size=(Z, Y, X), sharded=True, pz=pz_in)
    for i, size, h in plan:
        sharded = size[0] >= 4 * n
        pz_l = -(-size[0] // n) if sharded else size[0]
        rows = pz_l * n if sharded else size[0]
        step = dict(size=size, h=h, sharded=sharded, pz=pz_l,
                    alpha=level_alpha(alpha, i, eff_min_level, eta),
                    z_offs=[k * pz_l for k in range(n)],
                    input=resize_mats((Z, Y, X), size, pz_in * n, rows))
        if steps:
            step["flow"] = resize_mats(
                prev["size"], size,
                prev["pz"] * n if prev["sharded"] else prev["size"][0], rows)
        if sharded:
            hz, hy, hx = h
            step["pre"] = on_devices(_prefilter_z_mat, size[0], pz_l, n,
                                     halo_w)
            step["pre_yx"] = [on_devices(_bspline_prefilter_mat_np, s)
                              for s in size[1:]]
            step["halo_rows"] = mirror_rows(pz_l, halo, "symmetric", size[0])
            if min(size) > 5:
                step["median_rows"] = mirror_rows(pz_l, 2, "reflect",
                                                  size[0])
            step["solve"] = slab_solver(
                step["z_offs"], size[0], step["alpha"], iterations,
                update_lag, a_vecs, a_smooth, hx, hy, hz, dtype, use_kernels)
        steps.append(step)
        prev = step
    final = None
    if eff_min_level > 0 or prev["size"] != (Z, Y, X) or not prev["sharded"]:
        final = resize_mats(
            prev["size"], (Z, Y, X),
            prev["pz"] * n if prev["sharded"] else prev["size"][0],
            pz_in * n)

    def resize(x, mats, src, to_sharded, pz_to):
        """Level ``src``'s volume (sharded slabs or replicated) resized by
        ``mats`` (y, x, z): z first, then the local y and x passes."""
        My, Mx, Mz = mats
        if src["sharded"] and to_sharded:
            z = _ring_matmul_z(x, Mz, src["pz"], pz_to)
        elif src["sharded"]:
            z = _replicated_from_sharded(x, Mz, src["pz"], home)
        elif to_sharded:
            on = replicate(x, devices)
            z = [_z_contract(Mz[dev][k * pz_to:(k + 1) * pz_to], on[dev])
                 for k, dev in enumerate(devices)]
        else:
            z = _z_contract(Mz[home], x)
        if to_sharded:
            return [_apply_yx(zk, My, Mx) for zk in z]
        return _apply_yx(z, My, Mx)

    def pyramid(fixed, moving, uvw, weight):
        fixed_s, moving_s, uvw_s = (_shard_slabs(x, pz_in, devices)
                                    for x in (fixed, moving, uvw))
        if weight.dim() == 1:
            weight_s = [weight.to(d).reshape(1, 1, 1, C)
                        .expand(pz_in, Y, X, C).contiguous() for d in devices]
        else:
            weight_s = _shard_slabs(weight, pz_in, devices)
        inputs = dict(size=(Z, Y, X), sharded=True, pz=pz_in)
        flow = None
        src = inputs
        valid = [torch.ones((), dtype=torch.bool, device=d) for d in devices]
        for s, step in enumerate(steps):
            size, sharded, pz_l = step["size"], step["sharded"], step["pz"]
            f1, f2, wt = (resize(x, step["input"], inputs, sharded, pz_l)
                          for x in (fixed_s, moving_s, weight_s))
            if s == 0:
                flow = resize(uvw_s, step["input"], inputs, sharded, pz_l)
            else:
                flow = resize(flow, step["flow"], src, sharded, pz_l)
            src = step

            if not sharded:
                u, v, w = level_step(
                    f1, f2, *(add_boundary(flow[..., c]) for c in range(3)),
                    wt, step["h"], step["alpha"], motion_tensor, iterations,
                    update_lag, a_vecs[home], a_smooth, use_kernels)
                flow = torch.stack([u[_I], v[_I], w[_I]], dim=-1)
                continue

            hz, hy, hx = step["h"]
            z_offs = step["z_offs"]
            # -- warp the moving slabs by the running flow ------------------
            warped = [[] for _ in range(n)]
            for c in range(C):
                coeff = _ring_matmul_z([_prefilter_yx(x[..., c],
                                                      *step["pre_yx"])
                                        for x in f2], step["pre"], pz_l,
                                       pz_l + 2 * halo_w + 4,
                                       out_stride=pz_l)
                for k in range(n):
                    out, ok = _warp_local(coeff[k], f1[k][..., c], flow[k],
                                          z_offs[k], halo_w, size, step["h"],
                                          use_kernels)
                    warped[k].append(out)
                    valid[k] = valid[k] & ok
            tmp = [torch.stack(wk, dim=-1) for wk in warped]

            # -- motion tensor on halo-extended slabs -----------------------
            f1e = _halo_exchange(f1, halo, step["halo_rows"])
            tmpe = _halo_exchange(tmp, halo, step["halo_rows"])
            crop = slice(halo, halo + pz_l + 2)
            Jc = [torch.stack([
                torch.stack([j[crop] for j in motion_tensor(
                    a[..., c], b[..., c], hz, hy, hx)])
                for c in range(C)], dim=1) for a, b in zip(f1e, tmpe)]
            wt_r = [F.pad(x.movedim(-1, 0), (1, 1, 1, 1, 1, 1)) for x in wt]

            # -- solve on the slabs -----------------------------------------
            base = exchange_ghosts([
                torch.stack([add_boundary(x[..., c]) for c in range(3)])
                for x in flow])
            for b, z_off in zip(base, z_offs):
                edge_fix(b, z_off, size[0])
            duvw = step["solve"](Jc, wt_r, base)
            d = [x[(slice(None),) + _I] for x in duvw]      # (3, pz, Y, X)
            if min(size) > 5:
                d = _median_sharded(d, step["median_rows"], use_kernels)
            flow = [x + dk.movedim(0, -1) for x, dk in zip(flow, d)]

        # -- the full-resolution flow, gathered onto the first shard ----------
        if final is not None:
            flow = resize(flow, final, src, True, pz_in)
        out = torch.empty((n * pz_in, Y, X, 3), dtype=dtype, device=home)
        for k, fk in enumerate(flow):
            peer_copy(out[k * pz_in:(k + 1) * pz_in], fk)
        ok = torch.empty(n, dtype=torch.bool, device=home)
        for k, vk in enumerate(valid):
            peer_copy(ok[k], vk)
        return out[:Z], ok.all()

    return pyramid


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
    runs the kernels' plain versions. On CUDA the pyramid replays one CUDA
    graph per configuration and device list (``_graph.BodyGraph`` of the
    body, kind ``"sharded"``, captured on the first call, across the cards
    the shards sit on; ``parallel.executors.clear_frame_graphs`` frees it);
    on the CPU it runs eagerly (``build_sharded_pyramid``).
    Returns (flow (Z,Y,X,3) on the first shard's device, valid): ``valid``
    (0-d bool tensor) is False when a level's warp needed z-samples beyond
    ``halo_w`` rows; recompute that volume on one device then.
    """
    devices = batch_devices(devices, device)
    home = devices[0]
    fixed, moving = (torch.as_tensor(x).to(device=home, dtype=dtype)
                     for x in (fixed, moving))
    if fixed.dim() == 3:
        fixed, moving = fixed[..., None], moving[..., None]
    Z, Y, X, C = fixed.shape
    if uvw is None:
        uvw = torch.zeros((Z, Y, X, 3), dtype=dtype, device=home)
    else:
        uvw = torch.as_tensor(uvw).to(device=home, dtype=dtype)
    if weight is None:
        weight = torch.full((C,), 1.0 / C, dtype=dtype, device=home)
    else:
        weight = torch.as_tensor(weight).to(device=home, dtype=dtype)
    key = pyramid_config_key((Z, Y, X), C, alpha, update_lag, iterations,
                             min_level, levels, eta, a_smooth, a_data,
                             const_assumption, dtype, use_kernels)
    inputs = (fixed, moving, uvw, weight)
    if home.type == "cuda":
        graph = _graph.cached(
            "sharded", (key, halo, halo_w, tuple(weight.shape)),
            tuple(devices),
            lambda: _graph.BodyGraph(
                build_sharded_pyramid(key, devices, halo, halo_w),
                [(x.shape, dtype) for x in inputs], home, devices))
        return graph.run(*inputs)
    return build_sharded_pyramid(key, devices, halo, halo_w)(*inputs)
