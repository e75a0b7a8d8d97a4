"""The plain reference of one registration: a frozen copy of the port's plain
PyTorch path, importing nothing of the port.

Dense 3D variational optical flow from ``fixed`` to ``moving`` (a coarse-to-fine
pyramid of fused Gaussian + Keys-cubic resizes; per level a cubic B-spline
backward warp by the current flow, the gradient-constancy motion tensor, a
red-black SOR solve of the Euler-Lagrange system with the data term
re-linearised every ``update_lag`` iterations, constant (``a_smooth == 1``) or
flow-driven diffusivity, and a 5^3 median of the increments), then the backward
warp of the moving volume by the flow. Layouts: a volume is (Z, Y, X, C), a flow
(Z, Y, X, 3) with the last axis [dx, dy, dz].

Every operation is plain ``torch`` in float32, in the order of the port's plain
path, so that the two agree bit for bit on one device where the port's kernels
agree with their plain versions. ``mm`` is the matrix product of the resizes and
the spline prefilter: ``torch.matmul`` with TF32 off, or ``tf32_matmul``, the
control's lower precision.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

OMEGA = 1.95
EPS_PSI = 1e-6
EPS_SMOOTH = 1e-5
_I = (slice(1, -1),) * 3
_DIRS = ("xm", "xp", "ym", "yp", "zm", "zp")
_SPLINE_PAD = 12
_SIXTH = 1.0 / 6.0
_A = -0.75
_SLAB_BYTES = 256 << 20


def fp32_matmul(a, b):
    """A float32 matrix product with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.matmul(a, b)


def to_tf32(x):
    """Round float32 values to TF32's 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_matmul(a, b):
    """A matrix product as TF32 tensor cores compute it: operands rounded to
    TF32, products accumulated in float32."""
    return fp32_matmul(to_tf32(a), to_tf32(b))


# -- pyramid schedule -------------------------------------------------------

def warping_depth(eta, levels, p, m, n):
    min_dim = min(p, m, n)
    depth = 0
    for _ in range(levels):
        depth += 1
        min_dim *= eta
        if round(min_dim) < 10:
            break
    return depth


def level_schedule(shape_zyx, eta, levels, min_level):
    """[(level index, (z, y, x) size, (hz, hy, hx))] coarse to fine, the
    effective min_level and the top level."""
    p, m, n = shape_zyx
    mlz = warping_depth(eta, levels, p, m, n)
    mly = warping_depth(eta, levels, m, n, p)
    mlx = warping_depth(eta, levels, n, p, m)
    cap = min(mlx, mly, mlz) * 4
    mlz, mly, mlx = min(mlz, cap), min(mly, cap), min(mlx, cap)
    top = max(mlx, mly, mlz)
    if top <= min_level:
        min_level = top - 1
    min_level = max(min_level, 0)
    plan = []
    for i in range(top, min_level - 1, -1):
        size = (int(round(p * eta ** min(i, mlz))),
                int(round(m * eta ** min(i, mly))),
                int(round(n * eta ** min(i, mlx))))
        plan.append((i, size, (p / size[0], m / size[1], n / size[2])))
    return plan, min_level, top


def blocks(iterations, update_lag):
    """Iterations of each tick block."""
    n_full, rem = divmod(int(iterations), int(update_lag))
    return [int(update_lag)] * n_full + ([rem] if rem else [])


# -- resize -----------------------------------------------------------------

def _cubic_kernel(x):
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (_A + 2.0) * ax3 - (_A + 3.0) * ax2 + 1.0
    outer = _A * ax3 - 5.0 * _A * ax2 + 8.0 * _A * ax - 4.0 * _A
    return np.where(ax < 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _reflect_indices(j, n):
    if n <= 1:
        return np.zeros_like(j)
    period = 2 * n
    j = np.mod(j, period)
    j = np.where(j < 0, j + period, j)
    return np.where(j >= n, period - 1 - j, j)


@lru_cache(maxsize=256)
def _resize_matrix_np(in_len, out_len, sigma):
    scale = out_len / in_len
    if sigma <= 0.0:
        radius = 0
        gauss = np.array([1.0], dtype=np.float64)
    else:
        radius = int(np.ceil(2.0 * sigma))
        xg = np.arange(-radius, radius + 1, dtype=np.float32)
        gauss = np.exp(-0.5 * (xg / np.float32(sigma)) ** 2).astype(np.float32)
        gauss = (gauss / gauss.sum()).astype(np.float64)
    taps = 2 * radius + 4
    i = np.arange(out_len, dtype=np.float64)
    x = (i + 0.5) / scale - 0.5
    left = np.floor(x - 2.0).astype(np.int64) - radius
    j = left[:, None] + np.arange(taps)[None, :]
    d = x[:, None] - j
    u = np.arange(-radius, radius + 1)
    wt = np.einsum("u,opu->op", gauss,
                   _cubic_kernel(d[:, :, None] - u[None, None, :]))
    wt = wt / wt.sum(axis=1, keepdims=True)
    idx = _reflect_indices(j, in_len)
    mat = np.zeros((out_len, in_len), dtype=np.float64)
    rows = np.repeat(np.arange(out_len), idx.shape[1])
    np.add.at(mat, (rows, idx.ravel()), wt.ravel())
    return mat


def _resize_matrix(in_len, out_len, sigma, device):
    return torch.as_tensor(_resize_matrix_np(in_len, out_len, float(sigma)),
                           dtype=torch.float32).to(device)


def resize_volume(vol, out_size, mm, sigma_coeff=0.6):
    """Fused Gaussian anti-alias + Keys-cubic resize of (Z,Y,X) or
    (Z,Y,X,C) to ``out_size``: three matrix products, x, y, z."""
    squeeze = vol.dim() == 3
    x = vol.to(torch.float32)
    if squeeze:
        x = x[..., None]
    Z, Y, X, C = x.shape
    od, oh, ow = (int(s) for s in out_size)
    s = min(ow / X, oh / Y, od / Z)
    sig = sigma_coeff / s if s < 1.0 else 0.0
    rx, ry, rz = (_resize_matrix(a, b, sig, x.device)
                  for a, b in ((X, ow), (Y, oh), (Z, od)))
    x = mm(x.permute(0, 1, 3, 2).reshape(Z * Y * C, X), rx.T)
    x = x.reshape(Z, Y, C, ow).permute(0, 1, 3, 2)
    x = mm(ry, x.reshape(Z, Y, ow * C))
    x = mm(rz, x.reshape(Z, oh * ow * C))
    x = x.reshape(od, oh, ow, C)
    return x[..., 0] if squeeze else x


# -- warp -------------------------------------------------------------------

@lru_cache(maxsize=64)
def _prefilter_np(n):
    """Edge-pad + cubic B-spline prefilter, (n+3, n): scipy's
    map_coordinates(order=3, mode='nearest') coefficients at taps -1..n+1."""
    if n == 1:
        return np.ones((4, 1), dtype=np.float64)
    npad = n + 2 * _SPLINE_PAD
    B = np.zeros((npad, npad), dtype=np.float64)
    idx = np.arange(npad)
    for off, w in ((-1, 1.0 / 6.0), (0, 2.0 / 3.0), (1, 1.0 / 6.0)):
        np.add.at(B, (idx, np.clip(idx + off, 0, npad - 1)), w)
    pad = np.zeros((npad, n), dtype=np.float64)
    pad[np.arange(npad), np.clip(np.arange(npad) - _SPLINE_PAD, 0, n - 1)] = 1
    return (np.linalg.inv(B) @ pad)[_SPLINE_PAD - 1: _SPLINE_PAD + n + 2]


def bspline_prefilter(vol, mm):
    Z, Y, X = vol.shape
    pz, py, px = (torch.as_tensor(_prefilter_np(n), dtype=torch.float32)
                  .to(vol.device) for n in (Z, Y, X))
    a = mm(vol.reshape(Z * Y, X), px.T).reshape(Z, Y, X + 3)
    b = mm(py, a)
    return mm(pz, b.reshape(Z, -1)).reshape(Z + 3, Y + 3, X + 3)


def _pad_far_edge(vol):
    vol = torch.cat([vol, vol[-1:]], dim=0)
    vol = torch.cat([vol, vol[:, -1:]], dim=1)
    return torch.cat([vol, vol[:, :, -1:]], dim=2)


def _cubic_weights(t):
    t2 = t * t
    t3 = t2 * t
    return ((1.0 - 3.0 * t + 3.0 * t2 - t3) * _SIXTH,
            (4.0 - 6.0 * t2 + 3.0 * t3) * _SIXTH,
            (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) * _SIXTH,
            t3 * _SIXTH)


def _split(c, n):
    c = torch.nan_to_num(c, nan=0.0).clamp(0, n - 1)
    f = torch.floor(c)
    return f.long(), c - f


def map_coords(coeff, cz, cy, cx, order):
    """Sample spline coefficients (order 3) or the far-edge-padded volume
    (order 1) at clipped coordinates."""
    K = 4 if order == 3 else 2
    Ze, Ye, Xe = coeff.shape
    Z, Y, X = Ze - (K - 1), Ye - (K - 1), Xe - (K - 1)
    z0, tz = _split(cz.reshape(-1), Z)
    y0, ty = _split(cy.reshape(-1), Y)
    x0, tx = _split(cx.reshape(-1), X)
    if K == 4:
        wz, wy, wx = _cubic_weights(tz), _cubic_weights(ty), _cubic_weights(tx)
    else:
        wz, wy, wx = (1.0 - tz, tz), (1.0 - ty, ty), (1.0 - tx, tx)
    flat = coeff.reshape(-1)
    base = (z0 * Ye + y0) * Xe + x0
    acc = torch.zeros_like(tz)
    for a in range(K):
        acc_y = torch.zeros_like(tz)
        for b in range(K):
            row = base + (a * Ye + b) * Xe
            acc_x = torch.zeros_like(tz)
            for d in range(K):
                acc_x = acc_x + wx[d] * flat[row + d]
            acc_y = acc_y + wy[b] * acc_x
        acc = acc + wz[a] * acc_y
    return acc.reshape(cz.shape)


def sample_coords(u, v, w):
    Z, Y, X = u.shape
    gz, gy, gx = torch.meshgrid(
        *(torch.arange(n, dtype=u.dtype, device=u.device) for n in (Z, Y, X)),
        indexing="ij")
    mx, my, mz = gx + u, gy + v, gz + w
    oob = ((mx < 0) | (mx >= X) | (my < 0) | (my >= Y)
           | (mz < 0) | (mz >= Z))
    cx = torch.where(oob, gx, mx.clamp(0, X - 1)).contiguous()
    cy = torch.where(oob, gy, my.clamp(0, Y - 1)).contiguous()
    cz = torch.where(oob, gz, mz.clamp(0, Z - 1)).contiguous()
    return cz, cy, cx, oob


def warp(f2, u, v, w, f1, mm, order=3):
    """Backward-warp ``f2`` (Z,Y,X,C) by (u, v, w) in voxels; voxels whose
    sample leaves the volume come from ``f1``."""
    cz, cy, cx, oob = sample_coords(u, v, w)
    out = []
    for c in range(f2.shape[-1]):
        vol = f2[..., c].contiguous()
        coeff = bspline_prefilter(vol, mm) if order == 3 else _pad_far_edge(vol)
        out.append(map_coords(coeff, cz, cy, cx, order))
    warped = torch.stack(out, dim=-1)
    return torch.where(oob[..., None], f1.to(warped.dtype), warped)


# -- motion tensor ----------------------------------------------------------

def pad_edge(f):
    f = torch.cat([f[:1], f, f[-1:]], dim=0)
    f = torch.cat([f[:, :1], f, f[:, -1:]], dim=1)
    return torch.cat([f[:, :, :1], f, f[:, :, -1:]], dim=2)


def _gradient_axis(f, axis, spacing):
    n = f.shape[axis]
    if n < 2:
        return torch.zeros_like(f)
    interior = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) / (
        2.0 * spacing)
    first = (f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)) / spacing
    last = (f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)) / spacing
    return torch.cat([first, interior, last], dim=axis)


def _gradient_zyx(f, hz, hy, hx):
    return (_gradient_axis(f, 0, hz), _gradient_axis(f, 1, hy),
            _gradient_axis(f, 2, hx))


def _second_diff_zyx(f, hz, hy, hx):
    fxx, fyy, fzz = (torch.zeros_like(f) for _ in range(3))
    fxx[:, :, 1:-1] = (f[:, :, :-2] - 2.0 * f[:, :, 1:-1] + f[:, :, 2:]) / (
        hx * hx)
    fyy[:, 1:-1, :] = (f[:, :-2, :] - 2.0 * f[:, 1:-1, :] + f[:, 2:, :]) / (
        hy * hy)
    fzz[1:-1, :, :] = (f[:-2, :, :] - 2.0 * f[1:-1, :, :] + f[2:, :, :]) / (
        hz * hz)
    return fxx, fyy, fzz


def _repad_interior(f):
    return pad_edge(f[1:-1, 1:-1, 1:-1])


def _zero_faces(arrs):
    out = []
    for a in arrs:
        a = a.clone()
        a[:, :, 0] = 0
        a[:, :, -1] = 0
        a[:, 0, :] = 0
        a[:, -1, :] = 0
        a[0] = 0
        a[-1] = 0
        out.append(a)
    return tuple(out)


def motion_tensor_gc(f1, f2, hz, hy, hx):
    """Gradient-constancy motion tensor of two (Z,Y,X) volumes: the 10
    entries [J11,J22,J33,J44,J12,J13,J23,J14,J24,J34] on the padded grid."""
    f1p, f2p = pad_edge(f1), pad_edge(f2)
    _, gy1, gx1 = _gradient_zyx(f1p, hz, hy, hx)
    _, gy2, gx2 = _gradient_zyx(f2p, hz, hy, hx)
    fx = _repad_interior(0.5 * (gx1 + gx2))
    fy = _repad_interior(0.5 * (gy1 + gy2))
    ft = _repad_interior(f2p - f1p)
    dfx = _gradient_zyx(fx, hz, hy, hx)
    dfy = _gradient_zyx(fy, hz, hy, hx)
    fzt, fyt, fxt = _gradient_zyx(ft, hz, hy, hx)
    fxy, fxz, fyz = dfx[1], dfx[0], dfy[0]
    fxx1, fyy1, fzz1 = _second_diff_zyx(f1p, hz, hy, hx)
    fxx2, fyy2, fzz2 = _second_diff_zyx(f2p, hz, hy, hx)
    fxx = 0.5 * (fxx1 + fxx2)
    fyy = 0.5 * (fyy1 + fyy2)
    fzz = 0.5 * (fzz1 + fzz2)
    reg_x = 1.0 / (fxx * fxx + fxy * fxy + fxz * fxz + 1e-6)
    reg_y = 1.0 / (fxy * fxy + fyy * fyy + fyz * fyz + 1e-6)
    reg_z = 1.0 / (fxz * fxz + fyz * fyz + fzz * fzz + 1e-6)
    J11 = reg_x * fxx**2 + reg_y * fxy**2 + reg_z * fxz**2
    J22 = reg_x * fxy**2 + reg_y * fyy**2 + reg_z * fyz**2
    J33 = reg_x * fxz**2 + reg_y * fyz**2 + reg_z * fzz**2
    J12 = reg_x * fxx * fxy + reg_y * fxy * fyy + reg_z * fxz * fyz
    J13 = reg_x * fxx * fxz + reg_y * fxy * fyz + reg_z * fxz * fzz
    J23 = reg_x * fxy * fxz + reg_y * fyy * fyz + reg_z * fyz * fzz
    J14 = reg_x * fxx * fxt + reg_y * fxy * fyt + reg_z * fxz * fzt
    J24 = reg_x * fxy * fxt + reg_y * fyy * fyt + reg_z * fyz * fzt
    J34 = reg_x * fxz * fxt + reg_y * fyz * fyt + reg_z * fzz * fzt
    J44 = reg_x * fxt**2 + reg_y * fyt**2 + reg_z * fzt**2
    return _zero_faces((J11, J22, J33, J44, J12, J13, J23, J14, J24, J34))


# -- level solve ------------------------------------------------------------

def _f32(v):
    return float(np.float32(v))


def tick_update(Jc, weight, a_data, du, dv, dw):
    """psi_data re-linearised and reduced over channels: the 9 terms
    [SJ11,SJ22,SJ33,SJ12,SJ13,SJ23,SJ14,SJ24,SJ34]."""
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


def set_boundary_3d(f):
    f[..., 0, :] = f[..., 1, :]
    f[..., -1, :] = f[..., -2, :]
    f[..., :, 0] = f[..., :, 1]
    f[..., :, -1] = f[..., :, -2]
    f[..., 0, :, :] = f[..., 1, :, :]
    f[..., -1, :, :] = f[..., -2, :, :]
    return f


def _parity_mask(P, M, N, parity, device):
    z, y, x = (torch.arange(1, n - 1, device=device) for n in (P, M, N))
    return (z[:, None, None] + y[None, :, None] + x[None, None, :]) % 2 == parity


def _clamped_nbr_sum(f, ax, ay, az):
    xm = torch.cat([f[..., :1], f[..., :-1]], dim=-1)
    xp = torch.cat([f[..., 1:], f[..., -1:]], dim=-1)
    ym = torch.cat([f[:, :1], f[:, :-1]], dim=1)
    yp = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
    zm = torch.cat([f[:1], f[:-1]], dim=0)
    zp = torch.cat([f[1:], f[-1:]], dim=0)
    return ax * (xm + xp) + ay * (ym + yp) + az * (zm + zp)


def _halfsweep_const(duvw, sj, ax, ay, az, parity):
    """One red or black half-sweep of the constant-diffusivity SOR with the
    base flow's Laplacian folded into the data terms."""
    _, P, M, N = duvw.shape
    c = duvw[:, 1:-1, 1:-1, 1:-1]
    s = sj[:, 1:-1, 1:-1, 1:-1]
    du, dv, dw = c[0], c[1], c[2]
    sw = _f32(np.float32(2.0) * (np.float32(ax) + np.float32(ay)
                                 + np.float32(az)))
    nu = -(s[6] + s[3] * dv + s[4] * dw) + _clamped_nbr_sum(du, ax, ay, az)
    nv = -(s[7] + s[3] * du + s[5] * dw) + _clamped_nbr_sum(dv, ax, ay, az)
    nw = -(s[8] + s[4] * du + s[5] * dv) + _clamped_nbr_sum(dw, ax, ay, az)
    new = torch.stack([
        (1.0 - OMEGA) * du + OMEGA * nu / (s[0] + sw),
        (1.0 - OMEGA) * dv + OMEGA * nv / (s[1] + sw),
        (1.0 - OMEGA) * dw + OMEGA * nw / (s[2] + sw),
    ])
    c.copy_(torch.where(_parity_mask(P, M, N, parity, duvw.device), new, c))


def _base_laplacian(b, ax, ay, az):
    return (ax * (torch.roll(b, 1, 2) + torch.roll(b, -1, 2) - 2.0 * b)
            + ay * (torch.roll(b, 1, 1) + torch.roll(b, -1, 1) - 2.0 * b)
            + az * (torch.roll(b, 1, 0) + torch.roll(b, -1, 0) - 2.0 * b))


def _nbr(f):
    return dict(xm=f[1:-1, 1:-1, :-2], xp=f[1:-1, 1:-1, 2:],
                ym=f[1:-1, :-2, 1:-1], yp=f[1:-1, 2:, 1:-1],
                zm=f[:-2, 1:-1, 1:-1], zp=f[2:, 1:-1, 1:-1])


def _clamped_shift(f, axis, step):
    n = f.shape[axis]
    if step > 0:
        return torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)],
                         dim=axis)
    return torch.cat([f.narrow(axis, 0, 1), f.narrow(axis, 0, n - 1)],
                     dim=axis)


def _psi_field(duvw, base, a, expo, ihx, ihy, ihz):
    """The flow-driven diffusivity a (|grad(base + inc)|^2 + eps)^(a - 1)."""
    tot = base + set_boundary_3d(duvw.clone())
    g = torch.zeros_like(tot[0])
    for c in range(3):
        for axis, ih in ((0, ihz), (1, ihy), (2, ihx)):
            d = (_clamped_shift(tot[c], axis, 1)
                 - _clamped_shift(tot[c], axis, -1)) * ih
            g = g + d * d
    s = g + EPS_SMOOTH
    return a * (torch.rsqrt(s) if expo == -0.5 else torch.pow(s, expo))


def _halfsweep_psi(duvw, base, sj, psi, ax, ay, az, parity):
    """One half-sweep of the flow-driven-diffusivity SOR on the unfolded base
    flow, weights 0.5 (psi_c + psi_nbr) a_dir."""
    pc = psi[_I]
    nbp = _nbr(psi)
    scale = dict(xm=ax, xp=ax, ym=ay, yp=ay, zm=az, zp=az)
    weights = {d: 0.5 * (pc + nbp[d]) * scale[d] for d in _DIRS}
    sw_sum = weights["xm"]
    for d in _DIRS[1:]:
        sw_sum = sw_sum + weights[d]
    tot = base + set_boundary_3d(duvw.clone())
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
    mask = _parity_mask(*duvw.shape[1:], parity, duvw.device)
    c.copy_(torch.where(mask, torch.stack(new), c))


def solve_level(Jc, weight, a_vec, u, v, w, alpha, iterations, update_lag,
                a_smooth, hx, hy, hz):
    """The increments (du, dv, dw) of one level, each with its ring."""
    ax, ay, az = (_f32(np.float32(a) / (np.float32(h) * np.float32(h)))
                  for a, h in zip(alpha, (hx, hy, hz)))
    hx, hy, hz = (_f32(h) for h in (hx, hy, hz))
    a_smooth = _f32(a_smooth)
    if a_smooth == 1.0:
        laps = [_base_laplacian(b, ax, ay, az) for b in (u, v, w)]
        duvw = torch.zeros((3,) + tuple(u.shape), dtype=u.dtype,
                           device=u.device)
        for k in blocks(iterations, update_lag):
            SJ = tick_update(Jc, weight, a_vec, duvw[0], duvw[1], duvw[2])
            sj = torch.stack([*SJ[:6], SJ[6] - laps[0], SJ[7] - laps[1],
                              SJ[8] - laps[2]])
            for _ in range(k):
                _halfsweep_const(duvw, sj, ax, ay, az, 0)
                _halfsweep_const(duvw, sj, ax, ay, az, 1)
    else:
        base = torch.stack([u, v, w])
        duvw = torch.zeros_like(base)
        t = np.float32
        a, expo = _f32(a_smooth), _f32(t(a_smooth) - t(1.0))
        ihx, ihy, ihz = (_f32(t(0.5) / t(h)) for h in (hx, hy, hz))
        for k in blocks(iterations, update_lag):
            SJ = tick_update(Jc, weight, a_vec, duvw[0], duvw[1], duvw[2])
            sj = torch.stack(SJ)
            for _ in range(k):
                psi = _psi_field(duvw, base, a, expo, ihx, ihy, ihz)
                _halfsweep_psi(duvw, base, sj, psi, ax, ay, az, 0)
                _halfsweep_psi(duvw, base, sj, psi, ax, ay, az, 1)
    return tuple(set_boundary_3d(duvw[k].clone()) for k in range(3))


# -- median -----------------------------------------------------------------

def median5(x):
    """Exact 5^3 median (rank 62 of 125) of each volume of a (B,Z,Y,X)
    stack, mirror boundaries."""
    xp = F.pad(x, (2, 2, 2, 2, 2, 2), mode="reflect").contiguous()
    B, Zp, Yp, Xp = xp.shape
    Z, Y, X = Zp - 4, Yp - 4, Xp - 4
    slab = max(1, min(Z, _SLAB_BYTES // (B * Y * X * 125 * xp.element_size())))
    outs = []
    for z0 in range(0, Z, slab):
        zs = min(slab, Z - z0)
        patches = (xp[:, z0:z0 + zs + 4].unfold(1, 5, 1).unfold(2, 5, 1)
                   .unfold(3, 5, 1))
        outs.append(patches.reshape(B, zs, Y, X, 125).median(dim=-1).values)
    return torch.cat(outs, dim=1)


# -- one registration -------------------------------------------------------

def weight_volume(weight, shape, n_channels, device):
    """The per-channel data weights as a (Z,Y,X,C) volume, normalised."""
    p, m, n = shape
    wv = np.asarray(weight, dtype=np.float64).reshape(-1)
    if len(wv) < n_channels:
        ww = np.full(n_channels, 1.0 / n_channels)
        ww[: len(wv)] = wv
        wv = ww
    wv = wv[:n_channels] / wv[:n_channels].sum()
    return torch.as_tensor(wv, dtype=torch.float32, device=device).reshape(
        1, 1, 1, -1).expand(p, m, n, n_channels)


def flow(fixed, moving, uvw, weight, params, mm=fp32_matmul):
    """Dense flow (Z,Y,X,3) from ``fixed`` to ``moving``, both (Z,Y,X,C)
    float32, from the initial flow ``uvw``; ``weight`` (Z,Y,X,C);
    ``params``: alpha, iterations, update_lag, min_level, levels, eta,
    a_smooth, a_data."""
    p, m, n, C = fixed.shape
    alpha = tuple(float(a) for a in np.broadcast_to(
        np.asarray(params["alpha"], np.float64), (3,)))
    plan, eff_min, _ = level_schedule((p, m, n), params["eta"],
                                      params["levels"], params["min_level"])
    a_vec = torch.as_tensor(np.full(C, float(params["a_data"])),
                            dtype=torch.float32, device=fixed.device)
    u = v = w = None
    for step, (i, size, (hz, hy, hx)) in enumerate(plan):
        f1 = resize_volume(fixed, size, mm)
        f2 = resize_volume(moving, size, mm)
        src = ([uvw[..., k] for k in range(3)] if step == 0
               else [f[_I] for f in (u, v, w)])
        u, v, w = (pad_edge(resize_volume(f, size, mm)) for f in src)
        scale = 1.0 if i == eff_min else params["eta"] ** (-0.5 * i)
        lvl_alpha = tuple(scale * a for a in alpha)
        tmp = warp(f2, u[_I] / hx, v[_I] / hy, w[_I] / hz, f1, mm, 3)
        Jc = torch.stack([torch.stack(motion_tensor_gc(
            f1[..., c], tmp[..., c], hz, hy, hx)) for c in range(C)], dim=1)
        wl = F.pad(resize_volume(weight, size, mm).movedim(-1, 0),
                   (1, 1, 1, 1, 1, 1))
        du, dv, dw = solve_level(Jc, wl, a_vec, u, v, w, lvl_alpha,
                                 params["iterations"], params["update_lag"],
                                 params["a_smooth"], hx, hy, hz)
        if min(f1.shape[:3]) > 5:
            med = median5(torch.stack([du[_I], dv[_I], dw[_I]]))
            for f, md in zip((du, dv, dw), med):
                f[_I] = md
        u, v, w = u + du, v + dv, w + dw
    out = torch.stack([u[_I], v[_I], w[_I]], dim=-1)
    if eff_min > 0:
        out = torch.stack([resize_volume(out[..., k], (p, m, n), mm)
                           for k in range(3)], dim=-1)
    return out


def register(fixed, moving, uvw, weight, params, mm=fp32_matmul):
    """(flow, the moving volume warped back onto ``fixed``, cubic)."""
    fl = flow(fixed, moving, uvw, weight, params, mm)
    reg = warp(moving, fl[..., 0], fl[..., 1], fl[..., 2], fixed, mm, 3)
    return fl, reg
