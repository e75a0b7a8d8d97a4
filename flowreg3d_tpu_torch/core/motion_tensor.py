"""Motion tensors for the variational data term.

Counterpart of ``flowreg3d_tpu/core/motion_tensor.py``. Each constancy
assumption gives the 10 unique entries [J11,J22,J33,J44,J12,J13,J23,J14,
J24,J34] of a symmetric 4x4 per-voxel tensor, on the volume padded by one
voxel with zeroed faces.
"""

import torch

from flowreg3d_tpu_torch.ops.gradients import gradient_zyx, second_diff_zyx


def pad_edge(f):
    """Pad a (Z,Y,X) tensor by one voxel on each side with its edge values.

    A one-voxel 'symmetric' pad is the same as an edge pad.
    """
    f = torch.cat([f[:1], f, f[-1:]], dim=0)
    f = torch.cat([f[:, :1], f, f[:, -1:]], dim=1)
    return torch.cat([f[:, :, :1], f, f[:, :, -1:]], dim=2)


def _repad_interior(f):
    """Replace the one-voxel border with a symmetric pad of the interior."""
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


def _averaged_derivatives(f1p, f2p, hz, hy, hx):
    gz1, gy1, gx1 = gradient_zyx(f1p, hz, hy, hx)
    gz2, gy2, gx2 = gradient_zyx(f2p, hz, hy, hx)
    fx = _repad_interior(0.5 * (gx1 + gx2))
    fy = _repad_interior(0.5 * (gy1 + gy2))
    fz = _repad_interior(0.5 * (gz1 + gz2))
    ft = _repad_interior(f2p - f1p)
    return fx, fy, fz, ft


def get_motion_tensor_gc(f1, f2, hz, hy, hx):
    """Gradient-constancy motion tensor on (Z,Y,X) volumes -> 10 padded entries."""
    f1p = pad_edge(f1)
    f2p = pad_edge(f2)
    fx, fy, fz, ft = _averaged_derivatives(f1p, f2p, hz, hy, hx)

    dfx = gradient_zyx(fx, hz, hy, hx)
    dfy = gradient_zyx(fy, hz, hy, hx)
    dft = gradient_zyx(ft, hz, hy, hx)
    fxy = dfx[1]
    fxz = dfx[0]
    fyz = dfy[0]
    fzt, fyt, fxt = dft

    fxx1, fyy1, fzz1 = second_diff_zyx(f1p, hz, hy, hx)
    fxx2, fyy2, fzz2 = second_diff_zyx(f2p, hz, hy, hx)
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


def get_motion_tensor_gray(f1, f2, hz, hy, hx):
    """Brightness-constancy motion tensor."""
    fx, fy, fz, ft = _averaged_derivatives(pad_edge(f1), pad_edge(f2),
                                           hz, hy, hx)
    return _zero_faces((
        fx * fx, fy * fy, fz * fz, ft * ft,
        fx * fy, fx * fz, fy * fz,
        fx * ft, fy * ft, fz * ft,
    ))


def get_motion_tensor_cs(f1, f2, hz, hy, hx):
    """Census-like motion tensor: eps=80, 26 neighbours."""
    eps = 80.0
    eps2 = eps * eps
    eps4 = eps2 * eps2

    f1p = pad_edge(f1)
    f2p = pad_edge(f2)
    It = _repad_interior(f2p - f1p)
    gz, gy, gx = (_repad_interior(g) for g in gradient_zyx(f2p))

    offsets = [
        (dz, dy, dx)
        for dz in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if not (dz == 0 and dy == 0 and dx == 0)
    ]
    invN = 1.0 / float(len(offsets))

    Js = [torch.zeros_like(f1p) for _ in range(10)]
    for dz, dy, dx in offsets:
        def roll(a):
            return torch.roll(a, shifts=(-dz, -dy, -dx), dims=(0, 1, 2))

        delIm = roll(f2p) - f2p
        denom = eps2 + delIm * delIm
        wgt = eps4 / (4.0 * denom * denom * denom)
        dIx = roll(gx) - gx
        dIy = roll(gy) - gy
        dIz = roll(gz) - gz
        dIt = roll(It) - It
        terms = (dIx * dIx, dIy * dIy, dIz * dIz, dIt * dIt,
                 dIx * dIy, dIx * dIz, dIy * dIz,
                 dIx * dIt, dIy * dIt, dIz * dIt)
        Js = [J + wgt * t for J, t in zip(Js, terms)]
    return _zero_faces(tuple(J * invN for J in Js))


MOTION_TENSORS = {
    "gc": get_motion_tensor_gc,
    "gray": get_motion_tensor_gray,
    "cs": get_motion_tensor_cs,
}
