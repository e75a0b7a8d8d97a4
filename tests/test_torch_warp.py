"""Port parity: B-spline prefilter, sampling and imregister_wrapper against
the JAX package (XLA path on the CPU) and scipy map_coordinates.

Bounds: 2e-5 against the JAX functions (fp32 products and taps summed in
another order); 2e-4 against scipy, which prefilters in float64 (the bar
of the JAX package's own warp kernel test).
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates

from flowreg3d_tpu.ops import warp as jwarp

from flowreg3d_tpu_torch.ops import warp as twarp
from flowreg3d_tpu_torch.ops import warp_kernel

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(shape=(9, 20, 22), C=None, amp=3.0, seed=0):
    rng = np.random.default_rng(seed)
    vshape = shape + ((C,) if C else ())
    f2 = rng.random(vshape).astype(np.float32)
    f1 = rng.random(vshape).astype(np.float32)
    # smooth flow plus noise; amp pushes part of the border out of bounds
    z, y, x = np.meshgrid(*(np.linspace(0, np.pi, n) for n in shape),
                          indexing="ij")
    u = (amp * np.sin(x + y) + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    v = (amp * np.cos(y - z) + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    w = (0.5 * amp * np.sin(z) + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    return f2, u, v, w, f1


def test_bspline_prefilter():
    vol = np.random.default_rng(1).random((7, 12, 15)).astype(np.float32)
    got = twarp.bspline_prefilter(torch.from_numpy(vol))
    want = jwarp.bspline_prefilter(vol)
    assert tuple(got.shape) == (10, 15, 18)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("C", [None, 2])
def test_imregister_wrapper_vs_jax(method, C):
    f2, u, v, w, f1 = _case(C=C)
    got = twarp.imregister_wrapper(f2, u, v, w, f1, method, device="cpu")
    want = jwarp.imregister_wrapper(f2, u, v, w, f1, method)
    assert tuple(got.shape) == f2.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("order", [3, 1])
def test_map_coords_plain_vs_scipy(order):
    rng = np.random.default_rng(2)
    vol = rng.random((8, 14, 16)).astype(np.float32)
    coords = [rng.uniform(0, n - 1, (5, 7, 9)).astype(np.float32)
              for n in vol.shape]
    coords[0][0, 0, :3] = (0.0, 7.0, 6.9999)     # the clamped faces
    want = map_coordinates(vol.astype(np.float64), coords, order=order,
                           mode="nearest")
    cz, cy, cx = (torch.from_numpy(c) for c in coords)
    vt = torch.from_numpy(vol)
    sample = {3: twarp.map_coordinates_cubic, 1: twarp.map_coordinates_linear}
    before = warp_kernel.map_coords.launches
    got = sample[order](vt, cz, cy, cx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    # CPU tensors take the plain version: no kernel launch is counted
    assert warp_kernel.map_coords.launches == before
    plain = sample[order](vt, cz, cy, cx, use_kernels=False)
    assert torch.equal(got, plain)


def test_out_of_bounds_voxels_come_from_fixed():
    f2, u, v, w, f1 = _case(amp=0.0)
    u[:, :, -3:] = 50.0                    # far outside along x
    got = twarp.imregister_wrapper(f2, u, v, w, f1, device="cpu").numpy()
    np.testing.assert_array_equal(got[:, :, -3:], f1[:, :, -3:])


def test_float64_plain_path():
    f2, u, v, w, f1 = (a.astype(np.float64) for a in _case(amp=1.0))
    got = twarp.imregister_wrapper(f2, u, v, w, f1, device="cpu")
    assert got.dtype == torch.float64
    want = jwarp.imregister_wrapper(*(a.astype(np.float32)
                                      for a in (f2, u, v, w, f1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)



def _flow_coords(shape, seed, jumps=0.0):
    """Coordinates of a smooth flow of a few voxels, optionally with sparse
    far jumps, clipped to the volume."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in shape),
                        indexing="ij")
    coords = []
    for a, (g, n) in enumerate(zip(grids, shape)):
        f = 1.5 * np.sin(g / 5.0 + a) + 0.3 * rng.standard_normal(shape)
        f = f + 30.0 * (rng.random(shape) < jumps)
        coords.append(np.clip(g + f, 0, n - 1).astype(np.float32))
    return coords


@pytest.mark.parametrize("order", [3, 1])
@pytest.mark.parametrize("kind", ["ragged", "far jumps", "flat", "planar"])
def test_map_coords_plain_layouts_vs_scipy(kind, order):
    """The plain version the kernel is held to, on the layouts the kernel's
    tiling must cover: a ragged 3-D volume (partial tiles on every axis),
    sparse far jumps (scattered taps), and coordinates that are not 3-D
    (the kernel tiles them as one row)."""
    vol = np.random.default_rng(4).random((13, 21, 35)).astype(np.float32)
    coords = _flow_coords(vol.shape, 5, 0.01 if kind == "far jumps" else 0.0)
    shape = {"flat": (-1,), "planar": (13 * 21, 35)}.get(kind, vol.shape)
    coords = [c.reshape(shape) for c in coords]
    want = map_coordinates(vol.astype(np.float64), coords, order=order,
                           mode="nearest")
    cz, cy, cx = (torch.from_numpy(np.ascontiguousarray(c)) for c in coords)
    vt = torch.from_numpy(vol)
    coeff = (twarp.bspline_prefilter(vt) if order == 3
             else twarp._pad_far_edge(vt).contiguous())
    got = warp_kernel.map_coords(coeff, cz, cy, cx, order)
    assert got.shape == cz.shape
    assert warp_kernel._out_shape(cz) == (
        tuple(cz.shape) if cz.dim() == 3 else (1, 1, cz.numel()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("amp", [0.0, 3.0, 50.0])
def test_sample_coords_clamp_and_mask(amp):
    """The warp's coordinate build: identity grid plus displacement,
    clamped to the volume, and the mask of voxels displaced outside it."""
    f2, u, v, w, _ = _case(amp=amp)
    cz, cy, cx, oob = twarp.sample_coords(*(torch.from_numpy(a)
                                            for a in (u, v, w)))
    grids = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in u.shape),
                        indexing="ij")
    moved = [g + d for g, d in zip(grids, (w, v, u))]
    want_oob = np.zeros(u.shape, bool)
    for m, n in zip(moved, u.shape):
        want_oob |= (m < 0) | (m >= n)
    np.testing.assert_array_equal(oob.numpy(), want_oob)
    for got, m, g, n in zip((cz, cy, cx), moved, grids, u.shape):
        want = np.where(want_oob, g, np.clip(m, 0, n - 1))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.is_contiguous()
