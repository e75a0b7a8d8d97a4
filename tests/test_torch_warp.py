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
