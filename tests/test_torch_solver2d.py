"""Port parity: the 2D red-black SOR level solver
(``flowreg3d_tpu_torch.core.solver2d.compute_flow``) against the JAX
package's, on the CPU.

- JAX's 3 tests of tests/core/test_solver2d.py on the port (translation
  recovery to 0.15 in x at a_smooth 1 and in y at a_smooth 0.5, zero
  motion to 0.05);
- per call against JAX at a_smooth 1 and 0.5: float32 within 2e-5
  (measured 1e-6), float64 within 1e-10 (measured 2e-15). JAX's float64
  runs inside ``jax.enable_x64``, so x64 does not leak into the worker
  (tests/core/test_solver2d.py sets it globally).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndshift

from flowreg3d_tpu.core.solver2d import compute_flow as jax_compute_flow

from flowreg3d_tpu_torch.core import compute_flow

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_float32():
    """JAX's reference in its default float32, whatever an earlier test
    file left in the worker (tests/core/test_solver2d.py turns x64 on for
    the whole process)."""
    with jax.enable_x64(False):
        yield


def _motion_tensor_2d(f1, f2):
    """Brightness-constancy 2D motion tensor (J11, J22, J33, J12, J13, J23)."""
    fx = 0.5 * (np.gradient(f1, axis=1) + np.gradient(f2, axis=1))
    fy = 0.5 * (np.gradient(f1, axis=0) + np.gradient(f2, axis=0))
    ft = f2 - f1
    return (fx * fx, fy * fy, ft * ft, fx * fy, fx * ft, fy * ft)


def _problem(shift_yx=(0.0, 0.4), shape=(40, 44), dtype=np.float64):
    rng = np.random.default_rng(3)
    f1 = gaussian_filter(rng.random(shape), 2.5)
    f2 = ndshift(f1, shift_yx, order=1, mode="nearest")
    J = [np.pad(j, 1, mode="edge")[..., None].astype(dtype)
         for j in _motion_tensor_2d(f1, f2)]
    m, n = shape[0] + 2, shape[1] + 2
    return (J, np.ones((m, n, 1), dtype), np.zeros((m, n), dtype),
            np.zeros((m, n), dtype))


def _port(J, weight, u, v, **kw):
    du, dv = compute_flow(J, weight, u, v, device="cpu", **kw)
    assert du.dtype == dv.dtype == torch.from_numpy(u).dtype
    return du.numpy(), dv.numpy()


def test_translation_recovery_x():
    du, dv = _port(*_problem(shift_yx=(0.0, 0.4)), alpha=(0.02, 0.02),
                   iterations=80, update_lag=5, a_data=1.0, a_smooth=1.0)
    assert abs(np.median(du[8:-8, 8:-8]) - 0.4) < 0.15
    assert abs(np.median(dv[8:-8, 8:-8])) < 0.15


def test_translation_recovery_y_nonlinear():
    du, dv = _port(*_problem(shift_yx=(0.4, 0.0)), alpha=(0.02, 0.02),
                   iterations=80, update_lag=5, a_data=0.45, a_smooth=0.5)
    assert abs(np.median(dv[8:-8, 8:-8]) - 0.4) < 0.15
    assert abs(np.median(du[8:-8, 8:-8])) < 0.15


def test_zero_motion_gives_zero_flow():
    du, dv = _port(*_problem(shift_yx=(0.0, 0.0)), alpha=(0.02, 0.02),
                   iterations=40, update_lag=5, a_data=0.45, a_smooth=1.0)
    assert np.abs(du).max() < 0.05
    assert np.abs(dv).max() < 0.05


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("a_smooth,a_data,shift", [
    (1.0, 1.0, (0.0, 0.4)), (0.5, 0.45, (0.4, 0.0)), (0.5, (0.45,), (0.3,
                                                                     -0.2))])
def test_compute_flow_matches_jax(dtype, tol, a_smooth, a_data, shift):
    J, weight, u, v = _problem(shift_yx=shift, dtype=dtype)
    # a nonzero accumulated flow exercises the smoothness term's u + du
    u = (u + 0.1 * np.sin(np.arange(u.shape[1]) / 5.0)).astype(dtype)
    kw = dict(alpha=(0.02, 0.03), iterations=30, update_lag=5,
              a_data=a_data, a_smooth=a_smooth, hx=1.0, hy=1.25)

    def jax_call():
        du, dv = jax_compute_flow([jnp.asarray(j) for j in J],
                                  jnp.asarray(weight), jnp.asarray(u),
                                  jnp.asarray(v), **kw)
        return np.asarray(du), np.asarray(dv)

    if dtype == np.float64:
        with jax.enable_x64(True):
            want = jax_call()
    else:
        want = jax_call()
    assert want[0].dtype == dtype
    got = _port(J, weight, u, v, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    assert np.abs(want[0]).max() > 0.05


def test_compute_flow_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    J, weight, u, v = _problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_flow(J, weight, u, v)
