"""Port parity: cross-correlation prealignment (``ops/xcorr.py``,
``util/xcorr_prealignment.py``, the executors' cc steps) against the JAX
package, on the CPU.

- ``phase_cross_correlation`` / ``phase_xcorr_shift`` on the 2-D cases of
  tests/util/test_xcorr.py, with and without disambiguation: the JAX
  shifts to 1e-5 (and the truth at that file's tolerances).
- ``estimate_rigid_xcorr_3d`` on its 3-D cases. On the downscaled case the
  JAX shifts to 1e-5. On the pure-translation and two-channel cases the
  volumes are smoothed so far that the phase-normalised spectrum's upper
  half is float32 rounding noise, and the peak follows that noise: the JAX
  estimate itself moves by 0.1 voxel when its input is scaled by
  1 + 2**-22, and the port's by up to 0.4 from JAX's, since the two sum
  the projections in different orders. There the windowed projections are
  held to JAX's within 5e-7 and the shift found on JAX's own projections
  to 1e-5, which leaves only the projections' rounding between them.
- The prealign program (warp by w_init, xcorr residual, combine, warp)
  against JAX ``_prealign_traced`` at 1e-4, the case of
  tests/parallel/test_cc_prealign.py.
- The cc pipeline (``cc_initialization=True``) through ``compensate_arr``
  against the JAX pipeline at tests/test_torch_pipeline.py's bounds
  (registered 1e-4, flows 1e-3), a_smooth 0.5, with the executors run
  against each other (batched and sequential, bit for bit).
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import shift as ndshift

import jax.numpy as jnp

from flowreg3d_tpu.ops.xcorr import phase_cross_correlation as jax_pcc
from flowreg3d_tpu.ops.xcorr import phase_xcorr_shift as jax_shift
from flowreg3d_tpu.parallel.executors import _prealign_traced
from flowreg3d_tpu.pipeline import RegistrationConfig as JaxConfig
from flowreg3d_tpu.pipeline import compensate_arr as jax_compensate
from flowreg3d_tpu.util import xcorr_prealignment as jpre

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.ops.xcorr import phase_cross_correlation
from flowreg3d_tpu_torch.ops.xcorr import phase_xcorr_shift
from flowreg3d_tpu_torch.parallel.executors import prealign
from flowreg3d_tpu_torch.pipeline import RegistrationConfig, compensate_arr
from flowreg3d_tpu_torch.util import xcorr_prealignment as tpre

from tests.parallel.test_cc_prealign import _blobby
from tests.pipeline.conftest import (base_volume, fast_options,  # noqa: F401
                                     video5d)
from tests.util.test_xcorr import _blob_image, _blob_volume, _fourier_shift

torch.set_num_threads(1)


@pytest.mark.parametrize("disambiguate", [False, True])
@pytest.mark.parametrize("true_shift", [(3.0, -5.0), (-2.4, 1.6),
                                        (0.0, 0.0)])
def test_phase_xcorr_subpixel_matches_jax(true_shift, disambiguate):
    ref = _blob_image(np.random.default_rng(4))
    mov = _fourier_shift(ref, [-s for s in true_shift])
    want = jax_pcc(ref, mov, upsample_factor=20, disambiguate=disambiguate)
    got = phase_cross_correlation(ref, mov, upsample_factor=20,
                                  disambiguate=disambiguate, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    if not disambiguate:
        np.testing.assert_allclose(got[0], true_shift, atol=0.06)


def test_phase_xcorr_integer_matches_jax():
    ref = _blob_image(np.random.default_rng(5))
    mov = np.roll(ref, (-4, 7), axis=(0, 1))
    want = jax_pcc(ref, mov, upsample_factor=1)[0]
    got = phase_cross_correlation(ref, mov, upsample_factor=1,
                                  device="cpu")[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, (4.0, -7.0), atol=0.01)


def test_rigid_xcorr_downscaled_matches_jax():
    vol = _blob_volume(np.random.default_rng(7), shape=(16, 128, 128))
    true = np.array([0.0, 4.0, -6.0])
    mov = ndshift(vol, true, order=1, mode="nearest")
    want = jpre.estimate_rigid_xcorr_3d(vol, mov, target_hw=(64, 64), up=10)
    got = tpre.estimate_rigid_xcorr_3d(vol, mov, target_hw=(64, 64), up=10,
                                       device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, true[::-1], atol=0.8)


def _rounding_cases():
    rng = np.random.default_rng(6)
    vol = _blob_volume(rng)
    yield vol, ndshift(vol, [2.0, -3.0, 1.0], order=1, mode="nearest"), None
    rng = np.random.default_rng(8)
    vol = _blob_volume(rng)
    noise = rng.random(vol.shape).astype(np.float32)
    mov = ndshift(vol, [1.0, 2.0, -2.0], order=1, mode="nearest")
    yield (np.stack([vol, noise], -1), np.stack([mov, noise], -1),
           np.array([1.0, 0.0], np.float32))


@pytest.mark.parametrize("case", [0, 1])
def test_rigid_xcorr_rounding_dominated_cases(case):
    ref, mov, weight = list(_rounding_cases())[case]
    wj = None if weight is None else jnp.asarray(weight)
    wt = None if weight is None else torch.from_numpy(weight)
    for axis in (0, 1):                          # the XY, then XZ projection
        jr, jm = (jpre._windowed_traced(
            jpre._collapse_channels_traced(jnp.asarray(v), wj).mean(axis))
            for v in (ref, mov))
        tr, tm = (tpre._windowed(
            tpre._collapse_channels(torch.from_numpy(v), wt).mean(axis))
            for v in (ref, mov))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=5e-7)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                                   atol=5e-7)
        want = jax_shift(jr, jm, upsample_factor=10, disambiguate=True)
        got = phase_xcorr_shift(torch.from_numpy(np.array(jr)),
                                torch.from_numpy(np.array(jm)),
                                upsample_factor=10, disambiguate=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_prealign_program_matches_jax():
    Z, Y, X = 8, 24, 32
    ref = _blobby((Z, Y, X), 0)[..., None]
    frame = np.roll(ref, (1, 2, -1), axis=(0, 1, 2))
    w_init = np.zeros((Z, Y, X, 3), np.float32)
    w_init[..., 0] = 0.5
    want_a, want_c = _prealign_traced((16, 16), 5, False)(
        jnp.asarray(frame), jnp.asarray(ref), jnp.asarray(w_init),
        jnp.zeros(1, jnp.float32))
    got_a, got_c = prealign(*(torch.from_numpy(a) for a in (frame, ref,
                                                            w_init)),
                            None, (16, 16), 5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-4,
                               atol=1e-4)


def test_cc_pipeline_matches_jax(video5d, base_volume):
    opts = fast_options(a_smooth=0.5, cc_initialization=True, cc_hw=16,
                        cc_up=5)
    reg_j, w_j = jax_compensate(video5d, base_volume, options=opts,
                                config=JaxConfig(parallelization="sequential",
                                                 device_resident=False))
    got = {}
    for name in ("batched", "sequential"):
        got[name] = compensate_arr(
            video5d, base_volume, options=options_from_jax(opts),
            config=RegistrationConfig(parallelization=name), device="cpu")
    reg, w = got["batched"]
    for a, b in zip(got["batched"], got["sequential"]):
        np.testing.assert_array_equal(a, b)
    assert reg.shape == reg_j.shape and w.shape == w_j.shape
    np.testing.assert_allclose(reg, reg_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-3)
