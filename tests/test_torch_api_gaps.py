"""Port parity: calls written for the JAX package that the port took with
other names or not at all, against the JAX package, on the CPU.

- ``gaussian_filter_3d(vol, sigma_zyx=..., pad_mode=...)`` in each of the
  ``jnp.pad`` modes the port supports (one case each, an axis shorter than
  the kernel's radius included) and ``apply_gaussian_filter(arr, sigma,
  mode)`` with the mode third, as JAX orders them, at 2e-6; any other mode
  raises a ``ValueError`` naming the supported ones;
- ``bspline_prefilter(vol, dtype=...)`` to and from float64, at 2e-6;
- every executor as a context manager (``setup``, ``__enter__``,
  ``__exit__``), as the JAX executors;
- ``ResidentPipeline.ref_proc_np()``: the processed reference as a float64
  host array, against the JAX engine's at 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowreg3d_tpu.ops import filters as jfilters
from flowreg3d_tpu.ops import warp as jwarp
from flowreg3d_tpu.parallel import executors as jex
from flowreg3d_tpu.pipeline import OFOptions as JaxOptions
from flowreg3d_tpu.pipeline import RegistrationConfig as JaxConfig
from flowreg3d_tpu.pipeline.corrector import \
    BatchMotionCorrector as JaxCorrector

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.ops import filters as tfilters
from flowreg3d_tpu_torch.ops import warp as twarp
from flowreg3d_tpu_torch.parallel import executors as tex
from flowreg3d_tpu_torch.pipeline.corrector import BatchMotionCorrector

from tests.pipeline.test_device_resident import _make_movie

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_float32():
    """JAX's reference in its default float32, whatever an earlier test
    file left in the worker."""
    with jax.enable_x64(False):
        yield


def _volume(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("mode", tfilters.PAD_MODES)
def test_gaussian_filter_3d_pad_modes_match_jax(mode):
    vol = _volume((3, 9, 11, 2))             # z shorter than the radius 6
    sigma = (1.5, 0.8, 2.0)
    got = tfilters.gaussian_filter_3d(torch.from_numpy(vol), sigma_zyx=sigma,
                                      pad_mode=mode)
    want = np.asarray(jfilters.gaussian_filter_3d(vol, sigma_zyx=sigma,
                                                  pad_mode=mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    # each pad index table against numpy's pad itself
    for n, r in ((1, 3), (3, 6), (11, 4)):
        x = np.arange(n)
        kw = dict(constant_values=n) if mode == "constant" else {}
        np.testing.assert_array_equal(
            tfilters.pad_index(n, r, mode).numpy(), np.pad(x, r, mode, **kw))


@pytest.mark.parametrize("mode", ["edge", "wrap"])
def test_apply_gaussian_filter_mode_matches_jax(mode):
    arr = _volume((2, 5, 8, 7, 1), seed=1)
    sigma = [1.0, 1.2, 0.7, 0.5]
    got = tfilters.apply_gaussian_filter(torch.from_numpy(arr), sigma, mode)
    want = np.asarray(jfilters.apply_gaussian_filter(arr, sigma, mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    got = tfilters.apply_gaussian_filter(torch.from_numpy(arr[0]), sigma[:3],
                                         mode=mode, truncate=2.0)
    want = np.asarray(jfilters.apply_gaussian_filter(arr[0], sigma[:3],
                                                     mode=mode, truncate=2.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_unsupported_pad_mode_raises():
    vol = torch.from_numpy(_volume((4, 5, 6)))
    with pytest.raises(ValueError, match="symmetric, reflect, edge"):
        tfilters.gaussian_filter_3d(vol, (1.0, 1.0, 1.0),
                                    pad_mode="linear_ramp")
    with pytest.raises(ValueError, match="supported"):
        tfilters.apply_gaussian_filter(vol[..., None], [0.0] * 3, "mean")


def test_bspline_prefilter_dtype_matches_jax():
    vol = _volume((5, 7, 6), seed=2)
    got = twarp.bspline_prefilter(torch.from_numpy(vol.astype(np.float64)),
                                  dtype=torch.float32)
    want = np.asarray(jwarp.bspline_prefilter(vol, dtype=jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    with jax.enable_x64(True):
        want64 = np.asarray(jwarp.bspline_prefilter(vol, dtype=jnp.float64))
    got64 = twarp.bspline_prefilter(torch.from_numpy(vol),
                                    dtype=torch.float64)
    assert got64.dtype == torch.float64 and want64.dtype == np.float64
    np.testing.assert_allclose(got64.numpy(), want64, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", ["sequential", "batched", "mesh",
                                  "spatial"])
def test_executor_context_manager_like_jax(name, monkeypatch):
    kw = dict(devices=["cpu"]) if name in ("mesh", "spatial") else {}
    ex = tex.get_executor(name, device="cpu", **kw)
    closed = []
    monkeypatch.setattr(ex, "cleanup", lambda: closed.append(True))
    assert ex.setup() is ex
    with ex as entered:
        assert entered is ex and not closed
    assert closed == [True]
    with jex.get_executor("sequential") as jax_ex:
        assert isinstance(jax_ex, jex.BaseExecutor3D)


def test_ref_proc_np_matches_jax():
    movie = _make_movie(np.random.default_rng(7))[..., None]
    opts = JaxOptions(input_file=movie, output_format="ARRAY",
                      quality_setting="fast", iterations=4, levels=4,
                      min_level=2, buffer_size=3, save_meta_info=False,
                      reference_frames=[0, 1])
    engines = []
    for corr in (JaxCorrector(opts, JaxConfig(parallelization="sequential",
                                              prefetch=0,
                                              async_write=False)),
                 BatchMotionCorrector(options_from_jax(opts),
                                      device="cpu")):
        corr._setup_io()
        corr._setup_reference()
        corr._setup_resident()
        engines.append(corr._resident)
    want, got = (e.ref_proc_np() for e in engines)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
