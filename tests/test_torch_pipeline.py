"""Port parity: the pipeline (``flowreg3d_tpu_torch.pipeline``) against the
JAX package's, on the CPU.

- ``compensate_arr`` on the fixtures of tests/pipeline/conftest.py (T=4,
  (10,20,24,1)) with ``fast_options(a_smooth=0.5)`` given to both through
  ``convert.options_from_jax``, against the JAX ``compensate_arr`` with
  ``RegistrationConfig(parallelization="sequential", device_resident=False)``:
  max |registered difference| <= 1e-4 and max |flow difference| <= 1e-3,
  with update_initialization_w on and off;
- ``flow_statistics`` within 1e-5; ``normalize`` and
  ``apply_gaussian_filter`` on 4D and 5D inputs within 2e-6, the symmetric
  padding exactly;
- the shape matrix, output casting, progress and options handling of
  tests/pipeline/test_compensate.py on the port alone.
"""

import numpy as np
import pytest
import torch

from flowreg3d_tpu.ops import filters as jfilters
from flowreg3d_tpu.pipeline import RegistrationConfig as JaxConfig
from flowreg3d_tpu.pipeline import compensate_arr as jax_compensate
from flowreg3d_tpu.pipeline import flow_statistics as jax_stats

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.ops import filters as tfilters
from flowreg3d_tpu_torch.pipeline import (BatchMotionCorrector,
                                          OutputFormat, RegistrationConfig,
                                          compensate_arr, flow_statistics)

# the JAX pipeline tests' fixtures, shared so both packages see one case
from tests.pipeline.conftest import (base_volume, fast_options,  # noqa: F401
                                     video5d)

torch.set_num_threads(1)

JAX_CONFIG = JaxConfig(parallelization="sequential", device_resident=False)


def _both(video, ref, **overrides):
    opts = fast_options(a_smooth=0.5, **overrides)
    want = jax_compensate(video, ref, options=opts, config=JAX_CONFIG)
    got = compensate_arr(video, ref, options=options_from_jax(opts),
                         device="cpu")
    return got, want


@pytest.mark.parametrize("update_w", [True, False])
def test_compensate_arr_matches_jax(video5d, base_volume, update_w):
    (reg, w), (reg_j, w_j) = _both(video5d, base_volume,
                                   update_initialization_w=update_w)
    assert reg.shape == reg_j.shape == video5d.shape
    assert reg.dtype == reg_j.dtype
    assert w.shape == w_j.shape == video5d.shape[:4] + (3,)
    np.testing.assert_allclose(reg, reg_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-3)
    err_before = np.abs(video5d - base_volume[None]).mean()
    assert np.abs(reg - base_volume[None]).mean() < err_before


def test_shape_matrix_and_casting(video5d, base_volume):
    opts = options_from_jax(fast_options(a_smooth=0.5))
    reg, w = compensate_arr(video5d[..., 0], base_volume[..., 0],
                            options=opts, device="cpu")
    assert reg.shape == video5d.shape[:4]
    assert w.shape == video5d.shape[:4] + (3,)
    reg, w = compensate_arr(video5d[1, ..., 0], base_volume[..., 0],
                            options=opts, device="cpu")
    assert reg.shape == video5d.shape[1:4]
    assert w.shape == video5d.shape[1:4] + (3,)
    for name, dtype in (("single", np.float32), ("uint16", np.uint16)):
        opts.output_typename = name
        reg, _ = compensate_arr(video5d[:1], base_volume, options=opts,
                                device="cpu")
        assert reg.dtype == dtype


def test_progress_statistics_and_options_untouched(video5d, base_volume):
    opts = options_from_jax(fast_options(a_smooth=0.5))
    seen = []
    opts_copy = opts.copy()
    reg, w = compensate_arr(video5d[:2], base_volume, options=opts,
                            progress_callback=lambda d, t: seen.append((d, t)),
                            device="cpu")
    assert seen == [(1, 2), (2, 2)]
    assert opts.output_format == opts_copy.output_format
    assert opts.save_w == opts_copy.save_w

    corrector = BatchMotionCorrector(
        opts.replace(input_file=video5d, reference_frames=base_volume,
                     output_format=OutputFormat.ARRAY, save_w=True),
        device="cpu")
    corrector.run()
    want = jax_stats(corrector.w_writer.get_array())
    for k in want:
        np.testing.assert_allclose(getattr(corrector, k), want[k], rtol=1e-5,
                                   atol=1e-5)


def test_flow_statistics_matches_jax():
    rng = np.random.default_rng(1)
    flows = rng.standard_normal((3, 6, 8, 9, 3)).astype(np.float32)
    flows[1] = 0.0
    flows[1, ..., 0] = 2.0
    got, want = flow_statistics(torch.from_numpy(flows)), jax_stats(flows)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    assert got["mean_disp"][1] == pytest.approx(2.0)


@pytest.mark.parametrize("shape,sigma", [
    ((10, 20, 24, 2), [[1.0, 1.5, 0.7, 0.1], [2.0, 1.0, 1.0, 0.1]]),
    ((5, 10, 20, 24, 1), [1.0, 1.0, 1.0, 2.0]),
    ((4, 3, 7, 9, 2), [[1.0, 1.0, 1.0, 0.1]])])
@pytest.mark.parametrize("mode", ["together", "separate"])
@pytest.mark.parametrize("with_ref", [False, True])
def test_preprocessing_matches_jax(shape, sigma, mode, with_ref):
    rng = np.random.default_rng(2)
    a = rng.random(shape).astype(np.float32)
    ref = rng.random(shape[-4:]) * 1.5 if with_ref else None
    want = np.asarray(jfilters.apply_gaussian_filter(
        jfilters.normalize(a, ref=ref, channel_normalization=mode),
        sigma=np.asarray(sigma, float)))
    got = tfilters.apply_gaussian_filter(
        tfilters.normalize(torch.from_numpy(a),
                           ref=None if ref is None else torch.from_numpy(ref),
                           channel_normalization=mode),
        np.asarray(sigma, float)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_symmetric_padding_matches_numpy(n):
    x = np.arange(n)
    for r in (0, 1, 4, 11):
        idx = tfilters.symmetric_pad_index(n, r).numpy()
        np.testing.assert_array_equal(x[idx], np.pad(x, r, mode="symmetric"))


def test_unported_requests_raise(base_volume):
    opts = options_from_jax(fast_options(a_smooth=0.5))
    with pytest.raises(ValueError):
        compensate_arr(np.empty((0, 2, 2, 2, 1)), base_volume, device="cpu")
    for cfg in (RegistrationConfig(parallelization="batched"),
                RegistrationConfig(checkpoint=True),
                RegistrationConfig(prefetch=2),
                RegistrationConfig(flow_backend="volraft")):
        with pytest.raises(NotImplementedError, match="Queue 1"):
            BatchMotionCorrector(opts, cfg, device="cpu")
    for field, queue in (("cc_initialization", "item 9"),
                         ("save_valid_idx", "item 8")):
        with pytest.raises(NotImplementedError, match=queue):
            BatchMotionCorrector(opts.replace(**{field: True}), device="cpu")
    with pytest.raises(ValueError, match="Unknown executor"):
        BatchMotionCorrector(opts, RegistrationConfig(parallelization="gpu9"),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        BatchMotionCorrector(opts.replace(output_format=OutputFormat.MAT,
                                          input_file=base_volume[None],
                                          reference_frames=base_volume),
                             device="cpu").run()
