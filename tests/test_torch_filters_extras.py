"""Port parity: the streaming temporal Gaussian and the batch / 2D resizes
(``flowreg3d_tpu_torch.ops.filters`` / ``ops.resize``) against the JAX
package's, on the CPU.

- ``StreamingTemporalGaussian`` / ``gaussian_filter_1d_half_kernel``
  against JAX at 1e-12, a stream split across batches included, and JAX's
  own checks of tests/pipeline/test_preprocess_extras.py on the port;
- ``resize_batch`` against JAX at 2e-6, with and without a channel axis;
- ``imresize2d_gauss_cubic`` against JAX: floats at 2e-6, ``uint8`` under
  the one-count round-half rule of tests/test_torch_ops.py.
"""

import jax
import numpy as np
import pytest
import torch

from flowreg3d_tpu.ops import filters as jfilters
from flowreg3d_tpu.ops import resize as jresize

from flowreg3d_tpu_torch.ops import (StreamingTemporalGaussian,
                                     imresize2d_gauss_cubic, resize_batch)
from flowreg3d_tpu_torch.ops.filters import gaussian_filter_1d_half_kernel

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_float32():
    """JAX's reference in its default float32, whatever an earlier test
    file left in the worker (tests/core/test_solver2d.py turns x64 on for
    the whole process)."""
    with jax.enable_x64(False):
        yield


@pytest.mark.parametrize("sigma", [0.0, 0.8, 1.5, 3.0])
def test_streaming_gaussian_matches_jax(sigma):
    rng = np.random.default_rng(0)
    frames = rng.random((12, 4, 5, 2)).astype(np.float32)
    got = StreamingTemporalGaussian(sigma).filter_batch(frames)
    want = jfilters.StreamingTemporalGaussian(sigma).filter_batch(frames)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the stream split across batches, continued through the state
    a, state = gaussian_filter_1d_half_kernel(frames[:5], sigma)
    b, state = gaussian_filter_1d_half_kernel(frames[5:9], sigma,
                                              state=state)
    c, _ = gaussian_filter_1d_half_kernel(frames[9:], sigma, state=state)
    np.testing.assert_allclose(np.concatenate([a, b, c]), want, rtol=0,
                               atol=1e-12)
    state.reset()
    np.testing.assert_allclose(state(frames[0]), frames[0], rtol=0,
                               atol=1e-12)


def test_streaming_temporal_gaussian_half_kernel():
    rng = np.random.default_rng(0)
    frames = rng.random((12, 4, 5)).astype(np.float64)
    filt = StreamingTemporalGaussian(sigma=1.5)
    out = filt.filter_batch(frames)
    assert out.shape == frames.shape
    k = filt.kernel
    t = 10
    expect = sum(k[i] * frames[t - i] for i in range(filt.radius + 1))
    np.testing.assert_allclose(out[t], expect, rtol=1e-12)
    np.testing.assert_allclose(out[0], frames[0], rtol=1e-12)


@pytest.mark.parametrize("per_axis", [False, True])
@pytest.mark.parametrize("channels", [True, False])
def test_resize_batch_matches_jax(per_axis, channels):
    rng = np.random.default_rng(1)
    batch = rng.random((3, 9, 20, 18, 2)).astype(np.float32)
    if not channels:
        batch = batch[..., 0]
    for size in ((5, 11, 9), (12, 24, 30)):
        got = resize_batch(batch, size, per_axis=per_axis, device="cpu")
        want = np.asarray(jresize.resize_batch(batch, size,
                                               per_axis=per_axis))
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    got = resize_batch(torch.from_numpy(batch), (5, 11, 9),
                       dtype=torch.float64, device="cpu")
    assert got.dtype == torch.float64


@pytest.mark.parametrize("shape,out_hw", [((20, 24), (10, 12)),
                                          ((20, 22, 2), (10, 31))])
def test_imresize2d_float_matches_jax(shape, out_hw):
    rng = np.random.default_rng(2)
    img = rng.normal(size=shape).astype(np.float32)
    got = imresize2d_gauss_cubic(img, out_hw, device="cpu")
    want = np.asarray(jresize.imresize2d_gauss_cubic(img, out_hw))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == tuple(out_hw) + shape[2:]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_imresize2d_uint8_matches_jax():
    rng = np.random.default_rng(3)
    img = (rng.random((30, 26)) * 255).astype(np.uint8)
    img[::4] = 255          # the cubic overshoots: the clip is exercised
    got = imresize2d_gauss_cubic(img, (13, 40), device="cpu")
    want = np.asarray(jresize.imresize2d_gauss_cubic(img, (13, 40)))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    # a round-half case may flip by one count when the fp32 products
    # differ in the last bit
    diff = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def test_resizes_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    img = np.zeros((4, 6, 6, 1), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resize_batch(img, (2, 3, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        imresize2d_gauss_cubic(img[0, ..., 0], (3, 3))
