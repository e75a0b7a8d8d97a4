"""Port parity: gradients, resize and motion tensors against the JAX package.

Inputs come from a numpy seed and go through the JAX function (its XLA
path on the CPU) and the port's PyTorch version. Bound: 2e-5 (fp32
stencils and fp32 matrix products that differ only in summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowreg3d_tpu.core import motion_tensor as jmt
from flowreg3d_tpu.ops import gradients as jgr
from flowreg3d_tpu.ops import resize as jrs

from flowreg3d_tpu_torch.core import motion_tensor as tmt
from flowreg3d_tpu_torch.ops import gradients as tgr
from flowreg3d_tpu_torch.ops import resize as trs

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _vol(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).random(shape).astype(dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("h", [(1.0, 1.0, 1.0), (1.25, 2.0, 0.8)])
def test_gradients(h):
    f = _vol((7, 9, 11))
    ft = torch.from_numpy(f)
    for got, want in zip(tgr.gradient_zyx(ft, *h), jgr.gradient_zyx(f, *h)):
        _close(got, want)
    for got, want in zip(tgr.second_diff_zyx(ft, *h),
                         jgr.second_diff_zyx(f, *h)):
        _close(got, want)
    flow = _vol((7, 9, 11, 3), seed=1)
    _close(tgr.divergence(torch.from_numpy(flow), *h),
           jgr.divergence(flow, *h))


@pytest.mark.parametrize("in_shape,out_size,per_axis", [
    ((16, 40, 36), (9, 23, 20), False),      # downsample (Gaussian on)
    ((9, 23, 20), (16, 40, 36), False),      # upsample (no Gaussian)
    ((12, 30, 30, 2), (8, 17, 25), True),    # channels, per-axis sigma
])
def test_resize_volume(in_shape, out_size, per_axis):
    v = _vol(in_shape, seed=2)
    got = trs.resize_volume(torch.from_numpy(v), out_size, per_axis=per_axis)
    want = jrs.resize_volume(v, out_size, per_axis=per_axis)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_resize_float64_matches_float32():
    v = _vol((10, 20, 18), seed=3, dtype=np.float64)
    got = trs.resize_volume(torch.from_numpy(v), (6, 13, 11),
                            dtype=torch.float64)
    assert got.dtype == torch.float64
    want = jrs.resize_volume(v.astype(np.float32), (6, 13, 11))
    _close(got, want)


@pytest.mark.parametrize("np_dtype,torch_dtype,scale", [
    (np.uint8, torch.uint8, 255.0),
    (np.int16, torch.int16, 3000.0),
    (np.float32, torch.float32, 1.0),
])
def test_imresize_round_and_clip(np_dtype, torch_dtype, scale):
    rng = np.random.default_rng(4)
    # values at the type's limits exercise the clip; the cubic overshoots
    img = (rng.random((6, 20, 22)) * scale).astype(np_dtype)
    img[:, ::3] = np.iinfo(np_dtype).max if scale > 1 else 1.0
    got = trs.imresize_fused_gauss_cubic3D(
        torch.from_numpy(img).to(torch_dtype), (5, 31, 13))
    want = np.asarray(jrs.imresize_fused_gauss_cubic3D(img, (5, 31, 13)))
    assert got.dtype == torch_dtype and want.dtype == np_dtype
    if scale > 1:
        # integer outputs: a round-half case may flip by one count when the
        # fp32 products differ in the last bit
        diff = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    else:
        _close(got, want)


@pytest.mark.parametrize("name", ["gc", "gray", "cs"])
def test_motion_tensors(name):
    rng = np.random.default_rng(5)
    f1 = rng.random((6, 10, 12)).astype(np.float32)
    f2 = (f1 + 0.05 * rng.standard_normal(f1.shape)).astype(np.float32)
    h = (1.2, 1.1, 0.9)
    got = tmt.MOTION_TENSORS[name](torch.from_numpy(f1), torch.from_numpy(f2),
                                   *h)
    want = jmt.MOTION_TENSORS[name](jnp.asarray(f1), jnp.asarray(f2), *h)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert tuple(g.shape) == (8, 12, 14)
        w = np.asarray(w)
        # J entries scale with 1/(|H|^2 + 1e-6); hold them relative to
        # the entry's own range
        _close(g, w, rtol=2e-5, atol=2e-5 * max(1.0, np.abs(w).max()))
