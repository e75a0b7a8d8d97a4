"""Port parity: the coarse-to-fine pyramid against flowreg3d_tpu.core.pyramid.

Shape (16,48,48) with the JAX package's single-chip entry parameters
(alpha=1.5, update_lag=5, iterations=10, min_level=0, levels=20,
a_smooth=1, gc).

- Level by level: each level's JAX inputs go through both packages. The
  resize, warp and motion tensor hold at 2e-5 (relative to the entries'
  range for the tensor), the level solve at 1e-3 (a whole multi-block
  solve, the JAX package's own bar), the median exactly.
- End to end: tests/test_torch_convert.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flowreg3d_tpu.core import pyramid as jpyr
from flowreg3d_tpu.core.motion_tensor import get_motion_tensor_gc
from flowreg3d_tpu.core.solver import compute_flow_level_cl as jax_level
from flowreg3d_tpu.ops.filters import median_filter_5x5x5 as jax_median
from flowreg3d_tpu.ops.resize import resize_volume as jax_resize
from flowreg3d_tpu.ops.warp import imregister_wrapper as jax_warp

from flowreg3d_tpu_torch.core import pyramid as tpyr
from flowreg3d_tpu_torch.core.motion_tensor import get_motion_tensor_gc as tgc
from flowreg3d_tpu_torch.core.solver import compute_flow_level_cl as t_level
from flowreg3d_tpu_torch.ops.filters import median_filter_5x5x5 as t_median
from flowreg3d_tpu_torch.ops.resize import resize_volume as t_resize
from flowreg3d_tpu_torch.ops.warp import warp as t_warp

torch.set_num_threads(1)

SHAPE = (16, 48, 48)
PARAMS = dict(alpha=(1.5, 1.5, 1.5), update_lag=5, iterations=10,
              min_level=0, levels=20, eta=0.8, a_smooth=1.0, a_data=0.45)


def pair():
    rng = np.random.default_rng(0)
    fixed = rng.random(SHAPE + (1,)).astype(np.float32)
    moving = np.roll(fixed, (0, 1, -1), axis=(0, 1, 2))
    uvw = np.zeros(SHAPE + (3,), np.float32)
    weight = np.ones(SHAPE + (1,), np.float32)
    return fixed, moving, uvw, weight


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_schedule_matches():
    for shape in (SHAPE, (64, 512, 512), (5, 30, 40)):
        for min_level in (0, 5):
            assert (tpyr.level_schedule(shape, 0.8, 50, min_level)
                    == jpyr.level_schedule(shape, 0.8, 50, min_level))


def test_level_by_level():
    # jitted JAX pieces: op-by-op dispatch compiles every primitive per
    # level shape and costs several times more
    jresize = jax.jit(jax_resize, static_argnums=1)
    jwarp = jax.jit(jax_warp)
    jgc = jax.jit(get_motion_tensor_gc, static_argnums=(2, 3, 4))
    jmedian = jax.jit(jax_median)
    fixed, moving, uvw, weight = pair()
    plan, eff_min, _ = jpyr.level_schedule(SHAPE, PARAMS["eta"],
                                           PARAMS["levels"],
                                           PARAMS["min_level"])
    I = (slice(1, -1),) * 3
    u = v = w = None
    for step, (i, size, (hz, hy, hx)) in enumerate(plan):
        f1 = jresize(fixed, size)
        f2 = jresize(moving, size)
        _close(t_resize(_t(fixed), size), f1, 2e-5)
        src = ([uvw[..., k] for k in range(3)] if step == 0
               else [f[I] for f in (u, v, w)])
        u, v, w = (jpyr.add_boundary(jresize(s, size)) for s in src)
        tmp = jwarp(f2, u[I] / hx, v[I] / hy, w[I] / hz, f1)
        _close(t_warp(_t(f2), _t(u[I] / hx), _t(v[I] / hy), _t(w[I] / hz),
                      _t(f1), 3), tmp, 2e-5)

        J = jgc(f1[..., 0], tmp[..., 0], hz, hy, hx)
        for got, want in zip(tgc(_t(f1[..., 0]), _t(tmp[..., 0]), hz, hy, hx),
                             J):
            _close(got, want, 2e-5 * max(1.0, float(jnp.abs(want).max())))

        J = [j[None] for j in J]
        wl = jnp.pad(jnp.moveaxis(jresize(weight, size), -1, 0),
                     ((0, 0), (1, 1), (1, 1), (1, 1)))
        alpha_scaling = 1.0 if i == eff_min else PARAMS["eta"] ** (-0.5 * i)
        alpha = tuple(alpha_scaling * a for a in PARAMS["alpha"])
        args = (alpha, PARAMS["iterations"], PARAMS["update_lag"],
                np.asarray([0.45]), 1.0, hx, hy, hz)
        want = jax_level(J, wl, u, v, w, *args)
        got = t_level([_t(j) for j in J], _t(wl), _t(u), _t(v), _t(w), *args)
        for g, wv in zip(got, want):
            _close(g, wv, 1e-3)

        du, dv, dw = want
        if min(size) > 5:
            for k, f in enumerate((du, dv, dw)):
                med = jmedian(f[I])
                assert torch.equal(t_median(_t(f[I])), _t(med))
            du, dv, dw = (f.at[I].set(jmedian(f[I])) for f in (du, dv, dw))
        u, v, w = u + du, v + dv, w + dw


def test_get_displacement_cpu_matches_pyramid_and_float64_runs():
    fixed, moving, _, _ = pair()
    kw = dict(PARAMS, iterations=4, levels=3)
    flow32 = tpyr.get_displacement(fixed, moving, device="cpu", **kw)
    flow64 = tpyr.get_displacement(fixed, moving, device="cpu",
                                   dtype=torch.float64, **kw)
    assert flow32.dtype == torch.float32 and flow64.dtype == torch.float64
    assert np.abs(flow32.numpy() - flow64.numpy()).max() < 1e-3


def test_get_displacement_cpu_captures_nothing_and_matches_jax(monkeypatch):
    """On the CPU ``get_displacement`` runs the eager pyramid: no CUDA graph
    is made or cached, and the flow holds to JAX's ``get_displacement`` at
    1e-4, without and with an initial flow, a weight vector and a weight
    volume."""
    from flowreg3d_tpu_torch import _graph

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU path")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    _graph.clear()
    rng = np.random.default_rng(3)
    fixed, moving, _, _ = pair()
    fixed = np.concatenate([fixed, np.sqrt(fixed)], axis=-1)
    moving = np.concatenate([moving, np.sqrt(moving)], axis=-1)
    uvw = (0.2 * rng.random(SHAPE + (3,))).astype(np.float32)
    kw = dict(PARAMS, iterations=4, levels=3, a_smooth=0.5)
    for extra in (dict(), dict(uvw=uvw, weight=[0.7, 0.3]),
                  dict(weight=rng.random(SHAPE).astype(np.float32) + 0.5)):
        got = tpyr.get_displacement(fixed, moving, device="cpu", **kw,
                                    **extra)
        want = np.asarray(jpyr.get_displacement(fixed, moving, **kw,
                                                **extra))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert tpyr.pyramid_graphs() == []
