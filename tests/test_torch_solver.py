"""Port parity: the level solver against ``flowreg3d_tpu.core.solver._solve``
with ``use_pallas=False`` (the XLA path the JAX package runs on the CPU).

Bounds: one ``update_lag`` block within 2e-5 (the per-call bar of the JAX
package's own kernel tests); a whole multi-block level within 1e-3, as the
JAX package allows its fused solver against its XLA path (the lagged
re-linearisation amplifies last-bit differences from block to block).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowreg3d_tpu.core.solver import _solve

from flowreg3d_tpu_torch.core import solver as tsolver
from flowreg3d_tpu_torch.core import solver_kernel, solver_psi_kernel

torch.set_num_threads(1)


def _inputs(shape=(10, 14, 18), C=1, seed=0):
    rng = np.random.default_rng(seed)
    p, m, n = shape
    J = (rng.random((10, C, p, m, n)) * 0.1).astype(np.float32)
    # diagonal entries dominate so the data block stays positive definite
    J[:3] += 0.5
    weight = np.full((C, p, m, n), 1.0 / C, np.float32)
    u, v, w = ((rng.random((p, m, n)) * 0.5).astype(np.float32)
               for _ in range(3))
    return J, weight, u, v, w


def _jax(J, weight, u, v, w, alpha, a_data, a_smooth, h, iterations, lag):
    out = _solve(jnp.asarray(J), jnp.asarray(weight), jnp.asarray(u),
                 jnp.asarray(v), jnp.asarray(w),
                 jnp.asarray(alpha, jnp.float32),
                 jnp.asarray(a_data, jnp.float32),
                 jnp.asarray(a_smooth, jnp.float32),
                 *(jnp.asarray(x, jnp.float32) for x in (h[2], h[1], h[0])),
                 iterations, lag, a_smooth == 1.0, False)
    return [np.asarray(o) for o in out]


def _port(J, weight, u, v, w, alpha, a_data, a_smooth, h, iterations, lag,
          use_kernels=True):
    t = torch.from_numpy
    out = tsolver.compute_flow_level_cl(
        t(J), t(weight), t(u), t(v), t(w), alpha, iterations, lag, a_data,
        a_smooth, h[2], h[1], h[0], use_kernels=use_kernels)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_one_update_lag_block(use_kernels, a_smooth):
    args = (*_inputs(), (1.5, 1.2, 1.1), [0.45], a_smooth, (1.1, 1.0, 0.9),
            5, 5)
    for got, want in zip(_port(*args, use_kernels=use_kernels), _jax(*args)):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,C", [((9, 12, 16), 1), ((12, 16, 14), 2)])
def test_whole_level(shape, C):
    args = (*_inputs(shape, C, seed=1), (1.0, 1.0, 1.0), [0.45] * C, 1.0,
            (1.0, 1.0, 1.0), 20, 5)
    for got, want in zip(_port(*args), _jax(*args)):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_folded_halfsweep_equals_unfolded():
    """Kernel formulation (base Laplacian folded into SJ14/24/34, clamped
    Neumann faces) == the unfolded constant-weight half-sweep with ring
    copies (``solver_psi_kernel.halfsweep``), float64."""
    J, weight, u, v, w = (torch.from_numpy(a.astype(np.float64))
                          for a in _inputs(seed=2))
    rng = np.random.default_rng(3)
    duvw = torch.from_numpy(rng.random((3,) + tuple(u.shape)) * 0.1)
    tsolver.set_boundary_3d(duvw)
    a_vec = torch.tensor([0.45], dtype=torch.float64)
    SJ = tsolver.tick_update(J, weight, a_vec, *duvw)
    ax, ay, az = 1.5, 1.2, 0.8
    laps = [solver_kernel.base_laplacian(b, ax, ay, az) for b in (u, v, w)]
    sj = solver_kernel.fold_base(SJ, laps)
    base, sj_unfolded = torch.stack([u, v, w]), torch.stack(SJ)
    unfolded = duvw.clone()
    for parity in (0, 1):
        solver_psi_kernel.halfsweep(unfolded, base, sj_unfolded, ax, ay, az,
                                    parity)
        solver_kernel.sor_halfsweep_plain(duvw, sj, ax, ay, az, parity)
        torch.testing.assert_close(duvw[:, 1:-1, 1:-1, 1:-1],
                                   unfolded[:, 1:-1, 1:-1, 1:-1], rtol=1e-12,
                                   atol=1e-12)


def test_cpu_sweeps_count_no_launch():
    J, weight, u, v, w = _inputs()
    before = solver_kernel.sor_iterations.launches
    _port(J, weight, u, v, w, (1.0,) * 3, [0.45], 1.0, (1.0,) * 3, 5, 5)
    assert solver_kernel.sor_iterations.launches == before


@pytest.mark.parametrize("iterations,lag,blocks", [
    (10, 5, [5, 5]), (12, 5, [5, 5, 2]), (3, 5, [3]), (4, 1, [1] * 4)])
def test_one_kernel_call_per_tick_block(monkeypatch, iterations, lag,
                                        blocks):
    """The a_smooth == 1 solver calls the tick-block wrapper once per tick
    block (one launch on the card), the last block holding the remainder."""
    calls = []
    tick_block = solver_kernel.sor_iterations

    def counting(duvw, sj, ax, ay, az, n_iters):
        calls.append(n_iters)
        return tick_block(duvw, sj, ax, ay, az, n_iters)

    monkeypatch.setattr(solver_kernel, "sor_iterations", counting)
    _port(*_inputs(), (1.0,) * 3, [0.45], 1.0, (1.0,) * 3, iterations, lag)
    assert calls == blocks


@pytest.mark.parametrize("n_iters", [5, 3, 1])
def test_tick_block_equals_plain_halfsweeps(n_iters):
    """On CPU tensors the tick-block wrapper is bit-equal to the loop of
    plain red+black half-sweeps it is held to on the card."""
    rng = np.random.default_rng(5)
    shape = (7, 9, 11)
    duvw = torch.from_numpy((0.1 * rng.standard_normal((3,) + shape))
                            .astype(np.float32))
    sj = (0.1 * rng.random((9,) + shape)).astype(np.float32)
    sj[:3] += 0.5
    sj = torch.from_numpy(sj)
    ax, ay, az = 1.5, 1.2, 0.8
    want = duvw.clone()
    for _ in range(n_iters):
        solver_kernel.sor_halfsweep_plain(want, sj, ax, ay, az, 0)
        solver_kernel.sor_halfsweep_plain(want, sj, ax, ay, az, 1)
    for use_kernels in (True, False):
        got = duvw.clone()
        solver_kernel.sweep_iterations(got, sj, ax, ay, az, n_iters,
                                       use_kernels)
        assert torch.equal(got, want)
    # the ring is never written
    assert torch.equal(got[:, 0], duvw[:, 0])
    assert torch.equal(got[:, :, :, -1], duvw[:, :, :, -1])


@pytest.mark.parametrize("iterations,lag,tol", [(3, 5, 2e-5), (8, 5, 1e-3)])
def test_remainder_tick_block_against_jax(iterations, lag, tol):
    """A remainder block alone (one block: the per-call bar) and after a
    full block (two blocks: the whole-level bar), against the JAX solver."""
    args = (*_inputs(seed=6), (1.5, 1.2, 1.1), [0.45], 1.0,
            (1.1, 1.0, 0.9), iterations, lag)
    for got, want in zip(_port(*args), _jax(*args)):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_trailing_channel_layout_matches_channel_leading():
    J, weight, u, v, w = _inputs(C=2, seed=4)
    t = torch.from_numpy
    args = ((1.0, 1.0, 1.0), 10, 5, [0.45, 0.6], 1.0, 1.0, 1.0, 1.0)
    cl = tsolver.compute_flow_level_cl(t(J), t(weight), t(u), t(v), t(w),
                                       *args)
    tl = tsolver.compute_flow_level([t(j).movedim(0, -1) for j in J],
                                    t(weight).movedim(0, -1), t(u), t(v),
                                    t(w), *args)
    for a, b in zip(cl, tl):
        assert torch.equal(a, b)
