"""Port parity: the flow-driven-diffusivity (a_smooth != 1) solver of
``flowreg3d_tpu_torch.core.solver_psi_kernel`` against the JAX package.

References, all on the CPU: ``flowreg3d_tpu.core.solver._psi_smooth_field``
and ``_solve(use_pallas=False)`` (the XLA path), the numpy red-black oracle
of ``tests/core/oracle.py``, and, in the slow tier, the Pallas half-sweeps
``halfsweep_pallas_psi`` / ``halfsweep_pallas`` and the Pallas tick block
``sweep_iterations_pallas_psi`` in interpret mode.

Bounds: psi within 2e-5 relative (the port takes rsqrt where JAX takes a
general power, and multiplies by 0.5/h where JAX divides by 2h: last-bit
differences); one iteration and one ``update_lag`` block within 2e-5, the
per-call bar of tests/core/test_solver_pallas.py:62,157; a whole level
within 1e-3, as tests/core/test_solver_pallas.py:204-210 allows its fused
solver against the XLA path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flowreg3d_tpu.core import solver as jsolver
from flowreg3d_tpu.core.solver import _solve

from flowreg3d_tpu_torch.core import solver_psi_kernel as spk
from flowreg3d_tpu_torch.core import solver as tsolver

from tests.core.oracle import sor_redblack_oracle
from tests.test_torch_solver import _inputs, _jax, _port

torch.set_num_threads(1)

SHAPE = (9, 12, 16)
ALPHA = (1.0, 1.2, 0.9)
H = (1.1, 1.0, 0.9)                       # (hz, hy, hx)


def _fields(seed=0, ring_noise=False):
    """Stacked increments (ring set unless ``ring_noise``), base, SJ."""
    rng = np.random.default_rng(seed)
    duvw = torch.from_numpy((0.1 * rng.standard_normal((3,) + SHAPE))
                            .astype(np.float32))
    if not ring_noise:
        spk.set_boundary_3d(duvw)
    base = torch.from_numpy((0.5 * rng.random((3,) + SHAPE))
                            .astype(np.float32))
    sj = (0.1 * rng.random((9,) + SHAPE)).astype(np.float32)
    sj[:3] += 0.5
    return duvw, base, torch.from_numpy(sj)


@pytest.mark.parametrize("a_smooth", [0.5, 0.75])
def test_psi_field_matches_jax(a_smooth):
    duvw, base, _ = _fields()
    hz, hy, hx = H
    got = spk.psi_field(duvw, base, *spk.psi_params(a_smooth, hx, hy, hz))
    want = np.asarray(jsolver._psi_smooth_field(
        *(jnp.asarray(f.numpy()) for f in (base[0], duvw[0], base[1],
                                           duvw[1], base[2], duvw[2])),
        jnp.float32(a_smooth), jnp.float32(hx), jnp.float32(hy),
        jnp.float32(hz)))
    assert got.shape == SHAPE
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=0)


def test_clamped_reads_equal_reads_after_set_boundary():
    """The kernels read the increments at per-axis clamped indices and never
    their ring; that equals set_boundary_3d, and the ring's contents do not
    reach psi or the sweep."""
    duvw, base, sj = _fields(1, ring_noise=True)
    P, M, N = SHAPE
    zi, yi, xi = (np.clip(np.arange(n), 1, n - 2) for n in (P, M, N))
    gathered = duvw.numpy()[:, zi][:, :, yi][:, :, :, xi]
    ringed = spk.set_boundary_3d(duvw.clone())
    np.testing.assert_array_equal(gathered, ringed.numpy())

    params = spk.psi_params(0.5, *H[::-1])
    psi_noise = spk.psi_field(duvw, base, *params)
    assert torch.equal(psi_noise, spk.psi_field(ringed, base, *params))
    a, b = duvw.clone(), ringed.clone()
    for parity in (0, 1):
        spk.halfsweep_psi(a, base, sj, psi_noise, *ALPHA, parity)
        spk.halfsweep_psi(b, base, sj, psi_noise, *ALPHA, parity)
    assert torch.equal(a[:, 1:-1, 1:-1, 1:-1], b[:, 1:-1, 1:-1, 1:-1])
    assert torch.equal(a[:, 0], duvw[:, 0])        # the ring is never written


@pytest.mark.parametrize("a_smooth,iterations,lag", [
    (0.5, 1, 1), (0.75, 1, 1), (0.5, 5, 5)])
def test_iteration_and_block_match_xla(a_smooth, iterations, lag):
    """One psi -> red -> black iteration, and one update_lag block, through
    compute_flow_level_cl against _solve(use_pallas=False)."""
    args = (*_inputs(SHAPE, seed=2), ALPHA, [0.45], a_smooth, H,
            iterations, lag)
    for got, want in zip(_port(*args), _jax(*args)):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("a_smooth", [0.5, 0.75])
def test_whole_level_matches_xla(a_smooth):
    args = (*_inputs(SHAPE, seed=3), ALPHA, [0.45], a_smooth, H, 20, 5)
    for got, want in zip(_port(*args), _jax(*args)):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_const_halfsweep_matches_redblack_oracle():
    """Red then black constant-weight half-sweep from zero increments == one
    iteration of the numpy red-black oracle with a_smooth = a_data = 1."""
    J, weight, u, v, w = _inputs(SHAPE, seed=4)
    J_last = [np.moveaxis(J[i], 0, -1).astype(np.float64) for i in range(10)]
    hz, hy, hx = H
    want = sor_redblack_oracle(J_last, np.moveaxis(weight, 0, -1), u, v, w,
                               ALPHA, iterations=1, update_lag=1,
                               a_data=[1.0], a_smooth=1.0, hx=hx, hy=hy,
                               hz=hz)
    t = np.float32
    ax, ay, az = (float(t(a) / (t(h) * t(h))) for a, h in zip(ALPHA, H[::-1]))
    sj = torch.from_numpy(np.stack([(weight * J[i]).sum(0)
                                    for i in (0, 1, 2, 4, 5, 6, 7, 8, 9)]))
    base = torch.from_numpy(np.stack([u, v, w]))
    duvw = torch.zeros_like(base)
    for parity in (0, 1):
        spk.halfsweep(duvw, base, sj, ax, ay, az, parity)
    spk.set_boundary_3d(duvw)
    for k in range(3):
        np.testing.assert_allclose(duvw[k].numpy(), want[k], rtol=2e-5,
                                   atol=2e-5)


def test_plain_path_counts_no_launch_and_matches_wrappers():
    """On CPU tensors the wrappers are their plain versions: the same
    numbers as use_kernels=False, and no launch counted."""
    J, weight, u, v, w = _inputs(SHAPE, seed=5)
    args = (J, weight, u, v, w, ALPHA, [0.45], 0.5, H, 10, 5)
    before = (spk.psi_field.launches, spk.halfsweep_psi.launches,
              spk.halfsweep.launches, spk.sor_iterations_psi.launches)
    for a, b in zip(_port(*args, use_kernels=True),
                    _port(*args, use_kernels=False)):
        np.testing.assert_array_equal(a, b)
    assert (spk.psi_field.launches, spk.halfsweep_psi.launches,
            spk.halfsweep.launches,
            spk.sor_iterations_psi.launches) == before


ODD = (7, 11, 13)


def _tick_fields(seed):
    """Increments with a noisy ring, base and SJ on the odd grid ODD."""
    rng = np.random.default_rng(seed)
    duvw = (0.1 * rng.standard_normal((3,) + ODD)).astype(np.float32)
    base = (0.5 * rng.random((3,) + ODD)).astype(np.float32)
    sj = (0.1 * rng.random((9,) + ODD)).astype(np.float32)
    sj[:3] += 0.5
    return duvw, base, sj


def _tick_params(a_smooth):
    """psi_params + (ax, ay, az) as compute_flow_level_cl rounds them."""
    t = np.float32
    hz, hy, hx = H
    return spk.psi_params(a_smooth, hx, hy, hz) + tuple(
        float(t(a) / (t(h) * t(h))) for a, h in zip(ALPHA, (hx, hy, hz)))


@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_tick_block_matches_jax_xla(n_iters):
    """One tick block of the kernel's plain version (the loop of psi field,
    red and black half-sweeps) from zero increments against the XLA
    iterations of JAX's _solve over one tick block: with one channel,
    weight 1 and a_data 1 its tick_update returns J itself, so J carries
    SJ (J44 unused)."""
    _, base, sj = _tick_fields(8)
    Jc = np.zeros((10, 1) + ODD, np.float32)
    Jc[[0, 1, 2, 4, 5, 6, 7, 8, 9], 0] = sj
    hz, hy, hx = H
    want = _solve(jnp.asarray(Jc), jnp.ones((1,) + ODD, jnp.float32),
                  *(jnp.asarray(b) for b in base),
                  jnp.asarray(ALPHA, jnp.float32),
                  jnp.asarray([1.0], jnp.float32), jnp.float32(0.5),
                  jnp.float32(hx), jnp.float32(hy), jnp.float32(hz),
                  n_iters, n_iters, False, False)
    got = spk.sor_iterations_psi(torch.zeros((3,) + ODD),
                                 torch.from_numpy(base),
                                 torch.from_numpy(sj), _tick_params(0.5),
                                 n_iters)
    spk.set_boundary_3d(got)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=2e-5,
                               atol=2e-5)


def test_tick_block_cpu_path_is_plain_and_makes_no_launch():
    """On CPU tensors sor_iterations_psi is its plain loop, for odd and
    even counts, leaves the ring alone and counts no launch; so does the
    level solver."""
    duvw, base, sj = (torch.from_numpy(f) for f in _tick_fields(9))
    params = _tick_params(0.5)
    before = spk.sor_iterations_psi.launches
    for n_iters in (1, 2, 3):
        got = spk.sor_iterations_psi(duvw.clone(), base, sj, params, n_iters,
                                     torch.empty_like(duvw))
        want = spk.sor_iterations_psi_plain(duvw.clone(), base, sj, params,
                                            n_iters)
        assert torch.equal(got, want)
        assert torch.equal(got[:, 0], duvw[:, 0])
        assert torch.equal(got[:, :, :, -1], duvw[:, :, :, -1])
    J, weight, u, v, w = _inputs(SHAPE, seed=10)
    _port(J, weight, u, v, w, ALPHA, [0.45], 0.5, H, 4, 2)
    assert spk.sor_iterations_psi.launches == before


def test_solver_has_no_unported_branch():
    """a_smooth != 1 on the kernel path goes through the psi sweep."""
    import inspect

    assert "NotImplementedError" not in inspect.getsource(tsolver)


@pytest.mark.slow
def test_halfsweeps_match_pallas_interpret():
    """One psi half-sweep and one constant-weight half-sweep against the
    Pallas kernels they replace, in interpret mode."""
    from flowreg3d_tpu.core.solver_pallas import (halfsweep_pallas,
                                                  halfsweep_pallas_psi)

    duvw, base, sj = _fields(6)
    psi = spk.psi_field(duvw, base, *spk.psi_params(0.5, *H[::-1]))
    j = [jnp.asarray(f.numpy()) for f in (*duvw, *base)]
    sj_j = tuple(jnp.asarray(f.numpy()) for f in sj)
    params = jnp.asarray(ALPHA, jnp.float32)
    for parity in (0, 1):
        want = halfsweep_pallas_psi(*j, jnp.asarray(psi.numpy()), sj_j,
                                    params, parity, interpret=True)
        got = spk.halfsweep_psi(duvw.clone(), base, sj, psi, *ALPHA, parity)
        np.testing.assert_allclose(got[:, 1:-1, 1:-1, 1:-1].numpy(),
                                   np.stack(want)[:, 1:-1, 1:-1, 1:-1],
                                   rtol=2e-5, atol=2e-5)
        want = halfsweep_pallas(*j, sj_j, params, parity, interpret=True)
        got = spk.halfsweep(duvw.clone(), base, sj, *ALPHA, parity)
        np.testing.assert_allclose(got[:, 1:-1, 1:-1, 1:-1].numpy(),
                                   np.stack(want)[:, 1:-1, 1:-1, 1:-1],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.slow
@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_tick_block_matches_pallas_interpret(n_iters):
    """One tick block of the kernel's plain version against the Pallas
    tick block it replaces, sweep_iterations_pallas_psi, in interpret mode,
    from non-zero increments on the odd grid."""
    from flowreg3d_tpu.core.solver_pallas import sweep_iterations_pallas_psi

    duvw, base, sj = _tick_fields(11)
    params = _tick_params(0.5)
    hz, hy, hx = H
    pallas_params = jnp.asarray(params[5:] + (0.5,) + params[2:5],
                                jnp.float32)
    want = sweep_iterations_pallas_psi(
        *(jnp.asarray(f) for f in (*duvw, *base)),
        tuple(jnp.asarray(f) for f in sj), pallas_params, n_iters,
        interpret=True)
    got = spk.sor_iterations_psi(torch.from_numpy(duvw),
                                 torch.from_numpy(base),
                                 torch.from_numpy(sj), params, n_iters)
    np.testing.assert_allclose(got[:, 1:-1, 1:-1, 1:-1].numpy(),
                               np.stack(want)[:, 1:-1, 1:-1, 1:-1],
                               rtol=2e-5, atol=2e-5)
