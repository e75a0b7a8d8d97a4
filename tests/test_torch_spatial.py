"""Port parity: the Z-sharded solver and pyramid
(``flowreg3d_tpu_torch.parallel.spatial`` / ``spatial_pyramid``) against
the JAX package, on the CPU, with a list of CPU "devices" (``[cpu] * n``:
each entry a shard of its own, one process).

- The collectives against numpy: the halo exchange in its three modes on an
  uneven split (shard padding past the volume) against ``np.pad``; the ring
  matmul (also with overlapping output windows) and the replicated sum
  against ``M @ x``: exact to 1e-6 (float32 products of <= 12 terms).
- The slab kernels' plain versions against JAX ``_local_halfsweep`` and
  ``_psi_sharded``, run on the same shard blocks under ``jax.vmap`` with
  the mesh axis named (its ``ppermute`` is the psi exchange): the
  half-sweeps at 2e-6, psi at rtol 1e-5 (the two sum the gradient terms in
  another order); the whole-volume slab (0, 1, P-2) is the default.
- ``compute_flow_level_sharded`` over four shards against JAX
  ``compute_flow_level(use_pallas=False)`` for both a_smooth values, at
  JAX's bound for its sharded solver, 5e-4 (tests/parallel/test_spatial.py),
  and bit-identical to the one-slab solve.
- ``get_displacement_sharded`` over four shards on JAX's (42,24,24) pair and
  parameters (tests/parallel/test_spatial_pyramid.py) against JAX's
  single-device ``get_displacement``, at JAX's bounds: mean |diff| < 2e-4,
  max 6e-3; a_smooth 1, and 0.5 with a varying weight volume.
- The halo-violation flag, and the spatial executor recomputing such a
  frame on one device (counted in ``get_info``), bit-equal to the
  sequential executor there; the spatial pipeline against the sequential
  one.
- The bodies the CUDA graphs capture (the sharded pyramid and frame, the
  sharded level solve, ``compute_flow_level``, ``compute_flow``), warm: no
  upload and no host read, the first call's bits; the entry points give the
  bodies' bits, and a missing weight or initial flow that of 1/C or zeros.
- Slow tier: the port's sharded pyramid against JAX's
  ``get_displacement_sharded`` on the virtual 4-device mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from flowreg3d_tpu.core.pyramid import get_displacement as jax_gd
from flowreg3d_tpu.core.solver import compute_flow_level as jax_level
from flowreg3d_tpu.parallel import spatial as jsp

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.core import solver_psi_kernel as spk
from flowreg3d_tpu_torch.parallel import spatial as tsp
from flowreg3d_tpu_torch.parallel import spatial_pyramid as tpyr
from flowreg3d_tpu_torch.parallel.executors import (SequentialExecutor3D,
                                                    SpatialExecutor3D)
from flowreg3d_tpu_torch.pipeline import RegistrationConfig, compensate_arr

from tests.pipeline.conftest import (base_volume, fast_options,  # noqa: F401
                                     video5d)

torch.set_num_threads(1)
CPU = torch.device("cpu")

# JAX's sharded-pyramid case (tests/parallel/test_spatial_pyramid.py)
PARAMS = dict(alpha=(1.5, 1.5, 1.5), update_lag=3, iterations=6,
              min_level=0, levels=2, eta=0.8, a_data=0.45,
              const_assumption="gc")
SHAPE = (42, 24, 24)


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    blobs = np.zeros(shape, np.float32)
    n = 600
    idx = tuple(rng.integers(2, s - 2, n) for s in shape)
    blobs[idx] = rng.random(n).astype(np.float32) + 0.5
    fixed = gaussian_filter(blobs, (1.0, 1.5, 1.5)).astype(np.float32)
    fixed /= fixed.max()
    return fixed, np.roll(fixed, (1, 2, -2), axis=(0, 1, 2))


def _slabs(x, pz, n):
    return [torch.from_numpy(x[k * pz:(k + 1) * pz].copy())
            for k in range(n)]


@pytest.mark.parametrize("mode", ["symmetric", "reflect", "edge"])
@pytest.mark.parametrize("H", [2, 4])
def test_halo_exchange_matches_np_pad(mode, H):
    rng = np.random.default_rng(1)
    Z, n, pz = 13, 3, 5                  # 2 rows of shard padding
    x = rng.standard_normal((Z, 4, 3)).astype(np.float32)
    xp = np.concatenate([x, np.repeat(x[-1:], pz * n - Z, 0)])
    want = np.pad(x, ((H, pz * n + H - Z), (0, 0), (0, 0)), mode=mode)
    rows = [tpyr._mirror_rows(k, pz, H, mode, Z, CPU) for k in range(n)]
    got = tpyr._halo_exchange(_slabs(xp, pz, n), H, rows)
    for k, g in enumerate(got):
        rows = slice(k * pz, k * pz + pz + 2 * H)
        np.testing.assert_array_equal(g.numpy(), want[rows])


@pytest.mark.parametrize("n,stride", [(3, None), (4, None), (3, 2)])
def test_ring_matmul_and_replicated_sum_match_dense(n, stride):
    rng = np.random.default_rng(2)
    rows, out_rows = 4, (5 if stride is None else 7)
    step = out_rows if stride is None else stride
    M = rng.standard_normal((step * (n - 1) + out_rows, n * rows))
    x = rng.standard_normal((n * rows, 3, 2)).astype(np.float32)
    want = np.einsum("oi,i...->o...", M.astype(np.float32), x)
    spec = {CPU: torch.from_numpy(M.astype(np.float32))}   # on each device
    got = tpyr._ring_matmul_z(_slabs(x, rows, n), spec, rows, out_rows,
                              stride)
    for k, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), want[k * step:k * step
                                                   + out_rows], atol=1e-5)
    full = tpyr._replicated_from_sharded(_slabs(x, rows, n), spec, rows,
                                         CPU)
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5)


def _blocks(f, pz, n):
    """JAX compute_flow_level_sharded's blocks of a ringed (p, ...) array:
    rows [k*pz, k*pz + pz + 2) after an edge pad of the bottom."""
    pad = pz * n - (f.shape[0] - 2)
    fp = np.concatenate([f, np.repeat(f[-1:], pad, 0)])
    return np.stack([fp[k * pz:k * pz + pz + 2] for k in range(n)])


def _yx_ring(f):
    f = f.copy()
    f[..., 0, :] = f[..., 1, :]
    f[..., -1, :] = f[..., -2, :]
    f[..., :, 0] = f[..., :, 1]
    f[..., :, -1] = f[..., :, -2]
    return f


@pytest.mark.parametrize("n,p_int", [(3, 10), (2, 12)])
def test_slab_sweeps_and_psi_match_jax(n, p_int):
    """Shard blocks of one ringed volume (increments with their y/x ring
    set and ghost rows from the neighbours, as JAX keeps them); rows past
    p_int are shard padding."""
    rng = np.random.default_rng(3)
    m, nx = 9, 11
    pz = -(-p_int // n)
    shape = (p_int + 2, m, nx)
    inc = _yx_ring(0.1 * rng.standard_normal((3,) + shape)
                   .astype(np.float32))
    base = (2.0 * rng.random((3,) + shape)).astype(np.float32)
    sj = (0.1 * rng.random((9,) + shape)).astype(np.float32)
    sj[:3] += 0.5
    psi = (0.5 + rng.random(shape)).astype(np.float32)
    inc_b, base_b, sj_b = (np.stack([_blocks(c, pz, n) for c in f], 1)
                           for f in (inc, base, sj))
    psi_b = _blocks(psi, pz, n)
    z_offs = np.arange(n) * pz
    ax, ay, az = 0.7, 0.9, 1.3
    a_s, hx, hy, hz = 0.5, 1.0, 1.25, 1.5

    def jax_sweep(phase, z_off, d, b, s, ps):
        return jnp.stack(jsp._local_halfsweep(
            phase, z_off, p_int, *d, *b, tuple(s), ax, ay, az, ps))

    def jax_psi(z_off, d, b):
        return jsp._psi_sharded(*d, *b, a_s, hx, hy, hz, "z", z_off, p_int)

    for phase in (0, 1):
        for use_psi in (False, True):
            want = jax.vmap(
                lambda z, d, b, s, ps: jax_sweep(phase, z, d, b, s,
                                                 ps if use_psi else None),
                axis_name="z")(z_offs, inc_b, base_b, sj_b, psi_b)
            for k in range(n):
                slab = (int(z_offs[k]), 1 if k == 0 else 0,
                        p_int - int(z_offs[k]))
                d = torch.from_numpy(inc_b[k].copy())
                args = [torch.from_numpy(a[k].copy())
                        for a in (base_b, sj_b)]
                if use_psi:
                    spk.halfsweep_psi_plain(d, *args,
                                            torch.from_numpy(psi_b[k]), ax,
                                            ay, az, phase, slab)
                else:
                    spk.halfsweep_plain(d, *args, ax, ay, az, phase, slab)
                real = slice(1, 1 + min(pz, p_int - int(z_offs[k])))
                np.testing.assert_allclose(
                    d.numpy()[:, real, 1:-1, 1:-1],
                    np.asarray(want[k])[:, real, 1:-1, 1:-1], atol=2e-6)

    want = jax.vmap(jax_psi, axis_name="z")(z_offs, inc_b, base_b)
    params = spk.psi_params(a_s, hx, hy, hz)
    got = [spk.psi_field_plain(torch.from_numpy(inc_b[k].copy()),
                               torch.from_numpy(base_b[k].copy()), *params,
                               slab=(int(z), 1 if k == 0 else 0,
                                     p_int - int(z)))
           for k, z in enumerate(z_offs)]
    tsp.exchange_psi(got, [int(z) for z in z_offs], p_int)
    for k, z in enumerate(z_offs):
        keep = slice(0, min(pz + 2, p_int + 2 - int(z)))
        np.testing.assert_allclose(got[k].numpy()[keep],
                                   np.asarray(want[k])[keep], rtol=1e-5)
    # the whole volume is the slab (0, 1, P-2)
    P = shape[0]
    full = [torch.from_numpy(a.copy()) for a in (inc, base, sj)]
    for slab in (None, (0, 1, P - 2)):
        a = full[0].clone()
        spk.halfsweep_plain(a, full[1], full[2], ax, ay, az, 1, slab)
        if slab is None:
            ref = a
        assert torch.equal(a, ref)
    assert torch.equal(spk.psi_field_plain(full[0], full[1], *params),
                       spk.psi_field_plain(full[0], full[1], *params,
                                           slab=(0, 1, P - 2)))


def _level_problem(shape, C=1, seed=0):
    """JAX tests/parallel/test_spatial.py's problem."""
    rng = np.random.default_rng(seed)
    p, m, n = shape
    gx, gy, gz = (rng.standard_normal((p, m, n, C)).astype(np.float32) * 0.3
                  for _ in range(3))
    gt = rng.standard_normal((p, m, n, C)).astype(np.float32) * 0.1
    J = (gx * gx, gy * gy, gz * gz, gt * gt, gx * gy, gx * gz, gy * gz,
         gx * gt, gy * gt, gz * gt)
    weight = np.ones((p, m, n, C), np.float32)
    u, v, w = (rng.standard_normal((p, m, n)).astype(np.float32) * 0.1
               for _ in range(3))
    return J, weight, u, v, w


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
@pytest.mark.parametrize("n,shape", [(4, (17, 16, 20)), (3, (26, 12, 14))])
def test_level_sharded_matches_jax_single_device(a_smooth, n, shape):
    J, weight, u, v, w = _level_problem(shape)
    kw = dict(alpha=(1.2, 1.0, 0.8), iterations=8, update_lag=3,
              a_data=np.array([0.45]), hx=1.0, hy=1.0, hz=1.0)
    ref = jax_level([jnp.asarray(j) for j in J], jnp.asarray(weight),
                    jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
                    a_smooth=a_smooth, use_pallas=False, **kw)
    got = tsp.compute_flow_level_sharded(
        [torch.from_numpy(j) for j in J], torch.from_numpy(weight),
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(w),
        devices=[CPU] * n, a_smooth=a_smooth, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4,
                                   atol=5e-4)
    # the exchange only moves values: one slab gives the same bits
    one = tsp.compute_flow_level_sharded(
        [torch.from_numpy(j) for j in J], torch.from_numpy(weight),
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(w),
        devices=[CPU], a_smooth=a_smooth, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_sharded_pyramid_matches_jax_single_device(a_smooth):
    """JAX's two sharded-pyramid cases: a_smooth 1 on the seed-0 pair, and
    a_smooth 0.5 with a spatially varying weight on the seed-3 pair."""
    weight = None
    if a_smooth == 1.0:
        fixed, moving = _pair(SHAPE)
    else:
        fixed, moving = _pair(SHAPE, seed=3)
        weight = (0.5 + np.random.default_rng(7).random(SHAPE + (1,))
                  ).astype(np.float32)
    ref = np.asarray(jax_gd(fixed, moving, a_smooth=a_smooth, weight=weight,
                            **PARAMS))
    flow, valid = tpyr.get_displacement_sharded(
        fixed, moving, devices=[CPU] * 4, a_smooth=a_smooth, weight=weight,
        **PARAMS)
    assert bool(valid) and flow.shape == SHAPE + (3,)
    diff = np.abs(flow.numpy() - ref)
    assert diff.mean() < 2e-4, diff.mean()
    np.testing.assert_allclose(flow.numpy(), ref, rtol=6e-3, atol=6e-3)


def test_halo_violation_flagged_and_recomputed(video5d, base_volume):
    fixed, moving = _pair(SHAPE, seed=1)
    big = np.zeros(SHAPE + (3,), np.float32)
    big[..., 2] = 14.0       # z-displacement far beyond the default halo
    _, valid = tpyr.get_displacement_sharded(
        fixed, moving, devices=[CPU] * 4, uvw=big, **PARAMS)
    assert not bool(valid)

    # the executor: a frame whose warp leaves the halo is solved on one
    # device, bit-equal to the sequential executor
    fp = fast_options(a_smooth=0.5).to_dict()
    w_init = np.zeros(base_volume.shape[:3] + (3,), np.float32)
    w_init[..., 2] = 9.0
    ex = SpatialExecutor3D(device="cpu", devices=[CPU] * 2, halo_w=2)
    got = ex.process_batch(video5d[:2], video5d[:2], base_volume,
                           base_volume, w_init, flow_params=fp)
    want = SequentialExecutor3D(device="cpu").process_batch(
        video5d[:2], video5d[:2], base_volume, base_volume, w_init,
        flow_params=fp)
    assert ex.get_info()["single_device_frames"] == 2
    assert ex.get_info()["sharding"] == "z-spatial"
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_spatial_pipeline_matches_sequential(video5d, base_volume):
    """compensate_arr through the spatial executor over two shards: the
    fixture's finest level (z = 10) is sharded, the coarser replicated; at
    a_smooth 0.5 within the pipeline's parity bounds of the sequential
    executor (registered 1e-4, flows 1e-3)."""
    opts = options_from_jax(fast_options(a_smooth=0.5))
    reg, w = compensate_arr(
        video5d, base_volume, options=opts, device="cpu",
        config=RegistrationConfig(parallelization="spatial",
                                  devices=["cpu"] * 2))
    reg_s, w_s = compensate_arr(
        video5d, base_volume, options=opts, device="cpu",
        config=RegistrationConfig(parallelization="sequential"))
    np.testing.assert_allclose(reg, reg_s, rtol=0, atol=1e-4)
    np.testing.assert_allclose(w, w_s, rtol=0, atol=1e-3)


@pytest.mark.slow
def test_sharded_pyramid_matches_jax_sharded():
    """The port's sharded pyramid against JAX's on the virtual 4-device
    mesh (tests/conftest.py): the same inputs, the same static plan. In the
    slow tier with JAX's own sharded-pyramid tests (about 15 s here)."""
    from flowreg3d_tpu.parallel.spatial_pyramid import \
        get_displacement_sharded as jax_sharded

    fixed, moving = _pair(SHAPE)
    mesh = jsp.spatial_mesh(jax.devices()[:4])
    want, valid_j = jax_sharded(fixed, moving, mesh=mesh, **PARAMS)
    got, valid = tpyr.get_displacement_sharded(fixed, moving,
                                               devices=[CPU] * 4, **PARAMS)
    assert bool(valid) and bool(valid_j)
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.mean() < 2e-4, diff.mean()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=6e-3,
                               atol=6e-3)


# -- the compiled programs' bodies: capturable --------------------------------

def _no_host_traffic(monkeypatch):
    """Refuse every host-to-tensor copy and every read of a tensor's value
    on the host (what a CUDA-graph capture refuses) until ``undo``."""
    def refuse(*args, **kwargs):
        raise AssertionError("host traffic inside a warm body")

    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("item", "__bool__", "tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def _key(shape, C, a_smooth, **over):
    from flowreg3d_tpu_torch.core.pyramid import pyramid_config_key

    kw = dict(PARAMS, a_smooth=a_smooth, **over)
    return pyramid_config_key(shape, C, **kw)


def _sharded_inputs(C, seed=5, shape=(18, 16, 20)):
    rng = np.random.default_rng(seed)
    fixed = gaussian_filter(rng.random(shape + (C,)), (1, 1.5, 1.5, 0))
    moving = np.roll(fixed, (1, 2, -1), axis=(0, 1, 2))
    uvw = 0.3 * rng.standard_normal(shape + (3,))
    weight = 0.5 + rng.random(shape + (C,))
    return shape, [torch.from_numpy(a.astype(np.float32))
                   for a in (fixed, moving, uvw, weight)]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
@pytest.mark.parametrize("C", [1, 2])
def test_warm_sharded_pyramid_uploads_nothing(monkeypatch, n, a_smooth, C):
    """The sharded pyramid's body (what its CUDA graph captures), warm:
    no upload, no host read, the first call's bits; with a weight volume
    and with a weight vector."""
    shape, (fixed, moving, uvw, weight) = _sharded_inputs(C)
    pyramid = tpyr.build_sharded_pyramid(_key(shape, C, a_smooth),
                                         [CPU] * n)
    vec = torch.linspace(0.4, 0.6, C)
    first = [pyramid(fixed, moving, uvw, w) for w in (weight, vec)]
    _no_host_traffic(monkeypatch)
    again = [pyramid(fixed, moving, uvw, w) for w in (weight, vec)]
    monkeypatch.undo()
    for (f0, v0), (f1, v1) in zip(first, again):
        assert torch.equal(f0, f1) and torch.equal(v0, v1)
        assert f0.shape == shape + (3,) and bool(v0)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
@pytest.mark.parametrize("C", [1, 2])
def test_warm_sharded_level_uploads_nothing(monkeypatch, n, a_smooth, C):
    J, weight, u, v, w = (
        [torch.from_numpy(x) for x in a] if isinstance(a, tuple)
        else torch.from_numpy(a) for a in _level_problem((11, 9, 10), C))
    key = tsp.level_config_key((11, 9, 10), C, (1.2, 1.0, 0.8), 5, 2,
                               [0.45], a_smooth, 1.0, 1.1, 1.2,
                               torch.float32, True)
    level = tsp.build_level_sharded(key, [CPU] * n)
    first = level(J, weight, u, v, w)
    _no_host_traffic(monkeypatch)
    again = level(J, weight, u, v, w)
    monkeypatch.undo()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    # the public entry runs the same body
    got = tsp.compute_flow_level_sharded(
        J, weight, u, v, w, (1.2, 1.0, 0.8), 5, 2, np.array([0.45]), 1.0,
        1.1, 1.2, devices=[CPU] * n, a_smooth=a_smooth)
    assert all(torch.equal(a, b) for a, b in zip(first, got))


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
@pytest.mark.parametrize("C", [1, 2])
def test_warm_level_and_2d_solvers_upload_nothing(monkeypatch, a_smooth, C):
    """The bodies the CUDA graphs capture (compute_flow_level's and
    compute_flow's), warm: no upload, no host read, the bits of the public
    entry points on the CPU."""
    from flowreg3d_tpu_torch.core.solver import (compute_flow_level_cl,
                                                 level_solver)
    from flowreg3d_tpu_torch.core.solver2d import (compute_flow,
                                                   flow2d_solver)

    J, weight, u, v, w = (
        [torch.from_numpy(x).movedim(-1, 0) for x in a]
        if isinstance(a, tuple) else torch.from_numpy(a)
        for a in _level_problem((9, 10, 11), C))
    weight = weight.movedim(-1, 0)
    args = ((1.5, 1.2, 1.0), 5, 2)
    tail = (a_smooth, 1.1, 1.2, 1.3)
    want = compute_flow_level_cl(J, weight, u, v, w, *args, [0.45], *tail)
    solve = level_solver(u.shape, C, *args, [0.45], *tail, torch.float32,
                         CPU)
    Jc = torch.stack(J)
    rng = np.random.default_rng(4)
    J2 = [rng.random((12, 13, C)).astype(np.float32) for _ in range(6)]
    w2 = np.ones((12, 13, C), np.float32)
    u2 = np.zeros((12, 13), np.float32)
    kw2 = dict(alpha=(0.5, 0.5), iterations=6, update_lag=2, a_data=0.45,
               a_smooth=a_smooth)
    want2 = compute_flow(J2, w2, u2, u2, device="cpu", **kw2)
    solve2 = flow2d_solver((12, 13), C, (0.5, 0.5), 6, 2, 0.45, a_smooth,
                           1.0, 1.0, torch.float32, CPU)
    Jt, w2t, u2t = (torch.from_numpy(np.stack(J2)), torch.from_numpy(w2),
                    torch.from_numpy(u2))
    solve(Jc, weight, u, v, w)
    solve2(Jt, w2t, u2t, u2t)
    _no_host_traffic(monkeypatch)
    got = solve(Jc, weight, u, v, w)
    got2 = solve2(Jt, w2t, u2t, u2t)
    monkeypatch.undo()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got2, want2))


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_sharded_split_keeps_the_entry_points_bits(a_smooth):
    """The builder/body split against the entry point it serves:
    ``get_displacement_sharded`` gives the body's bits; its weight None
    (1/C) gives the bits of the same weights as a vector and as a volume
    (the volume sharded as before the split), and ``uvw=None`` those of
    zeros; the spatial executor's frame is the body's flow and the warp of
    the raw frame by it."""
    from flowreg3d_tpu_torch.ops.warp import warp

    C = 2
    shape, (fixed, moving, uvw, weight) = _sharded_inputs(C, seed=6)
    devices = [CPU] * 3
    key = _key(shape, C, a_smooth, a_data=(0.45, 0.45))
    body = tpyr.build_sharded_pyramid(key, devices)
    kw = dict(PARAMS, a_smooth=a_smooth, devices=devices)
    flow, valid = tpyr.get_displacement_sharded(fixed, moving, uvw=uvw,
                                                weight=weight, **kw)
    want, ok = body(fixed, moving, uvw, weight)
    assert torch.equal(flow, want) and bool(valid) and bool(ok)
    zeros = torch.zeros_like(uvw)
    half = torch.full((C,), 0.5)
    runs = [tpyr.get_displacement_sharded(fixed, moving, **kw)[0],
            tpyr.get_displacement_sharded(fixed, moving, uvw=zeros,
                                          weight=half, **kw)[0],
            tpyr.get_displacement_sharded(
                fixed.numpy(), moving.numpy(), uvw=zeros.numpy(),
                weight=np.full(shape + (C,), 0.5, np.float32), **kw)[0],
            body(fixed, moving, zeros, half)[0]]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])

    ex = SpatialExecutor3D(device="cpu", devices=devices)
    raw = fixed.flip(0)
    inputs = (fixed, fixed, weight, raw, moving, uvw)
    flow_out, valid, reg_out = ex._frame_fn(key, 3, inputs)(*inputs)
    assert bool(valid)
    want, _ = body(fixed, moving, uvw, weight)
    assert torch.equal(flow_out, want)
    assert torch.equal(reg_out, warp(raw, want[..., 0], want[..., 1],
                                     want[..., 2], fixed, 3, True))

