"""Port parity: the executors (``flowreg3d_tpu_torch.parallel``) against the
JAX package's, and the pyramid's capture safety.

- ``get_executor(None)`` gives the batched executor without several cards
  (over a device list when one is given); the reference's aliases
  resolve, 'multiprocessing3d' to 'mesh'; 'mesh' and 'spatial' resolve.
- ``BatchedExecutor3D`` equals ``SequentialExecutor3D`` bit for bit, for
  one and two channels, on batches of one and of four frames, and reports
  progress per frame.
- The batched executor against the JAX ``BatchedExecutor3D`` on the
  pipeline fixture at a_smooth 0.5: registered within 1e-4, flows within
  1e-3 (the bounds of tests/test_torch_pipeline.py).
- ``pad_to_multiple`` equals the JAX one.
- Capture safety: ``build_pyramid`` uploads the data exponents once, so a
  warm pyramid call copies nothing from the host (checked by making every
  host-to-tensor constructor raise) and gives the same bits as a level
  that uploads them itself, as every level did before.
- The CUDA-graph path itself runs only on a card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from flowreg3d_tpu.parallel.executors import \
    BatchedExecutor3D as JaxBatchedExecutor
from flowreg3d_tpu.parallel.mesh import pad_to_multiple as jax_pad

from flowreg3d_tpu_torch.core import pyramid as tpyr
from flowreg3d_tpu_torch.core.solver import compute_flow_level_cl
from flowreg3d_tpu_torch.parallel import executors as tex
from flowreg3d_tpu_torch.parallel.mesh import pad_to_multiple

from tests.pipeline.conftest import (base_volume, fast_options,  # noqa: F401
                                     video5d)

torch.set_num_threads(1)


def _case(video5d, base_volume, C):
    """(batch raw, batch preprocessed, reference raw, reference
    preprocessed, flow params) of the pipeline fixture, C channels."""
    ref = base_volume
    if C == 2:
        ref = np.concatenate([base_volume, np.sqrt(base_volume)], axis=-1)
    video = np.stack([np.roll(ref, (0, s, -s, 0), axis=(0, 1, 2, 3))
                      for s in range(video5d.shape[0])])
    smooth = (0, 1.0, 1.0, 1.0, 0)
    proc = gaussian_filter(video, smooth).astype(np.float32)
    ref_proc = gaussian_filter(ref, smooth[1:]).astype(np.float32)
    fp = fast_options(a_smooth=0.5, weight=[1.0 / C] * C).to_dict()
    return video, proc, ref, ref_proc, fp


def test_get_executor_auto_and_aliases():
    assert isinstance(tex.get_executor(device="cpu"), tex.BatchedExecutor3D)
    assert tex.get_executor("threading3d", device="cpu").name == "batched"
    assert tex.get_executor("sequential3d", device="cpu").name == "sequential"
    for name, cls in (("mesh", tex.MeshExecutor3D),
                      ("multiprocessing3d", tex.MeshExecutor3D),
                      ("spatial", tex.SpatialExecutor3D)):
        ex = tex.get_executor(name, device="cpu")
        assert isinstance(ex, cls) and ex.devices == [torch.device("cpu")]
    ex = tex.get_executor(device="cpu", devices=["cpu"] * 2)
    assert ex.name == "batched" and ex.devices == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="Unknown executor"):
        tex.get_executor("gpu9", device="cpu")


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("C", [1, 2])
def test_batched_equals_sequential_bitwise(video5d, base_volume, C, T):
    video, proc, ref, ref_proc, fp = _case(video5d, base_volume, C)
    video, proc = video[:T], proc[:T]
    w_init = np.full(ref.shape[:3] + (3,), 0.25, np.float32)
    out, seen = {}, {}
    for ex in (tex.SequentialExecutor3D(device="cpu"),
               tex.BatchedExecutor3D(device="cpu")):
        seen[ex.name] = []
        out[ex.name] = ex.process_batch(
            video, proc, ref, ref_proc, w_init, interpolation_method="cubic",
            progress_callback=seen[ex.name].append, flow_params=fp)
    for a, b in zip(out["sequential"], out["batched"]):
        assert a.shape == b.shape and a.shape[0] == T
        assert torch.equal(a, b)
    assert seen["sequential"] == seen["batched"] == [1] * T


def test_batched_matches_jax_batched(video5d, base_volume):
    video, proc, ref, ref_proc, fp = _case(video5d, base_volume, 1)
    w_init = np.zeros(ref.shape[:3] + (3,), np.float32)
    reg_j, flow_j = JaxBatchedExecutor(chunk=3).process_batch(
        video, proc, ref, ref_proc, w_init, interpolation_method="cubic",
        flow_params=fp)
    reg, flow = tex.BatchedExecutor3D(device="cpu").process_batch(
        video, proc, ref, ref_proc, w_init, interpolation_method="cubic",
        flow_params=fp)
    np.testing.assert_allclose(reg.numpy(), reg_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(flow.numpy(), flow_j, rtol=0, atol=1e-3)


@pytest.mark.parametrize("n,multiple", [(4, 3), (6, 3), (1, 4), (5, 1)])
def test_pad_to_multiple_matches_jax(n, multiple):
    a = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    want, n_want = jax_pad(a, multiple)
    got, n_got = pad_to_multiple(a, multiple)
    assert n_got == n_want == n
    np.testing.assert_array_equal(got, want)
    got1, _ = pad_to_multiple(a, 4, axis=1)
    np.testing.assert_array_equal(got1, jax_pad(a, 4, axis=1)[0])


# -- capture safety of the pyramid ------------------------------------------

_KEY_KW = dict(alpha=(1.5,) * 3, update_lag=2, iterations=4, min_level=0,
               levels=3, eta=0.8, a_data=0.45)


def _pyramid_inputs(C, seed=3):
    rng = np.random.default_rng(seed)
    shape = (8, 20, 22)
    fixed = gaussian_filter(rng.random(shape + (C,)), (1, 1, 1, 0))
    moving = np.roll(fixed, (0, 1, -1), axis=(0, 1, 2))
    uvw = np.zeros(shape + (3,))
    weight = np.full(shape + (C,), 1.0 / C)
    return shape, [torch.from_numpy(a.astype(np.float32))
                   for a in (fixed, moving, uvw, weight)]


def test_data_exponents_tensor_equals_numpy():
    rng = np.random.default_rng(1)
    P, M, N, C = 6, 9, 10, 2
    J = torch.from_numpy(rng.random((10, C, P, M, N)).astype(np.float32))
    weight = torch.from_numpy(rng.random((C, P, M, N)).astype(np.float32))
    u, v, w = (torch.from_numpy(0.1 * rng.standard_normal((P, M, N))
                                .astype(np.float32)) for _ in range(3))
    a_data = np.array([0.45, 0.3])
    for a_smooth in (1.0, 0.5):
        args = (J, weight, u, v, w, (1.5, 1.5, 1.5), 4, 2)
        tail = (a_smooth, 1.1, 1.2, 1.3)
        want = compute_flow_level_cl(*args, a_data, *tail)
        got = compute_flow_level_cl(
            *args, torch.tensor(a_data, dtype=torch.float32), *tail)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
@pytest.mark.parametrize("C", [1, 2])
def test_warm_pyramid_uploads_nothing(monkeypatch, a_smooth, C):
    shape, inputs = _pyramid_inputs(C)
    key = tpyr.pyramid_config_key(shape, C, a_smooth=a_smooth, **_KEY_KW)
    pyramid = tpyr.build_pyramid(*key, device="cpu")
    first = pyramid(*inputs)

    def refuse(*args, **kwargs):
        raise AssertionError("host-to-tensor copy inside a warm pyramid")

    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    assert torch.equal(pyramid(*inputs), first)


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_pyramid_equals_per_level_upload(monkeypatch, a_smooth):
    """The exponents uploaded once per pyramid give the bits of the former
    per-level upload (each level converting the numpy exponents itself)."""
    shape, inputs = _pyramid_inputs(2)
    key = tpyr.pyramid_config_key(shape, 2, a_smooth=a_smooth, **_KEY_KW)
    want = tpyr.build_pyramid(*key, device="cpu")(*inputs)
    monkeypatch.setattr(tpyr, "data_exponents",
                        lambda a_data, *args: a_data)
    got = tpyr.build_pyramid(*key, device="cpu")(*inputs)
    assert torch.equal(got, want)
