"""Port parity: the mesh executor (``flowreg3d_tpu_torch.parallel``) and the
resident engine's mesh mode, on the CPU with a list of CPU "devices"
(``[cpu] * 3``: each entry a shard of its own, one process).

- ``parallel/mesh.py``: every card (or the one CPU) by default, a device
  list as given, contiguous per-shard frame ranges, one replica a distinct
  device, copies counted.
- The mesh executor over three shards, T = 5 (chunks of 2, 2, 1), against
  the sequential executor: bit-identical, progress once a frame.
- ``compensate_arr_3D`` with ``parallelization='mesh'`` over a T = 5
  recording in two batches (buffer 3: the w_init of the first batch's last
  flows seeds the second), resident and host-staged: bit-identical to the
  sequential executor's pipeline with and without w_init chaining, and
  against the JAX sequential pipeline at the pipeline's parity bounds
  (registered 1e-4, flows 1e-3; tests/test_torch_pipeline.py).
"""

import numpy as np
import pytest
import torch

from flowreg3d_tpu.pipeline import compensate_arr_3D as jax_compensate_3d
from flowreg3d_tpu.pipeline.corrector import \
    RegistrationConfig as JaxConfig

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.parallel import executors as tex
from flowreg3d_tpu_torch.parallel import mesh as tmesh
from flowreg3d_tpu_torch.pipeline import (BatchMotionCorrector,
                                          RegistrationConfig,
                                          compensate_arr_3D)

from tests.pipeline.conftest import base_volume, fast_options  # noqa: F401

torch.set_num_threads(1)
CPU = torch.device("cpu")
SHARDS = [CPU] * 3


def _video(base_volume, T=5):
    return np.stack([np.roll(base_volume, (0, s % 3, -s, 0), axis=(0, 1, 2, 3))
                     for s in range(T)])


def test_mesh_helpers():
    assert tmesh.batch_devices(device="cpu") == [CPU]
    assert tmesh.batch_devices(["cpu", "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError):
        tmesh.batch_devices([])
    assert tmesh.batch_ranges(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert tmesh.batch_ranges(2, 3) == [(0, 1), (1, 2), (2, 2)]
    x = np.arange(10).reshape(5, 2)
    chunks = tmesh.shard_batch(x, SHARDS)
    assert [c.shape[0] for c in chunks] == [2, 2, 1]
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), x)
    t = torch.ones(3)
    assert tmesh.replicate(t, SHARDS) == {CPU: t}
    dst = torch.zeros(3)
    before = tmesh.peer_copy.copies
    tmesh.peer_copy(dst, t)
    assert torch.equal(dst, t) and tmesh.peer_copy.copies == before + 1


def test_mesh_executor_equals_sequential(base_volume):
    video = _video(base_volume)
    proc = video * 1.5
    fp = fast_options(a_smooth=0.5).to_dict()
    w_init = np.full(base_volume.shape[:3] + (3,), 0.25, np.float32)
    out, seen = {}, {}
    for ex in (tex.SequentialExecutor3D(device="cpu"),
               tex.MeshExecutor3D(device="cpu", devices=SHARDS)):
        seen[ex.name] = []
        out[ex.name] = ex.process_batch(video, proc, base_volume,
                                        base_volume, w_init, "cubic",
                                        seen[ex.name].append, fp)
    assert seen["mesh"] == [1] * 5
    assert tex.MeshExecutor3D(device="cpu", devices=SHARDS).get_info()[
        "n_devices"] == 3
    for a, b in zip(out["sequential"], out["mesh"]):
        assert a.shape[0] == 5 and torch.equal(a, b)


@pytest.mark.parametrize("update_w", [True, False])
def test_mesh_pipeline_resident_and_staged(base_volume, update_w):
    video = _video(base_volume)
    opts = fast_options(a_smooth=0.5, buffer_size=3,
                        update_initialization_w=update_w)
    runs = {}
    for tag, cfg in (
            ("sequential", RegistrationConfig(parallelization="sequential")),
            ("mesh", RegistrationConfig(parallelization="mesh",
                                        devices=SHARDS)),
            ("mesh staged", RegistrationConfig(parallelization="mesh",
                                               devices=SHARDS,
                                               device_resident=False))):
        ran = []
        run = BatchMotionCorrector.run

        def recorded(self, *a, **k):
            ran.append(self)
            return run(self, *a, **k)

        BatchMotionCorrector.run = recorded
        try:
            runs[tag] = compensate_arr_3D(video, base_volume,
                                          options=options_from_jax(opts),
                                          config=cfg, device="cpu")
        finally:
            BatchMotionCorrector.run = run
        assert ran[0].executor.name == tag.split()[0]
        assert ran[0].used_device_resident == (tag != "mesh staged")
        runs[tag + " stats"] = ran[0].mean_disp
    for tag in ("mesh", "mesh staged"):
        for a, b in zip(runs["sequential"], runs[tag]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(runs[tag + " stats"],
                                   runs["sequential stats"], rtol=1e-6)
    reg_j, w_j = jax_compensate_3d(
        video, base_volume, options=opts,
        config=JaxConfig(parallelization="sequential",
                         device_resident=False))
    reg, w = runs["mesh"]
    np.testing.assert_allclose(reg, reg_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-3)
