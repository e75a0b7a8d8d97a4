"""Port parity: ``flowreg3d_tpu_torch.runtime`` against
``flowreg3d_tpu.runtime``.

The five cases of tests/test_runtime.py run on the port: detection,
scoped overrides, the executor lookup with the reference's aliases, the
env snapshot round trip and the executor heuristic, which picks 'batched'
(the port runs one device; 'mesh' is not ported yet). The two packages'
snapshots use different env keys, so one cannot leak into the other; the
flow-backend registries behave alike.
"""

import json
import os

import pytest

from flowreg3d_tpu import runtime as jrt

from flowreg3d_tpu_torch import runtime as trt
from flowreg3d_tpu_torch.parallel.executors import (BatchedExecutor3D,
                                                    SequentialExecutor3D)
from flowreg3d_tpu_torch.runtime import (RuntimeContext,
                                         get_optimal_parallelization)


def test_init_and_detection():
    cfg = RuntimeContext.init(force=True)
    want = jrt.RuntimeContext.init(force=True)
    assert {"variational", "torch"} <= set(cfg["available_backends"])
    assert "variational" in want["available_backends"]
    assert set(cfg["available_parallelization"]) >= {"sequential", "batched"}
    assert "mesh" not in cfg["available_parallelization"]
    assert cfg["devices"]["n_devices"] >= 1
    assert cfg["devices"]["platform"] in ("cuda", "cpu")
    feats = cfg["features"]
    assert feats["torch"] and "jax" not in feats and "pallas" not in feats
    assert isinstance(feats["cuda_available"], bool)
    assert isinstance(feats["kernels_built"], bool)


def test_overrides_scoped():
    RuntimeContext.init(force=True)
    assert RuntimeContext.get("executor") is None
    with RuntimeContext.use(executor="batched"):
        assert RuntimeContext.get("executor") == "batched"
        with RuntimeContext.use(executor="sequential"):
            assert RuntimeContext.get("executor") == "sequential"
        assert RuntimeContext.get("executor") == "batched"
    assert RuntimeContext.get("executor") is None


def test_executor_registry_lookup():
    get = RuntimeContext.get_parallelization_executor
    assert get("sequential") is SequentialExecutor3D
    assert get("sequential3d") is SequentialExecutor3D
    assert get("batched") is BatchedExecutor3D
    assert get("threading3d") is BatchedExecutor3D
    # not ported yet (ROADMAP.md Queue 1 item 11)
    assert get("multiprocessing3d") is None
    assert get("nope") is None


def test_env_snapshot_roundtrip():
    RuntimeContext.init(force=True)
    jax_env = os.environ.pop("FLOWREG3D_CONTEXT", None)
    try:
        with RuntimeContext.use(custom_key="hello"):
            RuntimeContext.to_env()
        raw = os.environ.get("FLOWREG3D_TORCH_CONTEXT")
        assert raw and json.loads(raw)["custom_key"] == "hello"
        assert "FLOWREG3D_CONTEXT" not in os.environ
        assert RuntimeContext.from_env()["custom_key"] == "hello"
        # the JAX package's context does not read the port's snapshot
        assert "custom_key" not in jrt.RuntimeContext.init(force=True)
    finally:
        os.environ.pop("FLOWREG3D_TORCH_CONTEXT", None)
        if jax_env is not None:
            os.environ["FLOWREG3D_CONTEXT"] = jax_env
        RuntimeContext.init(force=True)
        jrt.RuntimeContext.init(force=True)


def test_optimal_parallelization():
    RuntimeContext.init(force=True)
    assert get_optimal_parallelization() == "batched"
    assert get_optimal_parallelization(n_frames=100) == "batched"
    assert get_optimal_parallelization(volume_voxels=1e9) == "sequential"
    assert jrt.get_optimal_parallelization(volume_voxels=1e9) in (
        "mesh", "sequential")


def test_flow_backend_registry_like_jax():
    for rt in (trt, jrt):
        rt.register_flow_backend("toy-test", lambda: "made")
        assert rt.get_flow_backend("toy-test") == "made"
        assert "toy-test" in rt.list_flow_backends()
        with pytest.raises(KeyError, match="Unknown flow backend"):
            rt.get_flow_backend("absent-test")
        rt._FLOW_BACKENDS.pop("toy-test")
