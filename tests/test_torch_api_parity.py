"""The port's public API against the JAX package's, name by name.

For every module of ``flowreg3d_tpu`` (one case each), every public
function, class and method defined there has a counterpart in the same
module of ``flowreg3d_tpu_torch``, and the counterpart takes the JAX
parameter names in the JAX order. The port may add parameters of its own
(``device``, ``use_kernels``, ``devices``, ...), so that a call written for
the JAX package, by position or by keyword, runs on the port. The
documented exceptions are listed below, each with its reason.
"""

import importlib
import inspect
import pkgutil

import pytest

import flowreg3d_tpu

# JAX modules that have no counterpart module
MODULES = {
    "flowreg3d_tpu.core.solver_pallas":
        "the Pallas SOR kernels: CUDA kernels behind core/solver_kernel.py "
        "and core/solver_psi_kernel.py (PERF.md kernel table)",
    "flowreg3d_tpu.ops.median_pallas":
        "the Pallas median kernels: the CUDA kernel behind "
        "ops/median_kernel.py",
    "flowreg3d_tpu.ops.warp_pallas":
        "the Pallas sampling kernel: the CUDA kernel behind "
        "ops/warp_kernel.py",
    "flowreg3d_tpu.util.compile_cache":
        "JAX's persistent compilation cache, a TPU workaround (ROADMAP "
        "ground rules)",
}

# (JAX module, name) -> (the port's name, or None: none), and why
NAMES = {
    ("flowreg3d_tpu.core.solver", "kernel_barrier"): (
        None, "orders Pallas calls on the TPU, a workaround (ROADMAP ground "
        "rules)"),
    ("flowreg3d_tpu.core.solver", "pallas_enabled"): (
        None, "picks Pallas by platform; the port's kernels run on every "
        "CUDA tensor"),
    ("flowreg3d_tpu.core.solver", "pallas_kernel_on"): (
        None, "per-kernel Pallas switches (FLOWREG3D_PALLAS_*), a TPU "
        "workaround"),
    ("flowreg3d_tpu.core.pyramid", "build_pyramid_raw"): (
        "build_pyramid", "the un-jitted pyramid; the port has no jit to "
        "set it apart from"),
    ("flowreg3d_tpu.util.random", "get_jax_key"): (
        "get_torch_generator", "a torch.Generator in place of a JAX PRNG "
        "key"),
    ("flowreg3d_tpu.util.xcorr_prealignment", "estimate_rigid_xcorr_traced"): (
        "estimate_rigid_xcorr_device", "the estimate on device tensors; "
        "nothing is traced in the port"),
    ("flowreg3d_tpu.parallel.mesh", "batch_mesh"): (
        None, "a JAX Mesh constructor; the port's meshes are device lists "
        "(parallel.batch_devices)"),
    ("flowreg3d_tpu.parallel.spatial", "spatial_mesh"): (
        None, "a JAX Mesh constructor; the port's meshes are device lists"),
    ("flowreg3d_tpu.pipeline.of_options", "OFOptions.model_post_init"): (
        None, "pydantic's hook; the port's OFOptions is a dataclass "
        "(__post_init__), since the card machine has no pydantic"),
}

# JAX parameter names the port does not take, anywhere
PARAMETERS = {
    "use_pallas": "the port's use_kernels",
    "slab": "the Pallas median's z-slab size, a TPU memory workaround",
    "mesh": "a JAX Mesh; the port takes a device list (devices)",
    "axis": "the JAX mesh axis name; a device list has one axis",
    "n_workers": "host threads of the reference; the port's executors run "
                 "on the card (CHANGES.md)",
    "kwargs": "the reference's catch-all; the port takes its parameters "
              "by name (process_batch: flow_params)",
    "chunk": "frames a lax.map step; a CUDA graph holds one frame, so a "
             "chunk bounds nothing (ROADMAP Queue 3)",
    "voxel_budget": "sizes chunk (ROADMAP Queue 3)",
    "n_jobs": "unused by the JAX package's pipeline (CHANGES.md)",
    "batch_size": "unused by the JAX package's pipeline (CHANGES.md)",
}

# (JAX module, qualified name, parameter) the port does not take, and why
CALL_PARAMETERS = {
    ("flowreg3d_tpu.parallel.executors", "MeshExecutor3D.__init__",
     "per_device"): "frames a device a chunk, as chunk (ROADMAP Queue 3)",
    ("flowreg3d_tpu.pipeline.device_pipeline", "ResidentPipeline.__init__",
     "mode"): "the executor's name; the port takes the executor itself",
}

METHODS = ("__init__", "__call__", "__enter__", "__exit__")


def _jax_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        flowreg3d_tpu.__path__, "flowreg3d_tpu."))


def _parameters(fn):
    return list(inspect.signature(fn).parameters)


def _public(module):
    """(qualified name, JAX object) of the functions, classes and methods
    ``module`` defines."""
    for name, obj in sorted(vars(module).items()):
        if name.startswith("_") or getattr(
                obj, "__module__", None) != module.__name__:
            continue
        if inspect.isclass(obj):
            yield name, obj
            for meth, member in sorted(vars(obj).items()):
                if meth.startswith("_") and meth not in METHODS:
                    continue
                if callable(member) or isinstance(
                        member, (staticmethod, classmethod, property)):
                    yield f"{name}.{meth}", getattr(obj, meth)
        elif callable(obj):
            yield name, obj


def _resolve(module, qualname):
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


@pytest.mark.parametrize("name", _jax_modules())
def test_public_api_matches_jax(name):
    if name in MODULES:
        port = name.replace("flowreg3d_tpu", "flowreg3d_tpu_torch", 1)
        with pytest.raises(ImportError):
            importlib.import_module(port)
        return
    jax_mod = importlib.import_module(name)
    port_mod = importlib.import_module(
        name.replace("flowreg3d_tpu", "flowreg3d_tpu_torch", 1))
    gaps = []
    for qualname, obj in _public(jax_mod):
        port_name, _ = NAMES.get((name, qualname), (qualname, None))
        if port_name is None:
            assert _resolve(port_mod, qualname) is None, (
                f"{name}.{qualname} is now ported: drop it from NAMES")
            continue
        counterpart = _resolve(port_mod, port_name)
        if counterpart is None:
            gaps.append(f"{port_name}: missing")
            continue
        if isinstance(obj, property) or inspect.isclass(obj):
            continue
        try:
            want = _parameters(obj)
        except (TypeError, ValueError):     # a builtin's slot, no signature
            continue
        want = [p for p in want if p not in PARAMETERS
                and (name, qualname, p) not in CALL_PARAMETERS]
        got = _parameters(counterpart)
        it = iter(got)
        if not all(p in it for p in want):
            gaps.append(f"{port_name}{tuple(got)} does not take "
                        f"{tuple(want)} in this order")
    assert not gaps, f"{name}: " + "; ".join(gaps)


def test_every_exception_names_a_jax_api():
    """Each listed exception still exists in the JAX package, and each
    carries a reason."""
    modules = set(_jax_modules())
    assert set(MODULES) <= modules
    for (mod, qualname), (_, why) in NAMES.items():
        assert why and _resolve(importlib.import_module(mod), qualname)
    for (mod, qualname, param), why in CALL_PARAMETERS.items():
        fn = _resolve(importlib.import_module(mod), qualname)
        assert why and param in _parameters(fn)
    assert all(MODULES.values()) and all(PARAMETERS.values())
