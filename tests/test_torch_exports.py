"""The port's package surfaces: every name in each JAX ``__all__`` (the top
level, ops, core, util, backends, motion_generation, pipeline, io and
parallel) resolves in the port, and the port's own ``__all__`` lists it,
except where the port has a counterpart of another name (listed below with
the reason). The top level resolves the pipeline's names lazily, as JAX's
does."""

import importlib

import pytest

# JAX name -> (the port's name, or None: none), and why
RENAMED = {
    ("util", "get_jax_key"): (
        "get_torch_generator", "a torch.Generator in place of a JAX PRNG key"),
    ("parallel", "batch_mesh"): (
        None, "a JAX Mesh constructor; the port's meshes are device lists "
        "(parallel.batch_devices, ROADMAP.md ground rules)"),
}
PACKAGES = ("", "ops", "core", "util", "backends", "motion_generation",
            "pipeline", "io", "parallel")


def _module(root, sub):
    return importlib.import_module(f"{root}.{sub}" if sub else root)


@pytest.mark.parametrize("sub", PACKAGES)
def test_jax_all_present_in_port(sub):
    jax_mod = _module("flowreg3d_tpu", sub)
    port = _module("flowreg3d_tpu_torch", sub)
    missing = []
    for name in jax_mod.__all__:
        port_name, _ = RENAMED.get((sub, name), (name, None))
        if port_name is None:
            assert not hasattr(port, name), f"{sub}.{name} is now ported"
            continue
        if not hasattr(port, port_name) or port_name not in port.__all__:
            missing.append(port_name)
    assert not missing, f"flowreg3d_tpu_torch.{sub}: missing {missing}"


def test_lazy_top_level_names():
    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch import pipeline

    for name in ("OFOptions", "OutputFormat", "QualitySetting",
                 "RegistrationConfig", "BatchMotionCorrector",
                 "compensate_recording", "compensate_arr",
                 "compensate_arr_3D", "compensate_inplace"):
        assert getattr(ft, name) is getattr(pipeline, name)
    with pytest.raises(AttributeError, match="no attribute"):
        ft.not_a_name
