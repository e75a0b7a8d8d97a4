"""Port parity: the deep-flow backends (``flowreg3d_tpu_torch.backends``) and
the pipeline's flow-backend path against the JAX package's, on the CPU.

- JAX's 4 tests of tests/pipeline/test_flow_backends.py on the port;
- ``PatchRigidFlowBackend`` with and without an initial ``uvw`` against
  JAX's at 1e-5, on the fixture pair;
- one TorchScript module scripted here (a seeded ``Conv3d(2, 3, 3)``) and
  loaded by both packages' ``load_volraft``, at 1e-5;
- ``compensate_arr_3D`` with a custom callable and with the TorchScript
  backend, against JAX's with the same config: flows 1e-5, registered
  frames 1e-4; through the sequential, batched, mesh and spatial executors
  (mesh and spatial over [cpu, cpu]), with ``cc_initialization`` once (the
  cc pipeline's own bounds, 1e-3 / 1e-4: tests/test_torch_xcorr.py), and
  through ``compensate_recording`` to a TIFF once;
- the rigid stand-in through the pipeline (``get_displacement_func=`` and
  ``flow_backend="volraft-mock"``): the flows held to twice JAX's own
  spread under one- and two-ulp scalings of the input, the mean flow per
  frame to 0.02 and the registered frames' error to 5% of JAX's. Its
  phase-only correlation normalises every frequency bin to unit magnitude,
  so rounding in the near-empty bins of the smoothed patches moves the JAX
  pipeline's own flow by up to ~0.03 (ROADMAP.md, Queue 3);
- the registry and ``RuntimeContext``'s ``available_backends``.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndshift

from flowreg3d_tpu.backends import PatchRigidFlowBackend as JaxRigid
from flowreg3d_tpu.backends import load_volraft as jax_load_volraft
from flowreg3d_tpu.pipeline import OFOptions as JaxOptions
from flowreg3d_tpu.pipeline import compensate_arr_3D as jax_compensate
from flowreg3d_tpu.pipeline import compensate_recording as jax_recording
from flowreg3d_tpu.pipeline.corrector import RegistrationConfig as JaxConfig

from flowreg3d_tpu_torch.backends import (PatchRigidFlowBackend,
                                          VolRAFTBackend, load_volraft)
from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.io.factory import get_video_file_reader
from flowreg3d_tpu_torch.io.tiff3d import TIFFFileWriter3D
from flowreg3d_tpu_torch.pipeline import (RegistrationConfig,
                                          compensate_arr_3D,
                                          compensate_recording)
from flowreg3d_tpu_torch.runtime import (RuntimeContext, get_flow_backend,
                                         list_flow_backends)

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHIFT = (0.8, 1.6, -1.2)                     # (z, y, x) content shift
FLOW = [-1.2, 1.6, 0.8]                      # its backward flow [dx,dy,dz]
INNER = (slice(2, -2), slice(4, -4), slice(4, -4))
# input scalings by one and two ulps: JAX's own spread under rounding
ULP_SCALINGS = (1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24, 1.0 + 2.0 ** -22,
                1.0 - 2.0 ** -23)


@pytest.fixture(autouse=True)
def jax_float32():
    """JAX's reference in its default float32, whatever an earlier test
    file left in the worker (tests/core/test_solver2d.py turns x64 on for
    the whole process)."""
    with jax.enable_x64(False):
        yield


@pytest.fixture
def pair():
    rng = np.random.default_rng(0)
    ref = gaussian_filter(rng.random((12, 48, 48)).astype(np.float32), 1.2)
    mov = ndshift(ref, SHIFT, order=3, mode="nearest")
    return ref, mov


@pytest.fixture
def video(pair):
    """T=2: the pair's moving volume and a second shift, (T,Z,Y,X,1)."""
    ref, mov = pair
    second = ndshift(ref, (0.3, -1.0, 0.5), order=3, mode="nearest")
    return np.stack([mov, second])[..., None]


def _script_conv(path, seed=0):
    """A TorchScript Conv3d(2, 3, 3, padding=1) with seeded weights: the
    checkpoint contract (1, 2, D, H, W) -> (1, 3, D, H, W)."""
    conv = torch.nn.Conv3d(2, 3, 3, padding=1)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        conv.weight.copy_(0.1 * torch.randn(conv.weight.shape, generator=gen))
        conv.bias.copy_(0.1 * torch.randn(3, generator=gen))
    torch.jit.script(conv).save(str(path))
    return path


@pytest.fixture
def checkpoint_dir(tmp_path):
    _script_conv(tmp_path / "volraft.pt")
    return tmp_path


def _uvw(shape, seed=1):
    rng = np.random.default_rng(seed)
    uvw = np.zeros(shape + (3,), np.float32)
    uvw[..., 0] = -0.5
    uvw[..., 2] = 0.3
    return uvw + 0.2 * rng.standard_normal(uvw.shape).astype(np.float32)


def _constant_flow(fixed, moving, uvw=None, **params):
    flow = np.zeros(np.asarray(fixed).shape[:3] + (3,), np.float32)
    flow[...] = FLOW
    return flow


# -- JAX's tests/pipeline/test_flow_backends.py on the port -------------------

def test_custom_callable_through_pipeline(pair):
    ref, mov = pair
    calls = {"n": 0}

    def custom(fixed, moving, uvw=None, **params):
        calls["n"] += 1
        assert isinstance(fixed, np.ndarray) and fixed.dtype == np.float32
        assert isinstance(moving, np.ndarray) and moving.dtype == np.float32
        return _constant_flow(fixed, moving)

    reg, flow = compensate_arr_3D(
        mov[None, ..., None], ref[..., None], device="cpu",
        config=RegistrationConfig(get_displacement_func=custom))
    assert calls["n"] >= 1, "custom backend was never invoked"
    np.testing.assert_allclose(flow[0, 4, 4, 4], FLOW, atol=1e-5)
    assert (np.abs(reg[0, ..., 0] - ref)[INNER].mean()
            < 0.5 * np.abs(mov - ref)[INNER].mean())


def test_patch_rigid_backend_registers_translation(pair):
    ref, mov = pair
    backend = PatchRigidFlowBackend(patch_size=(12, 24, 24), device="cpu")
    reg, flow = compensate_arr_3D(
        mov[None, ..., None], ref[..., None], device="cpu",
        config=RegistrationConfig(get_displacement_func=backend))
    np.testing.assert_allclose(flow.reshape(-1, 3).mean(0), FLOW, atol=0.4)
    assert (np.abs(reg[0, ..., 0] - ref)[INNER].mean()
            < 0.35 * np.abs(mov - ref)[INNER].mean())


def test_backend_registry_and_detection(pair):
    assert "volraft" in list_flow_backends()
    assert "volraft-mock" in list_flow_backends()
    backend = get_flow_backend("volraft-mock", device="cpu")
    assert isinstance(backend, PatchRigidFlowBackend)
    assert backend.device == CPU
    with pytest.raises(KeyError, match="Registered"):
        get_flow_backend("nope")
    # load_volraft without a checkpoint falls back to the stand-in
    assert isinstance(load_volraft(device="cpu"), PatchRigidFlowBackend)
    # a factory without a device argument is called without one
    from flowreg3d_tpu_torch import runtime

    runtime.register_flow_backend("plain-factory", lambda: _constant_flow)
    try:
        assert get_flow_backend("plain-factory", device="cpu",
                                use_kernels=True) is _constant_flow
    finally:
        del runtime._FLOW_BACKENDS["plain-factory"]
    # registry names surface in the runtime's backend detection
    RuntimeContext.init(force=True)
    backends = RuntimeContext.get("available_backends", [])
    assert "variational" in backends and "volraft" in backends
    assert "volraft-mock" in backends


def test_flow_backend_by_name_in_config(pair):
    ref, mov = pair
    cfg = RegistrationConfig(flow_backend="volraft-mock")
    reg, flow = compensate_arr_3D(mov[None, ..., None], ref[..., None],
                                  config=cfg, device="cpu")
    assert np.isfinite(flow).all()
    assert (np.abs(reg[0, ..., 0] - ref)[INNER].mean()
            < 0.5 * np.abs(mov - ref)[INNER].mean())
    # instantiated once, on the run's device, and kept on the config
    assert isinstance(cfg.get_displacement_func, PatchRigidFlowBackend)
    assert cfg.get_displacement_func.device == CPU


def test_backends_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PatchRigidFlowBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_volraft()


# -- the backends against JAX's ----------------------------------------------

@pytest.mark.parametrize("patch_size", [(12, 24, 24), (16, 32, 32)])
def test_rigid_backend_matches_jax(pair, patch_size):
    ref, mov = pair
    want = JaxRigid(patch_size=patch_size)(ref, mov)
    got = PatchRigidFlowBackend(patch_size=patch_size, device="cpu")(ref, mov)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ref.shape + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("patch_size", [(12, 24, 24), (16, 32, 32)])
def test_rigid_backend_with_uvw_matches_jax(pair, patch_size):
    """With an initial uvw. The port pre-warps in float32 (the
    map_coords_f32 kernel's arithmetic), JAX through scipy in float64: the
    pre-warped volumes differ by an ulp, which the stand-in's phase-only
    correlation amplifies to up to 1.06e-5 in flow at (12, 24, 24). So the
    pre-warp is held to scipy at 2 ulps, the stand-in on the same pre-warped
    volume to JAX's at 1e-6, and the whole call to JAX's at 2e-5."""
    from scipy.ndimage import map_coordinates

    ref, mov = pair
    uvw = _uvw(ref.shape)
    port = PatchRigidFlowBackend(patch_size=patch_size, device="cpu")
    warped = port._prewarp(torch.from_numpy(mov),
                           torch.from_numpy(uvw)).numpy()
    grid = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in ref.shape],
                       indexing="ij")
    coords = np.stack([grid[0] + uvw[..., 2], grid[1] + uvw[..., 1],
                       grid[2] + uvw[..., 0]])
    np.testing.assert_allclose(
        warped, map_coordinates(mov, coords, order=1, mode="nearest"),
        rtol=0, atol=2 * np.spacing(np.float32(mov.max())))
    jax_backend = JaxRigid(patch_size=patch_size)
    residual = port(ref, warped)
    np.testing.assert_allclose(residual, jax_backend(ref, warped), rtol=0,
                               atol=1e-6)
    got = port(ref, mov, uvw=uvw)
    np.testing.assert_array_equal(got, residual + uvw)
    np.testing.assert_allclose(got, jax_backend(ref, mov, uvw=uvw), rtol=0,
                               atol=2e-5)


def test_rigid_separable_blend_equals_patch_loop(pair):
    """The stand-in's separable blend against the harness's patch-by-patch
    blend of its own per-patch flows (float64 accumulators; the loop blends
    the float32 flows ``infer_patch`` returns, hence 1e-7)."""
    from flowreg3d_tpu_torch.backends.volraft import PatchInferenceHarness

    ref, mov = pair
    backend = PatchRigidFlowBackend(patch_size=(12, 24, 24), device="cpu")
    fixed, moving = torch.from_numpy(ref), torch.from_numpy(mov)
    patch = (12, 24, 24)
    starts = [backend._starts(n, p) for n, p in zip(ref.shape, patch)]
    acc, wsum = backend._blend(fixed, moving, starts, patch)
    acc_l, wsum_l = PatchInferenceHarness._blend(backend, fixed, moving,
                                                 starts, patch)
    torch.testing.assert_close(wsum, wsum_l, rtol=0, atol=1e-12)
    torch.testing.assert_close(acc / wsum, acc_l / wsum_l, rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("with_uvw", [False, True])
def test_volraft_torchscript_matches_jax(pair, checkpoint_dir, with_uvw):
    ref, mov = pair
    uvw = _uvw(ref.shape) if with_uvw else None
    kw = dict(patch_size=(8, 16, 16), overlap=0.5)
    jax_backend = jax_load_volraft(checkpoint_dir=str(checkpoint_dir), **kw)
    port = load_volraft(checkpoint_dir=str(checkpoint_dir), device="cpu",
                        **kw)
    assert isinstance(port, VolRAFTBackend)
    want = jax_backend(ref, mov, uvw=uvw)
    got = port(ref, mov, uvw=uvw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got).max() > 0.05


def test_volraft_env_checkpoint_dir(monkeypatch, checkpoint_dir):
    monkeypatch.setenv("VOLRAFT_CHECKPOINT_DIR", str(checkpoint_dir))
    assert isinstance(load_volraft(device="cpu"), VolRAFTBackend)
    assert isinstance(get_flow_backend("volraft", device="cpu"),
                      VolRAFTBackend)


# -- the pipeline's flow-backend path against JAX's ---------------------------

def _jax_backend(kind, checkpoint_dir):
    if kind == "custom":
        return _constant_flow
    return jax_load_volraft(checkpoint_dir=str(checkpoint_dir),
                            patch_size=(8, 16, 16), overlap=0.5)


def _port_backend(kind, checkpoint_dir):
    if kind == "custom":
        return _constant_flow
    return load_volraft(checkpoint_dir=str(checkpoint_dir), device="cpu",
                        patch_size=(8, 16, 16), overlap=0.5)


@pytest.mark.parametrize("kind", ["custom", "volraft"])
@pytest.mark.parametrize("parallelization",
                         ["sequential", "batched", "mesh", "spatial"])
def test_pipeline_backend_matches_jax(video, pair, checkpoint_dir, kind,
                                      parallelization):
    ref = pair[0][..., None]
    devices = ([CPU, CPU] if parallelization in ("mesh", "spatial")
               else None)
    seen = []
    reg_j, flow_j = jax_compensate(video, ref, config=JaxConfig(
        get_displacement_func=_jax_backend(kind, checkpoint_dir)))
    reg, flow = compensate_arr_3D(
        video, ref, device="cpu",
        progress_callback=lambda d, t: seen.append(d),
        config=RegistrationConfig(
            parallelization=parallelization, devices=devices,
            get_displacement_func=_port_backend(kind, checkpoint_dir)))
    assert seen[-1] == video.shape[0]       # progress per frame, to T
    assert reg.dtype == reg_j.dtype and reg.shape == reg_j.shape
    np.testing.assert_allclose(flow, flow_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(reg, reg_j, rtol=0, atol=1e-4)


def test_pipeline_backend_cc_matches_jax(video, pair, checkpoint_dir):
    ref = pair[0][..., None]
    kw = dict(cc_initialization=True, cc_hw=16)
    reg_j, flow_j = jax_compensate(
        video, ref, options=JaxOptions(**kw), config=JaxConfig(
            get_displacement_func=_jax_backend("volraft", checkpoint_dir)))
    reg, flow = compensate_arr_3D(
        video, ref, options=options_from_jax(JaxOptions(**kw)), device="cpu",
        config=RegistrationConfig(get_displacement_func=_port_backend(
            "volraft", checkpoint_dir)))
    np.testing.assert_allclose(flow, flow_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(reg, reg_j, rtol=0, atol=1e-4)


def test_executor_custom_imregister_func_matches_jax(video, pair):
    """process_batch with a backend and a user imregister_func (host numpy
    in, its result uploaded), against the JAX executor's."""
    from flowreg3d_tpu.parallel.executors import \
        SequentialExecutor3D as JaxSequential

    from flowreg3d_tpu_torch.parallel.executors import SequentialExecutor3D

    ref = pair[0][..., None]
    calls = []

    def shifted_copy(frame, u, v, w, reference, interpolation_method="cubic"):
        assert isinstance(frame, np.ndarray) and isinstance(u, np.ndarray)
        calls.append(interpolation_method)
        return np.roll(frame, 1, axis=1)[..., 0] + 0.5 * u

    w_init = np.zeros(ref.shape[:3] + (3,), np.float32)
    args = (video, video, ref, ref, w_init)
    want = JaxSequential().process_batch(
        *args, get_displacement_func=_constant_flow,
        imregister_func=shifted_copy, interpolation_method="linear")
    got = SequentialExecutor3D(device="cpu").process_batch(
        *args, _constant_flow, shifted_copy, "linear")
    assert calls == ["linear"] * 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


def test_recording_with_backend_matches_jax(tmp_path, video, pair,
                                            checkpoint_dir):
    """compensate_recording to a TIFF with the TorchScript backend."""
    ref = pair[0][..., None]
    path = tmp_path / "rec.tif"
    w = TIFFFileWriter3D(str(path))
    w.write_frames(video)
    w.close()
    jax_backend = _jax_backend("volraft", checkpoint_dir)
    port_backend = _port_backend("volraft", checkpoint_dir)

    def opts(out):
        return JaxOptions(input_file=str(path), output_path=str(out),
                          output_format="TIFF", reference_frames=ref)

    jax_recording(opts(tmp_path / "jax"),
                  config=JaxConfig(get_displacement_func=jax_backend))
    compensate_recording(
        options_from_jax(opts(tmp_path / "port")), device="cpu",
        config=RegistrationConfig(get_displacement_func=port_backend))
    got = get_video_file_reader(str(tmp_path / "port" / "compensated.TIFF"))
    want = get_video_file_reader(str(tmp_path / "jax" / "compensated.TIFF"))
    reg, reg_j = got[:], want[:]
    got.close()
    want.close()
    assert reg.shape == reg_j.shape == video.shape
    np.testing.assert_allclose(reg, reg_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("by_name", [False, True])
def test_rigid_pipeline_within_jax_rounding_spread(video, pair, by_name):
    ref = pair[0]

    def jax_run(frames):
        cfg = (JaxConfig(flow_backend="volraft-mock") if by_name
               else JaxConfig(get_displacement_func=JaxRigid()))
        return jax_compensate(frames, ref[..., None], config=cfg)

    reg_j, flow_j = jax_run(video)
    spread = max(float(np.abs(jax_run(video * np.float32(s))[1]
                              - flow_j).max()) for s in ULP_SCALINGS)
    cfg = (RegistrationConfig(flow_backend="volraft-mock") if by_name
           else RegistrationConfig(
               get_displacement_func=PatchRigidFlowBackend(device="cpu")))
    reg, flow = compensate_arr_3D(video, ref[..., None], config=cfg,
                                  device="cpu")
    assert spread > 1e-3, "the fixture no longer amplifies rounding"
    assert np.abs(flow - flow_j).max() <= 2 * spread
    np.testing.assert_allclose(flow.reshape(2, -1, 3).mean(1),
                               flow_j.reshape(2, -1, 3).mean(1), atol=0.02)

    def error(r):
        return np.abs(r[..., 0] - ref[None])[(slice(None),) + INNER].mean(
            axis=(1, 2, 3))

    np.testing.assert_allclose(error(reg), error(reg_j), rtol=0.05)
    assert (error(reg) < 0.35 * error(video)).all()
