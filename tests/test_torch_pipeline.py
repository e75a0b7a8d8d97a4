"""Port parity: the pipeline (``flowreg3d_tpu_torch.pipeline``) against the
JAX package's, on the CPU.

- ``compensate_arr`` on the fixtures of tests/pipeline/conftest.py (T=4,
  (10,20,24,1)) with ``fast_options(a_smooth=0.5)`` given to both through
  ``convert.options_from_jax``, against the JAX ``compensate_arr`` with
  ``RegistrationConfig(parallelization="sequential", device_resident=False)``:
  max |registered difference| <= 1e-4 and max |flow difference| <= 1e-3,
  with update_initialization_w on and off;
- a user ``preproc_funct`` gets the host numpy batch in both packages,
  and their outputs agree within the bounds above;
- ``flow_statistics`` within 1e-5; ``normalize`` and
  ``apply_gaussian_filter`` on 4D and 5D inputs within 2e-6, the symmetric
  padding exactly;
- the shape matrix, output casting, progress and options handling of
  tests/pipeline/test_compensate.py on the port alone.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from flowreg3d_tpu.ops import filters as jfilters
from flowreg3d_tpu.pipeline import RegistrationConfig as JaxConfig
from flowreg3d_tpu.pipeline import compensate_arr as jax_compensate
from flowreg3d_tpu.pipeline import compensate_arr_3D as jax_compensate_3d
from flowreg3d_tpu.pipeline import flow_statistics as jax_stats

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.ops import filters as tfilters
from flowreg3d_tpu_torch.pipeline import (BatchMotionCorrector,
                                          OutputFormat, RegistrationConfig,
                                          compensate_arr, compensate_arr_3D,
                                          flow_statistics)

# the JAX pipeline tests' fixtures, shared so both packages see one case
from tests.pipeline.conftest import (base_volume, fast_options,  # noqa: F401
                                     video5d)

torch.set_num_threads(1)

JAX_CONFIG = JaxConfig(parallelization="sequential", device_resident=False)


def _both(video, ref, **overrides):
    opts = fast_options(a_smooth=0.5, **overrides)
    want = jax_compensate(video, ref, options=opts, config=JAX_CONFIG)
    got = compensate_arr(video, ref, options=options_from_jax(opts),
                         device="cpu")
    return got, want


@pytest.mark.parametrize("update_w", [True, False])
def test_compensate_arr_matches_jax(video5d, base_volume, update_w):
    (reg, w), (reg_j, w_j) = _both(video5d, base_volume,
                                   update_initialization_w=update_w)
    assert reg.shape == reg_j.shape == video5d.shape
    assert reg.dtype == reg_j.dtype
    assert w.shape == w_j.shape == video5d.shape[:4] + (3,)
    np.testing.assert_allclose(reg, reg_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-3)
    err_before = np.abs(video5d - base_volume[None]).mean()
    assert np.abs(reg - base_volume[None]).mean() < err_before


def test_preproc_funct_gets_host_numpy_like_jax(video5d, base_volume):
    """A user preproc_funct is called on the host numpy batch, as the JAX
    pipeline calls it, and its result drives the flow in both alike. The
    hook smooths, as the default chain does: on unsmoothed frames both
    packages amplify rounding (ROADMAP Queue 3) beyond these bounds."""
    calls = {"jax": [], "port": []}

    def hook_for(tag):
        def hook(frames):
            assert isinstance(frames, np.ndarray), type(frames)
            calls[tag].append(frames.shape)
            frames = np.asarray(frames, np.float64)
            return gaussian_filter(
                frames, (0,) * (frames.ndim - 4) + (1.0, 1.0, 1.0, 0))
        return hook

    want = jax_compensate_3d(
        video5d, base_volume, config=JAX_CONFIG,
        options=fast_options(a_smooth=0.5, preproc_funct=hook_for("jax")))
    got = compensate_arr_3D(
        video5d, base_volume, device="cpu",
        options=options_from_jax(fast_options(
            a_smooth=0.5, preproc_funct=hook_for("port"))))
    assert calls["port"] == calls["jax"] == [base_volume.shape,
                                             video5d.shape]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)


def test_shape_matrix_and_casting(video5d, base_volume):
    opts = options_from_jax(fast_options(a_smooth=0.5))
    reg, w = compensate_arr(video5d[..., 0], base_volume[..., 0],
                            options=opts, device="cpu")
    assert reg.shape == video5d.shape[:4]
    assert w.shape == video5d.shape[:4] + (3,)
    reg, w = compensate_arr(video5d[1, ..., 0], base_volume[..., 0],
                            options=opts, device="cpu")
    assert reg.shape == video5d.shape[1:4]
    assert w.shape == video5d.shape[1:4] + (3,)
    for name, dtype in (("single", np.float32), ("uint16", np.uint16)):
        opts.output_typename = name
        reg, _ = compensate_arr(video5d[:1], base_volume, options=opts,
                                device="cpu")
        assert reg.dtype == dtype


def test_progress_statistics_and_options_untouched(video5d, base_volume):
    opts = options_from_jax(fast_options(a_smooth=0.5))
    seen = []
    opts_copy = opts.copy()
    reg, w = compensate_arr(video5d[:2], base_volume, options=opts,
                            progress_callback=lambda d, t: seen.append((d, t)),
                            device="cpu")
    # both executors report per frame
    assert seen == [(1, 2), (2, 2)]
    seen.clear()
    compensate_arr(video5d[:2], base_volume, options=opts,
                   progress_callback=lambda d, t: seen.append((d, t)),
                   config=RegistrationConfig(parallelization="sequential"),
                   device="cpu")
    assert seen == [(1, 2), (2, 2)]
    assert opts.output_format == opts_copy.output_format
    assert opts.save_w == opts_copy.save_w

    corrector = BatchMotionCorrector(
        opts.replace(input_file=video5d, reference_frames=base_volume,
                     output_format=OutputFormat.ARRAY, save_w=True),
        device="cpu")
    corrector.run()
    want = jax_stats(corrector.w_writer.get_array())
    for k in want:
        np.testing.assert_allclose(getattr(corrector, k), want[k], rtol=1e-5,
                                   atol=1e-5)


def test_flow_statistics_matches_jax():
    rng = np.random.default_rng(1)
    flows = rng.standard_normal((3, 6, 8, 9, 3)).astype(np.float32)
    flows[1] = 0.0
    flows[1, ..., 0] = 2.0
    got, want = flow_statistics(torch.from_numpy(flows)), jax_stats(flows)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    assert got["mean_disp"][1] == pytest.approx(2.0)


@pytest.mark.parametrize("shape,sigma", [
    ((10, 20, 24, 2), [[1.0, 1.5, 0.7, 0.1], [2.0, 1.0, 1.0, 0.1]]),
    ((5, 10, 20, 24, 1), [1.0, 1.0, 1.0, 2.0]),
    ((4, 3, 7, 9, 2), [[1.0, 1.0, 1.0, 0.1]]),
    ((4, 3, 7, 9, 1), [1.0, 1.5, 2.0])])
@pytest.mark.parametrize("mode", ["together", "separate"])
@pytest.mark.parametrize("with_ref", [False, True])
def test_preprocessing_matches_jax(shape, sigma, mode, with_ref):
    rng = np.random.default_rng(2)
    a = rng.random(shape).astype(np.float32)
    ref = rng.random(shape[-4:]) * 1.5 if with_ref else None
    want = np.asarray(jfilters.apply_gaussian_filter(
        jfilters.normalize(a, ref=ref, channel_normalization=mode),
        sigma=np.asarray(sigma, float)))
    got = tfilters.apply_gaussian_filter(
        tfilters.normalize(torch.from_numpy(a),
                           ref=None if ref is None else torch.from_numpy(ref),
                           channel_normalization=mode),
        np.asarray(sigma, float)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_symmetric_padding_matches_numpy(n):
    x = np.arange(n)
    for r in (0, 1, 4, 11):
        idx = tfilters.symmetric_pad_index(n, r).numpy()
        np.testing.assert_array_equal(x[idx], np.pad(x, r, mode="symmetric"))


def test_unported_requests_raise(base_volume, tmp_path):
    """What is still not ported raises and names its ROADMAP item: flow
    backends. The mesh and spatial executors are built; checkpointing,
    prefetch, the async writer and file formats work: a MAT run through all
    three writes the in-memory pipeline's frames."""
    opts = options_from_jax(fast_options(a_smooth=0.5))
    with pytest.raises(ValueError):
        compensate_arr(np.empty((0, 2, 2, 2, 1)), base_volume, device="cpu")
    for name in ("mesh", "spatial"):
        corr = BatchMotionCorrector(
            opts, RegistrationConfig(parallelization=name), device="cpu")
        assert corr.executor.name == name
    for cfg, queue in ((RegistrationConfig(flow_backend="volraft"),
                        "item 13"),
                       (RegistrationConfig(get_displacement_func=len),
                        "item 13")):
        with pytest.raises(NotImplementedError, match=f"Queue 1 {queue}"):
            BatchMotionCorrector(opts, cfg, device="cpu")
    with pytest.raises(ValueError, match="Unknown executor"):
        BatchMotionCorrector(opts, RegistrationConfig(parallelization="gpu9"),
                             device="cpu")
    assert (RegistrationConfig().prefetch, RegistrationConfig().async_write,
            RegistrationConfig().checkpoint) == (2, True, False)
    video = np.stack([base_volume, np.roll(base_volume, 1, axis=1)])
    cfg = RegistrationConfig(checkpoint=True, prefetch=2, async_write=True)
    corr = BatchMotionCorrector(opts.replace(
        output_format=OutputFormat.MAT, input_file=video,
        reference_frames=base_volume, output_path=tmp_path), cfg,
        device="cpu")
    corr.run()
    from flowreg3d_tpu_torch.io.factory import get_video_file_reader

    r = get_video_file_reader(str(tmp_path / "compensated.MAT"))
    reg, _ = compensate_arr(video, base_volume, options=opts, device="cpu")
    np.testing.assert_array_equal(r[:], reg)
    r.close()
    assert not (tmp_path / "checkpoint.npz").exists()


def _epe(w, w_j):
    return float(np.mean(np.linalg.norm(w.astype(np.float64) - w_j,
                                        axis=-1)))


def _agreement_db(reg, reg_j):
    """PSNR of one registered recording against the other, data range 1."""
    mse = float(np.mean((reg.astype(np.float64) - reg_j) ** 2))
    return np.inf if mse == 0 else 10.0 * np.log10(1.0 / mse)


def _two_channel(video5d, base_volume):
    ref = np.concatenate([base_volume, np.sqrt(base_volume)], axis=-1)
    video = np.stack([np.roll(ref, (0, s, -s, 0), axis=(0, 1, 2, 3))
                      for s in range(video5d.shape[0])])
    return video, ref


@pytest.mark.parametrize("C", [1, 2])
def test_pipeline_a_smooth_1_matches_jax(video5d, base_volume, C):
    """The a_smooth == 1 solver's tick blocks end to end, one and two
    channels, on the accuracy gate's bounds (tests/pipeline/
    test_accuracy_gate.py): mean flow EPE <= 0.25, registered volumes agree
    at >= 40 dB."""
    video, ref, extra = video5d, base_volume, {}
    if C == 2:
        video, ref = _two_channel(video5d, base_volume)
        extra = dict(weight=[0.5, 0.5], sigma=[[1.0, 1.0, 1.0, 0.1]] * 2)
    opts = fast_options(a_smooth=1.0, **extra)
    reg_j, w_j = jax_compensate_3d(video, ref, options=opts,
                                   config=JAX_CONFIG)
    reg, w = compensate_arr_3D(video, ref, options=options_from_jax(opts),
                               device="cpu")
    assert reg.shape == video.shape and w.shape == video.shape[:4] + (3,)
    assert _epe(w, w_j) <= 0.25
    assert _agreement_db(reg, reg_j) >= 40.0


@pytest.mark.parametrize("C", [1, 2])
def test_pipeline_at_ofoptions_defaults_matches_jax(video5d, base_volume, C):
    """compensate_arr_3D at OFOptions' own defaults (alpha 0.25, a_smooth
    1, 100 iterations, update_lag 5, min_level 5): registered volumes agree
    with the JAX pipeline's at >= 40 dB, the accuracy gate's bound. Its
    flow bound does not apply here: at these options the case is chaotic
    under rounding (the JAX pipeline against itself on input scaled by
    1 + 2**-22 moves the flow by more than that bound), so the flows are
    not compared, as the canonical step's are not on the card."""
    from flowreg3d_tpu.pipeline import OFOptions as JaxOptions

    from flowreg3d_tpu_torch.pipeline import OFOptions

    video, ref = ((video5d, base_volume) if C == 1
                  else _two_channel(video5d, base_volume))
    reg_j, w_j = jax_compensate_3d(video, ref, options=JaxOptions(),
                                   config=JAX_CONFIG)
    reg, w = compensate_arr_3D(video, ref, options=OFOptions(), device="cpu")
    assert reg.shape == reg_j.shape == video.shape
    assert w.shape == w_j.shape == video.shape[:4] + (3,)
    assert np.isfinite(w).all() and np.isfinite(reg).all()
    assert _agreement_db(reg, reg_j) >= 40.0
