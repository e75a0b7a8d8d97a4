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
  tests/pipeline/test_compensate.py on the port alone;
- the outputs ``compensate_arr`` writes in place (its writers told the frame
  count, the registered frames cast on the way) bit-equal to the
  corrector's batches concatenated and then cast as before, for every
  ``output_typename``, from u16 and float32, T=5 at buffer 2, on both
  engines, and for 3-D and 4-D inputs; both arrays handed back without a
  copy;
- the downloads that land in those arrays (each batch's pinned buffer
  copied and cast once into the writers' next frames) bit-equal to the path
  on which every batch downloads into fresh arrays and is written by copy,
  on both engines, from u16 to ``double``, ``single`` and ``uint16``, from
  float32, and under ``cc_initialization``; the writers' and the process's
  counts of the frames that landed, none where the frames' writer declines
  (an integer output from float32 frames), for a file writer or for an
  ``AsyncWriter3D``; the mesh executor's shards landing at their frames of
  one writer's array, each batch claimed at its first shard;
- the same with the writers' page toucher on (chunks shrunk to the test's
  arrays), through both flow sources, landed and written, and over the
  mesh: bit-equal whether it ran ahead of every claim (then every frame
  counts as prefaulted) or behind them; no toucher thread left after the
  call.
"""

import importlib
import time

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
from flowreg3d_tpu_torch.io import array
from flowreg3d_tpu_torch.io.array import ArrayWriter3D, write_totals
from flowreg3d_tpu_torch.io.async_writer import AsyncWriter3D
from flowreg3d_tpu_torch.ops import filters as tfilters
from flowreg3d_tpu_torch.pipeline import (BatchMotionCorrector, OFOptions,
                                          OutputFormat, RegistrationConfig,
                                          compensate_arr, compensate_arr_3D,
                                          compensate_recording,
                                          flow_statistics)
from flowreg3d_tpu_torch.pipeline.compensate_arr import _DTYPE_MAP
from flowreg3d_tpu_torch.pipeline.device_pipeline import HostStaging

# the JAX pipeline tests' fixtures, shared so both packages see one case
from tests.pipeline.conftest import (base_volume, fast_options,  # noqa: F401
                                     video5d)
from tests.test_torch_io import _concatenated_then_cast, _touchers

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
        idx = tfilters.pad_index(n, r).numpy()
        np.testing.assert_array_equal(x[idx], np.pad(x, r, mode="symmetric"))


def test_executor_checkpoint_and_writer_requests(base_volume, tmp_path):
    """Every RegistrationConfig request is served: the mesh and spatial
    executors are built, an unknown executor raises; checkpointing,
    prefetch, the async writer and file formats work: a MAT run through all
    three writes the in-memory pipeline's frames. (Flow backends:
    tests/test_torch_backends.py.)"""
    opts = options_from_jax(fast_options(a_smooth=0.5))
    with pytest.raises(ValueError):
        compensate_arr(np.empty((0, 2, 2, 2, 1)), base_volume, device="cpu")
    for name in ("mesh", "spatial"):
        corr = BatchMotionCorrector(
            opts, RegistrationConfig(parallelization=name), device="cpu")
        assert corr.executor.name == name
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


ENGINES = {
    "resident": None,
    "host_staged": RegistrationConfig(parallelization="sequential",
                                      device_resident=False),
}


def _recording(src, T=5):
    """T volumes of (6,16,16,1): u16 counts, or float32 reaching below 0 and
    above 65535, so that every integer output type clips."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (6, 20, 20))
    frames = np.stack([base[:, t % 3:t % 3 + 16, 2:18]
                       for t in range(T)])[..., None]
    if src == np.uint16:
        return (frames * 10000).astype(np.uint16)
    return (frames * 1e5 - 3e4).astype(np.float32)


def _reference(src):
    return _recording(src)[:2].mean(axis=0)


def _small_options(**kw):
    """buffer 2: T=5 runs in batches of 2, 2 and 1."""
    return OFOptions(alpha=(1.5, 1.5, 1.5), iterations=4, levels=3,
                     min_level=1, buffer_size=2, quality_setting="fast", **kw)


@pytest.fixture(scope="module")
def before():
    """(engine, src, T) -> the registered frames (the input's dtype) and
    flows as ``compensate_arr`` got them before its writers were told the
    frame count: the corrector's batches concatenated by writers told
    none."""
    from flowreg3d_tpu_torch.io.array import ArrayWriter3D

    done = {}

    def get(engine, src, T=5):
        if (engine, src, T) not in done:
            opts = _small_options().replace(
                input_file=_recording(src, T),
                reference_frames=_reference(src),
                output_format=OutputFormat.ARRAY, save_w=True)
            corr = BatchMotionCorrector(opts, ENGINES[engine], device="cpu")
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(importlib.import_module(
                    "flowreg3d_tpu_torch.pipeline.corrector"), "ArrayWriter3D",
                    lambda frame_count: ArrayWriter3D())
                corr.run()
            assert corr.video_writer.frames_appended == T
            assert corr.w_writer.frames_appended == T
            done[engine, src, T] = (corr.video_writer.get_array(),
                                    corr.w_writer.get_array())
        return done[engine, src, T]
    return get


def _recorded_writers(monkeypatch):
    """The ``ArrayWriter3D`` instances ``compensate_arr`` and the corrector
    make, in order (the frames' writer, then the flows')."""
    from flowreg3d_tpu_torch.io.array import ArrayWriter3D

    made = []

    class Recorded(ArrayWriter3D):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    for mod in ("compensate_arr", "corrector"):
        monkeypatch.setattr(importlib.import_module(
            f"flowreg3d_tpu_torch.pipeline.{mod}"), "ArrayWriter3D", Recorded)
    return made


@pytest.mark.parametrize("name", sorted(_DTYPE_MAP))
@pytest.mark.parametrize("src", [np.uint16, np.float32])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_written_in_place_equals_concatenate_then_cast(monkeypatch, before,
                                                       engine, src, name):
    writers = _recorded_writers(monkeypatch)
    reg, w = compensate_arr_3D(_recording(src), _reference(src),
                               _small_options(output_typename=name),
                               config=ENGINES[engine], device="cpu")
    reg0, w0 = before(engine, src)
    want = _concatenated_then_cast([reg0], _DTYPE_MAP[name])
    assert reg.dtype == want.dtype and w.dtype == w0.dtype == np.float32
    np.testing.assert_array_equal(reg, want)
    np.testing.assert_array_equal(w, w0)
    assert [(x.frames_in_place, x.frames_appended) for x in writers] == \
        [(5, 0), (5, 0)]
    assert np.shares_memory(reg, writers[0].get_array())
    assert np.shares_memory(w, writers[1].get_array())


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_squeezed_inputs_written_in_place(before, engine, ndim):
    """(T,Z,Y,X) and (Z,Y,X) inputs return the shapes they returned before,
    with the values of a (T,Z,Y,X,1) recording concatenated, then cast."""
    T = 5 if ndim == 4 else 1
    movie = _recording(np.uint16, T)[..., 0]
    if ndim == 3:
        movie = movie[0]
    reg, w = compensate_arr_3D(movie, _reference(np.uint16)[..., 0],
                               _small_options(),
                               config=ENGINES[engine], device="cpu")
    reg0, w0 = before(engine, np.uint16, T)
    reg0 = _concatenated_then_cast([reg0], np.float64)
    if ndim == 4:
        want_reg, want_w = np.squeeze(reg0, axis=-1), w0
    else:
        want_reg, want_w = np.squeeze(reg0), np.squeeze(w0, axis=0)
    assert reg.shape == movie.shape and w.shape == movie.shape + (3,)
    np.testing.assert_array_equal(reg, want_reg)
    np.testing.assert_array_equal(w, want_w)


# (source dtype, output_typename, options, the registered frames land)
LANDING = {
    "u16-double": (np.uint16, "double", {}, True),
    "u16-single": (np.uint16, "single", {}, True),
    "u16-uint16": (np.uint16, "uint16", {}, True),
    "f32-double": (np.float32, "double", {}, True),
    "f32-uint16": (np.float32, "uint16", {}, False),
    "u16-double-cc": (np.uint16, "double",
                      dict(cc_initialization=True, cc_hw=8, cc_up=4), True),
}


def _copied(src, name, config, **kw):
    """``compensate_arr_3D`` with no writer handing out views: every batch
    downloads into fresh arrays and is written by copy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ArrayWriter3D, "frames_view", lambda self, *a: None)
        return compensate_arr_3D(_recording(src), _reference(src),
                                 _small_options(output_typename=name, **kw),
                                 config=config, device="cpu")


def _prefaulting(monkeypatch, toucher):
    """The writers' page toucher on the test's small arrays (chunks of 4
    KiB): "ahead", every claim waits until it has faulted every frame of
    its writers; "behind", it sleeps before each chunk, so claims overtake
    it and wait for chunks it is inside."""
    if toucher is None:
        return
    monkeypatch.setattr(array, "_CHUNK", 4096)
    if toucher == "ahead":
        claim = array._Toucher.claim

        def after_the_toucher(self, claims):
            with self.cond:
                assert self.cond.wait_for(lambda: self.thread is None,
                                          timeout=30)
            claim(self, claims)

        monkeypatch.setattr(array._Toucher, "claim", after_the_toucher)
    else:
        touch = array._touch
        monkeypatch.setattr(array, "_touch",
                            lambda chunk: (time.sleep(0.02), touch(chunk)))


@pytest.mark.parametrize("engine,case,toucher", [
    pytest.param(e, c, None, id=f"{e}-{c}") for e in sorted(ENGINES)
    for c in LANDING if not (e == "resident" and LANDING[c][2])
] + [                                               # cc is host-staged
    pytest.param(e, c, t, id=f"{e}-{c}-{t}")
    for e, c in (("resident", "u16-double"), ("host_staged", "u16-double"),
                 ("host_staged", "f32-uint16"),
                 ("host_staged", "u16-double-cc"))
    for t in ("ahead", "behind")])
def test_downloads_land_in_the_returned_arrays(monkeypatch, engine, case,
                                               toucher):
    """Also with the page toucher on, through both flow sources (the
    resident engine's shards, the host-staged engine's ``process_batch``),
    landed and written: bit-equal; frames all prefaulted where it ran
    ahead."""
    src, name, kw, lands = LANDING[case]
    reg0, w0 = _copied(src, name, ENGINES[engine], **kw)
    writers = _recorded_writers(monkeypatch)
    _prefaulting(monkeypatch, toucher)
    before = write_totals()
    reg, w = compensate_arr_3D(_recording(src), _reference(src),
                               _small_options(output_typename=name, **kw),
                               config=ENGINES[engine], device="cpu")
    after = write_totals()
    assert reg.dtype == reg0.dtype == _DTYPE_MAP[name]
    np.testing.assert_array_equal(reg, reg0)
    np.testing.assert_array_equal(w, w0)
    n = 5 if lands else 0
    assert [(x.frames_in_place, x.frames_landed) for x in writers] == \
        [(5, n), (5, 5)]
    assert (after["landed"] - before["landed"],
            after["copied"] - before["copied"]) == (5 + n, 5 - n)
    prefaulted = after["prefaulted"] - before["prefaulted"]
    if toucher == "ahead":
        assert prefaulted == 10
    elif toucher is None:       # arrays of one chunk or less: no toucher
        assert prefaulted == 0
    else:
        assert 0 <= prefaulted <= 10
    assert _touchers() == []


@pytest.mark.parametrize("toucher", [None, "ahead", "behind"])
def test_shards_land_at_their_frames(monkeypatch, toucher):
    """The mesh executor over two devices: each batch's shards (one frame
    each) download into their own frames of the writers' arrays, the
    first shard of a batch claiming the whole batch; bit-equal with the
    page toucher on."""
    mesh = RegistrationConfig(parallelization="mesh", devices=["cpu"] * 2)
    reg0, w0 = _copied(np.uint16, "double", mesh)
    writers = _recorded_writers(monkeypatch)
    _prefaulting(monkeypatch, toucher)
    downloads, claims = [], []
    download = HostStaging.download

    def recorded(self, tensors, outs=None, claim=None):
        outs = download(self, tensors, outs, claim)
        downloads.append(outs)
        claims.append(claim is not None)
        return outs

    monkeypatch.setattr(HostStaging, "download", recorded)
    before = write_totals()
    reg, w = compensate_arr_3D(_recording(np.uint16), _reference(np.uint16),
                               _small_options(), config=mesh, device="cpu")
    prefaulted = write_totals()["prefaulted"] - before["prefaulted"]
    np.testing.assert_array_equal(reg, reg0)
    np.testing.assert_array_equal(w, w0)
    assert len(downloads) == 5      # batches of 2, 2 and 1 frames
    assert claims == [True, False, True, False, True]
    assert prefaulted == {None: 0, "ahead": 10}.get(toucher, prefaulted)
    assert _touchers() == []

    def frame_of(out, array):
        assert np.shares_memory(out, array)
        return (out.ctypes.data - array.ctypes.data) // array[0].nbytes

    for i, writer in ((0, writers[0]), (-1, writers[1])):
        assert writer.frames_landed == 5
        assert [frame_of(d[i], writer.get_array())
                for d in downloads] == [0, 1, 2, 3, 4]


def test_file_and_async_writers_take_batches_by_copy(tmp_path):
    movie, ref = _recording(np.uint16), _reference(np.uint16)
    before = write_totals()
    compensate_recording(_small_options().replace(
        input_file=movie, reference_frames=ref, output_path=tmp_path,
        output_format=OutputFormat.TIFF, save_w=False), device="cpu")
    assert write_totals() == before
    frames = ArrayWriter3D(frame_count=5, dtype=np.float64)
    opts = _small_options().replace(
        input_file=movie, reference_frames=ref, save_w=True,
        output_format=OutputFormat.ARRAY, save_meta_info=False)
    opts._video_writer = AsyncWriter3D(frames)
    corr = BatchMotionCorrector(opts, device="cpu")
    corr.run()
    assert (frames.frames_in_place, frames.frames_landed) == (5, 0)
    assert corr.w_writer.frames_landed == 5
    reg0, w0 = _copied(np.uint16, "double", None)
    np.testing.assert_array_equal(frames.get_array(), reg0)
    np.testing.assert_array_equal(corr.w_writer.get_array(), w0)
