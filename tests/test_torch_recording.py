"""Port parity: the file-based pipeline, ``compensate_recording``, against the
JAX package's on the CPU, on a TIFF of the pipeline fixture's recording
(tests/pipeline/conftest.py: T=4, (10,20,24,1), float32).

- Both packages register the same TIFF with ``fast_options(a_smooth=0.5)``,
  one batch and two batches: the registered TIFF within 1e-4 wherever the
  two valid masks agree, ``w.h5`` within 1e-3, ``statistics.npz`` within
  1e-3, ``reference_frame.npy`` equal, ``valid_idx.npy`` each package's
  mask's per-frame ``all``. The masks may disagree only where a sample
  coordinate lies within 1e-3 of the volume's edge (a flow of ~1e-5 on the
  edge rounds either way; ROADMAP.md Queue 3), on at most 0.1% of the
  voxels.
- A run interrupted after its first batch and resumed gives the
  uninterrupted run's frames, flows and statistics bit for bit, on both
  engines; the checkpoint is gone afterwards.
- The async writer never holds a view of the download staging buffers.
- Options files cross between the packages; the writer each format and
  naming convention gets is the JAX package's.
- Without h5py, the flow and mask writers warn and are skipped, and HDF5
  output raises an ImportError that names h5py.
- A u16 two-channel TIFF at the TIFF recording deployment's I/O options
  (TIFF out, the reference the mean of frames 0-19 by index, ``save_w``
  off, the metadata files on), two batches: the same files as the JAX
  package's, the reference equal (and the float64 mean of the frames it
  names), ``statistics.npz`` within 1e-3, the registered frames within one
  count (the float values agree within the float test's tolerance, so a
  value near a half rounds either way) on at most 1% of the voxels.
"""

import sys
import warnings

import numpy as np
import pytest
import torch

from flowreg3d_tpu.io.factory import get_video_file_reader as jax_reader
from flowreg3d_tpu.pipeline import OFOptions as JaxOFOptions
from flowreg3d_tpu.pipeline import RegistrationConfig as JaxConfig
from flowreg3d_tpu.pipeline import compensate_recording as jax_recording

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.io.async_writer import AsyncWriter3D
from flowreg3d_tpu_torch.io.factory import get_video_file_reader
from flowreg3d_tpu_torch.io.tiff3d import TIFFFileWriter3D
from flowreg3d_tpu_torch.pipeline import (BatchMotionCorrector, OFOptions,
                                          OutputFormat, RegistrationConfig,
                                          compensate_recording)

# the JAX pipeline tests' fixtures, shared so both packages see one case
from tests.pipeline.conftest import (base_volume, fast_options,  # noqa: F401
                                     video5d)

torch.set_num_threads(1)

JAX_CONFIG = JaxConfig(parallelization="sequential", device_resident=False)
ENGINES = {"resident": RegistrationConfig(),
           "host-staged": RegistrationConfig(device_resident=False)}


@pytest.fixture
def recording(tmp_path, video5d):
    path = tmp_path / "rec.tif"
    w = TIFFFileWriter3D(str(path))
    w.write_frames(video5d)
    w.close()
    return path


def _opts(recording, out, reference, **kw):
    kw.setdefault("output_format", "TIFF")
    return fast_options(a_smooth=0.5, input_file=str(recording),
                        output_path=out, reference_frames=reference, **kw)


def _read(path):
    r = get_video_file_reader(str(path))
    data = r[:]
    r.close()
    return data


def _near_edge(flows, tol=1e-3):
    """(T,Z,Y,X) bool: some sample coordinate lies within ``tol`` of the
    volume's edge (0 or n along its axis)."""
    T, Z, Y, X, _ = flows.shape
    near = np.zeros(flows.shape[:4], bool)
    for axis, n, grid in ((0, X, np.arange(X)[None, None, None, :]),
                          (1, Y, np.arange(Y)[None, None, :, None]),
                          (2, Z, np.arange(Z)[None, :, None, None])):
        c = grid + flows[..., axis]
        near |= (np.abs(c) < tol) | (np.abs(c - n) < tol)
    return near


@pytest.mark.parametrize("buffer_size", [10, 2])
def test_compensate_recording_matches_jax(tmp_path, recording, base_volume,
                                          buffer_size):
    kw = dict(buffer_size=buffer_size, save_w=True, save_valid_idx=True,
              save_valid_mask=True)
    jax_recording(_opts(recording, tmp_path / "jax", base_volume, **kw),
                  config=JAX_CONFIG)
    compensate_recording(options_from_jax(
        _opts(recording, tmp_path / "torch", base_volume, **kw)),
        device="cpu")
    got, want = tmp_path / "torch", tmp_path / "jax"
    assert sorted(p.name for p in got.iterdir()) == \
        sorted(p.name for p in want.iterdir()) == \
        ["compensated.TIFF", "reference_frame.npy", "statistics.npz",
         "valid_idx.npy", "valid_mask.h5", "w.h5"]

    reg, reg_j = _read(got / "compensated.TIFF"), _read(
        want / "compensated.TIFF")
    w, w_j = _read(got / "w.h5"), _read(want / "w.h5")
    mask, mask_j = _read(got / "valid_mask.h5"), _read(want / "valid_mask.h5")
    assert reg.shape == reg_j.shape and reg.dtype == reg_j.dtype == np.float32
    assert w.shape == w_j.shape == reg.shape[:4] + (3,)
    np.testing.assert_allclose(w, w_j, rtol=0, atol=1e-3)
    flipped = mask != mask_j
    assert flipped.mean() <= 1e-3
    assert _near_edge(w)[flipped[..., 0]].all()
    np.testing.assert_allclose(reg[~flipped], reg_j[~flipped], rtol=0,
                               atol=1e-4)

    stats, stats_j = np.load(got / "statistics.npz"), np.load(
        want / "statistics.npz")
    assert sorted(stats) == sorted(stats_j)
    for key in stats_j:
        np.testing.assert_allclose(stats[key], stats_j[key], rtol=0,
                                   atol=1e-3, err_msg=key)
    np.testing.assert_array_equal(np.load(got / "reference_frame.npy"),
                                  np.load(want / "reference_frame.npy"))
    for d, m in ((got, mask), (want, mask_j)):
        np.testing.assert_array_equal(np.load(d / "valid_idx.npy"),
                                      m.all(axis=(1, 2, 3, 4)))


def _interrupted(options, config):
    """Run until the first checkpoint is written, then interrupt."""
    save = BatchMotionCorrector._save_checkpoint

    def boom(self, frames_done):
        save(self, frames_done)
        raise KeyboardInterrupt

    BatchMotionCorrector._save_checkpoint = boom
    try:
        with pytest.raises(KeyboardInterrupt):
            BatchMotionCorrector(options, config, device="cpu").run()
    finally:
        BatchMotionCorrector._save_checkpoint = save


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_resume_is_bit_equal(tmp_path, recording, base_volume, engine):
    cfg = RegistrationConfig(checkpoint=True,
                             device_resident=ENGINES[engine].device_resident)

    def opts(out):
        return options_from_jax(_opts(
            recording, tmp_path / out, base_volume, buffer_size=2,
            save_w=True, save_valid_idx=True))

    compensate_recording(opts("full"), config=cfg, device="cpu")
    assert not (tmp_path / "full" / "checkpoint.npz").exists()
    _interrupted(opts("resumed"), cfg)
    ckpt = tmp_path / "resumed" / "checkpoint.npz"
    with np.load(ckpt) as c:
        assert int(c["frames_done"]) == 2 and c["w_init"].shape == \
            base_volume.shape[:3] + (3,)
    corr = BatchMotionCorrector(opts("resumed"), cfg, device="cpu")
    corr.run()
    assert corr.used_device_resident == (engine == "resident")
    assert not ckpt.exists()

    full, resumed = tmp_path / "full", tmp_path / "resumed"
    # the resumed output file holds the frames after the checkpoint
    np.testing.assert_array_equal(_read(resumed / "compensated.TIFF"),
                                  _read(full / "compensated.TIFF")[2:])
    np.testing.assert_array_equal(_read(resumed / "w.h5"),
                                  _read(full / "w.h5")[2:])
    s_full, s_res = np.load(full / "statistics.npz"), np.load(
        resumed / "statistics.npz")
    for key in s_full:
        assert s_res[key].shape == (4,)
        np.testing.assert_array_equal(s_res[key], s_full[key], err_msg=key)
    np.testing.assert_array_equal(np.load(resumed / "valid_idx.npy"),
                                  np.load(full / "valid_idx.npy"))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_async_writer_never_holds_staging_memory(tmp_path, recording,
                                                 base_volume, engine,
                                                 monkeypatch):
    corr = BatchMotionCorrector(options_from_jax(_opts(
        recording, tmp_path / "async", base_volume, buffer_size=1)),
        ENGINES[engine], device="cpu")
    queued = []
    write = AsyncWriter3D.write_frames

    def spy(self, frames):
        buffers = [b.numpy() for b in corr._staging.buffers]
        assert buffers and not any(np.shares_memory(frames, b)
                                   for b in buffers)
        queued.append(frames)
        return write(self, frames)

    monkeypatch.setattr(AsyncWriter3D, "write_frames", spy)
    corr.run()
    assert len(queued) == 4
    assert len({id(q) for q in queued}) == 4
    monkeypatch.setattr(AsyncWriter3D, "write_frames", write)
    cfg = RegistrationConfig(async_write=False, prefetch=0,
                             device_resident=ENGINES[engine].device_resident)
    compensate_recording(options_from_jax(_opts(
        recording, tmp_path / "sync", base_volume, buffer_size=1)),
        config=cfg, device="cpu")
    np.testing.assert_array_equal(
        _read(tmp_path / "async" / "compensated.TIFF"),
        _read(tmp_path / "sync" / "compensated.TIFF"))


def _field_values(o):
    names = [n for n in OFOptions.__dataclass_fields__
             if not n.startswith("_") and n not in ("preproc_funct",
                                                    "input_file")]
    out = {}
    for n in names:
        v = getattr(o, n)
        out[n] = v.value if hasattr(v, "value") else v
    return out


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_options_files_cross_packages(tmp_path, base_volume, saver):
    kw = dict(alpha=(1.0, 2.0, 3.0), weight=[0.3, 0.7], levels=7,
              min_level=2, quality_setting="fast", eta=0.6, iterations=9,
              sigma=[[1.0, 2.0, 1.5, 0.2], [0.5, 0.5, 0.5, 0.1]],
              reference_frames=base_volume, output_format="HDF5",
              naming_convention="batch", constancy="gray", cc_hw=(16, 24),
              channel_idx=[0], output_path=str(tmp_path / saver))
    jax_opts = JaxOFOptions(**kw)
    opts = options_from_jax(jax_opts)
    (jax_opts if saver == "jax" else opts).save_options()
    path = tmp_path / saver / "options.json"
    assert path.read_text().startswith("Compensation options ")
    loaded = OFOptions.load_options(path)
    loaded_j = JaxOFOptions.load_options(path)
    want = _field_values(jax_opts)
    for got in (_field_values(loaded), _field_values(loaded_j)):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert type(got[k]) is type(want[k]) or isinstance(
                want[k], np.ndarray), k
    # both packages write the same file for the same options
    other = tmp_path / "other" / "options.json"
    (opts if saver == "jax" else jax_opts).save_options(other)
    def text(f):        # the directories of the two files named alike
        return f.read_text().replace(str(other.parent), "DIR").replace(
            str(path.parent), "DIR")

    assert text(other) == text(path)
    np.testing.assert_array_equal(loaded.reference_frames, base_volume)


@pytest.mark.parametrize("fmt", [f for f in OutputFormat
                                 if f != OutputFormat.ARRAY])
@pytest.mark.parametrize("naming", ["default", "batch"])
def test_video_writer_naming_matches_jax(tmp_path, recording, fmt, naming):
    def writer(options_cls, tag):
        o = options_cls(input_file=str(recording), output_format=fmt.value,
                        naming_convention=naming,
                        output_path=tmp_path / tag)
        w = o.get_video_writer()
        fields = {k: getattr(w, k, None) for k in (
            "file_path", "file_type", "dataset_names", "dimension_ordering",
            "version")}
        fields["file_path"] = fields["file_path"].replace(
            str(tmp_path / tag), "OUT")
        return type(w).__name__, fields

    assert writer(OFOptions, "port") == writer(JaxOFOptions, "jax")


def test_without_h5py_flow_and_mask_writers_warn(tmp_path, recording,
                                                 base_volume, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    opts = options_from_jax(_opts(recording, tmp_path / "out", base_volume,
                                  save_w=True, save_valid_mask=True))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        compensate_recording(opts, device="cpu")
    text = " ".join(str(w.message) for w in caught)
    assert "displacement writer" in text and "valid-mask writer" in text
    assert "h5py" in text
    out = tmp_path / "out"
    assert sorted(p.name for p in out.iterdir()) == [
        "compensated.TIFF", "reference_frame.npy", "statistics.npz"]
    assert _read(out / "compensated.TIFF").shape == (4, 10, 20, 24, 1)
    with pytest.raises(ImportError, match="h5py"):
        compensate_recording(options_from_jax(_opts(
            recording, tmp_path / "h5", base_volume,
            output_format="HDF5")), device="cpu")


def test_u16_recording_written_in_its_dtype(tmp_path, video5d, base_volume):
    """A u16 recording comes out as u16 from both engines, equal, and read
    back equal to the in-memory pipeline's frames."""
    from flowreg3d_tpu_torch.pipeline import compensate_arr

    frames = np.rint(video5d * 1000).astype(np.uint16)
    src = tmp_path / "u16.tif"
    w = TIFFFileWriter3D(str(src))
    w.write_frames(frames)
    w.close()
    ref = base_volume * 1000.0
    outs = []
    for engine, cfg in sorted(ENGINES.items()):
        compensate_recording(options_from_jax(_opts(
            src, tmp_path / engine, ref)), config=cfg, device="cpu")
        outs.append(_read(tmp_path / engine / "compensated.TIFF"))
    assert outs[0].dtype == outs[1].dtype == np.uint16
    np.testing.assert_array_equal(outs[0], outs[1])
    reg, _ = compensate_arr(frames, ref, options=options_from_jax(
        fast_options(a_smooth=0.5)), device="cpu")
    np.testing.assert_array_equal(outs[0], reg.astype(np.uint16))
    assert np.array_equal(jax_reader(str(src))[:], frames)


def test_u16_two_channel_file_deployment_matches_jax(tmp_path, video5d):
    frames = np.rint(np.concatenate([video5d * 30000 + 1000,
                                     (1 - video5d) * 20000], axis=-1)
                     ).astype(np.uint16)
    src = tmp_path / "rec.tif"
    w = TIFFFileWriter3D(str(src))
    w.write_frames(frames)
    w.close()

    def opts(out):
        return fast_options(
            a_smooth=0.5, input_file=str(src), output_path=out,
            output_format="TIFF", reference_frames=list(range(20)),
            save_w=False, save_meta_info=True, buffer_size=2,
            weight=[0.5, 0.5], sigma=[[1.0, 1.0, 1.0, 0.1]] * 2)

    jax_recording(opts(tmp_path / "jax"), config=JAX_CONFIG)
    ref = compensate_recording(options_from_jax(opts(tmp_path / "torch")),
                               device="cpu")
    got, want = tmp_path / "torch", tmp_path / "jax"
    assert sorted(p.name for p in got.iterdir()) == \
        sorted(p.name for p in want.iterdir()) == \
        ["compensated.TIFF", "reference_frame.npy", "statistics.npz"]
    np.testing.assert_array_equal(ref, frames.astype(np.float64).mean(0))
    np.testing.assert_array_equal(np.load(got / "reference_frame.npy"),
                                  np.load(want / "reference_frame.npy"))
    stats, stats_j = np.load(got / "statistics.npz"), np.load(
        want / "statistics.npz")
    for key in stats_j:
        np.testing.assert_allclose(stats[key], stats_j[key], rtol=0,
                                   atol=1e-3, err_msg=key)
    reg, reg_j = _read(got / "compensated.TIFF"), _read(
        want / "compensated.TIFF")
    assert reg.dtype == reg_j.dtype == np.uint16
    assert reg.shape == reg_j.shape == frames.shape
    diff = np.abs(reg.astype(np.int64) - reg_j.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
