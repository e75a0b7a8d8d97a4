"""Port parity: the pipeline's batch step
(``flowreg3d_tpu_torch.pipeline.device_pipeline``) with its flows from the
executor's shards against the same step with its flows from
``process_batch`` (``device_resident=False``) and against the JAX package's
resident engine, on the CPU. Every route (the default, ``process_batch``,
cc, a flow backend, the spatial executor) runs one ``run_batch`` a batch,
and the default's two flow sources give the same bits.

The movie of tests/pipeline/test_device_resident.py (T=5, (8,24,24), u16)
with that file's options (buffer 3: two batches, the w_init chained
between them), in memory. Bounds of tests/pipeline/test_device_resident.py:
registered max |diff| / max < 5e-3 with > 95% of the voxels equal,
statistics within rtol 5e-2 and atol 5e-3; valid-frame flags and valid
masks exactly. Also: reference updating on float32 and u16 input, the
step's own outputs (masks, flows only when asked for), downloads
through one reused staging buffer per output from both flow sources (the
results handed out share no memory with it), and
``device_resident=True`` raising where the configuration's flows come from
``process_batch``; ``resident_supported`` against the JAX rule; and
``profile_dir`` writing a Chrome trace without changing the results.
"""

import json

import numpy as np
import pytest
import torch

from flowreg3d_tpu.pipeline.corrector import \
    BatchMotionCorrector as JaxCorrector
from flowreg3d_tpu.pipeline.corrector import \
    RegistrationConfig as JaxConfig
from flowreg3d_tpu.pipeline.of_options import OFOptions as JaxOptions

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.pipeline import (BatchMotionCorrector,
                                          RegistrationConfig)
from flowreg3d_tpu_torch.pipeline.device_pipeline import (
    HostStaging, ResidentPipeline, resident_supported, valid_mask)

from tests.pipeline.test_device_resident import _make_movie

torch.set_num_threads(1)

STATS = ("mean_disp", "max_disp", "mean_div", "mean_translation")


def _options(movie, **kw):
    opts = dict(input_file=movie, output_format="ARRAY",
                quality_setting="fast", alpha=(1.5, 1.5, 1.5), iterations=8,
                levels=8, min_level=2, buffer_size=3, save_w=True,
                save_meta_info=False, save_valid_idx=True,
                reference_frames=[0, 1])
    opts.update(kw)
    return JaxOptions(**opts)


def _port(movie, config=None, **kw):
    corr = BatchMotionCorrector(options_from_jax(_options(movie, **kw)),
                                config, device="cpu")
    corr.run()
    return corr


def _jax(movie, **kw):
    corr = JaxCorrector(_options(movie, **kw), JaxConfig(
        parallelization="sequential", prefetch=0, async_write=False))
    corr.run()
    assert corr.used_device_resident
    return corr


# the batch step with its flows from the sequential executor's process_batch
HOST_STAGED = RegistrationConfig(parallelization="sequential",
                                 device_resident=False)


def _outputs(corr):
    return (corr.video_writer.get_array(), corr.w_writer.get_array(),
            {k: np.asarray(getattr(corr, k)) for k in STATS},
            np.asarray(corr.valid_idx, bool))


def _assert_close(a, b):
    reg_a, w_a, stats_a, valid_a = _outputs(a)
    reg_b, w_b, stats_b, valid_b = _outputs(b)
    assert reg_a.shape == reg_b.shape and reg_a.dtype == reg_b.dtype
    ra, rb = reg_a.astype(np.float64), reg_b.astype(np.float64)
    scale = float(np.abs(rb).max()) or 1.0
    assert np.max(np.abs(ra - rb)) / scale < 5e-3
    assert np.mean(ra == rb) > 0.95
    for k in STATS:
        assert stats_a[k].shape == stats_b[k].shape
        np.testing.assert_allclose(stats_a[k], stats_b[k], rtol=5e-2,
                                   atol=5e-3)
    np.testing.assert_array_equal(valid_a, valid_b)
    return w_a, w_b


@pytest.fixture(scope="module")
def movie():
    return _make_movie(np.random.default_rng(7))[..., None]


@pytest.fixture(scope="module")
def resident(movie):
    corr = _port(movie)
    assert corr.used_device_resident
    assert corr.executor.name == "batched"
    return corr


def test_resident_matches_host_staged(movie, resident):
    staged = _port(movie, HOST_STAGED)
    assert not staged.used_device_resident
    w_r, w_s = _assert_close(resident, staged)
    np.testing.assert_allclose(w_r, w_s, rtol=5e-2, atol=5e-3)


def test_resident_matches_jax_resident(movie, resident):
    want = _jax(movie)
    w, w_j = _assert_close(resident, want)
    np.testing.assert_allclose(w, w_j, rtol=5e-2, atol=5e-3)
    assert len(resident.valid_idx) == movie.shape[0]


def test_valid_mask_matches_jax(resident):
    flows = resident.w_writer.get_array().copy()   # the fixture's stays
    flows[1, :2, :3, :4, 0] -= 40.0          # push a corner out of bounds
    want = JaxCorrector._valid_mask(flows)
    got = valid_mask(torch.from_numpy(flows)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want[1, :2, :3, :4].any()


# (options, config) of each route a batch takes to ``run_batch``
ROUTES = {
    "default": ({}, None),
    "process_batch": ({}, RegistrationConfig(device_resident=False)),
    "cc": (dict(cc_initialization=True, cc_hw=16), None),
    "flow_backend": ({}, RegistrationConfig(flow_backend="volraft-mock")),
    "spatial": ({}, RegistrationConfig(parallelization="spatial",
                                       devices=["cpu"] * 2)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_runs_one_batch_step(movie, resident, monkeypatch,
                                         route):
    """One ``run_batch`` a batch (buffer 3 over T=5) on every route, its
    flows from the executor's shards exactly where ``resident_supported``
    allows them; the default configuration's two flow sources give the
    same bits. The numbers of the cc, backend and spatial routes are held
    against JAX in their own files."""
    kw, config = ROUTES[route]
    batches = []
    run_batch = ResidentPipeline.run_batch

    def spied(self, batch, **kwargs):
        batches.append(batch.shape[0])
        return run_batch(self, batch, **kwargs)

    monkeypatch.setattr(ResidentPipeline, "run_batch", spied)
    corr = _port(movie, config, **kw)
    assert batches == [3, 2]
    assert corr.used_device_resident == resident_supported(
        corr.options, corr.config, corr.executor)
    assert corr.used_device_resident == (route == "default")
    if route in ("default", "process_batch"):
        for a, b in zip(_outputs(corr), _outputs(resident)):
            if isinstance(a, dict):
                for k in STATS:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_engine_outputs_and_flows_on_request(movie):
    opts = options_from_jax(_options(movie))
    corr = BatchMotionCorrector(opts, device="cpu")
    corr._setup_io()
    corr._setup_reference()
    corr._setup_resident()
    engine = corr._resident
    assert isinstance(engine, ResidentPipeline)
    assert not engine.staging.pinned
    out = engine.run_batch(movie[:3], want_mask=True, keep_flows_host=True)
    assert out["registered"].dtype == movie.dtype
    assert out["stats"].shape == (3, 4) and out["valid"].shape == (3,)
    mask = valid_mask(torch.from_numpy(out["flows"])).numpy()
    np.testing.assert_array_equal(out["masks"], mask.astype(np.uint8))
    np.testing.assert_array_equal(out["valid"], mask.all(axis=(1, 2, 3)))
    assert out["initial_w"] is not None
    again = engine.run_batch(movie[:3], w_init=out["w_init"])
    assert again["flows"] is None and again["masks"] is None
    assert again["initial_w"] is None


@pytest.mark.parametrize("config", [None, HOST_STAGED],
                         ids=["resident", "host-staged"])
def test_downloads_reuse_one_staging_buffer(movie, monkeypatch, config):
    """Two batches (buffer 3 over T=5) download through the same buffers;
    nothing handed out is a view of them, so the host memory they hold stays
    one batch's whatever the recording's length."""
    seen = []
    download = HostStaging.download

    def recorded(self, tensors, outs=None, claim=None):
        outs = download(self, tensors, outs, claim)
        seen.append(([b.data_ptr() for b in self.buffers], outs,
                     [b.numpy() for b in self.buffers]))
        return outs

    monkeypatch.setattr(HostStaging, "download", recorded)
    corr = _port(movie, config)
    assert corr.used_device_resident == (config is None)
    assert len(seen) == 2
    assert seen[0][0] == seen[1][0]
    for _, outs, buffers in seen:
        assert len(outs) == len(buffers) == 4    # frames, stats, valid, flows
        assert not any(np.may_share_memory(o, b) for o in outs
                       for b in buffers)
    np.testing.assert_array_equal(corr.w_writer.get_array()[:3],
                                  seen[0][1][3])


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_update_reference_resident_matches_host_staged(dtype):
    movie = _make_movie(np.random.default_rng(3), dtype=dtype)[..., None]
    res = _port(movie, update_reference=True, min_level=1)
    staged = _port(movie, HOST_STAGED, update_reference=True, min_level=1)
    assert res.used_device_resident and not staged.used_device_resident
    assert res.video_writer.get_array().dtype == dtype
    _assert_close(res, staged)
    torch.testing.assert_close(res.reference_proc, staged.reference_proc,
                               rtol=1e-5, atol=1e-6)


def test_device_resident_true_raises_when_unsupported(movie):
    config = RegistrationConfig(device_resident=True)
    for kw in (dict(preproc_funct=lambda x: x),
               dict(cc_initialization=True)):
        with pytest.raises(ValueError, match="device_resident"):
            _port(movie, config, **kw)


@pytest.mark.parametrize("case", [
    dict(), dict(device_resident=False), dict(device_resident=True),
    dict(preproc_funct=True), dict(cc_initialization=True),
    dict(flow_backend="volraft"), dict(executor="sequential")])
def test_resident_supported_matches_jax(movie, case):
    from flowreg3d_tpu.pipeline.device_pipeline import \
        resident_supported as jax_supported

    case = dict(case)
    executor = type("Executor", (), {"name": case.pop("executor",
                                                      "batched")})()
    config = {k: case.pop(k) for k in ("device_resident", "flow_backend")
              if k in case}
    if case.pop("preproc_funct", False):
        case["preproc_funct"] = np.asarray
    opts = _options(movie, **case)
    assert resident_supported(options_from_jax(opts),
                              RegistrationConfig(**config), executor) == \
        jax_supported(opts, JaxConfig(**config), executor)


def test_profile_dir_writes_a_trace(movie, tmp_path):
    """``profile_dir`` records the run into a Chrome trace and changes none
    of its results."""
    plain = _port(movie[:2])
    traced = _port(movie[:2], RegistrationConfig(profile_dir=str(tmp_path)))
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    for a, b in zip(_outputs(plain)[:2], _outputs(traced)[:2]):
        np.testing.assert_array_equal(a, b)
