"""The port's CUDA-graph and device-resident paths on a card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch; there, from the root of a checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX.) Held: the batched
executor's CUDA-graph replay against the eager sequential executor, bit for
bit, at a_smooth 1 and 0.5; a capture that meets a host sync raises instead
of running eagerly; the resident pipeline on u16 input against the
host-staged one, bit for bit; the download staging page-locked and
reused; one Z-sharded frame over two shards of the one card
([cuda:0, cuda:0]), the slab kernels against their plain versions, bit for
bit, with each slab kernel launched; the psi tick block
(sor_iterations_psi_f32) in both modes against its plain loop, bit for bit,
for odd and even counts, its plan by size, and its replay in a CUDA graph.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from flowreg3d_tpu_torch.core import solver_psi_kernel as spk
from flowreg3d_tpu_torch.core.pyramid import level_schedule
from flowreg3d_tpu_torch.parallel import executors as tex
from flowreg3d_tpu_torch.pipeline import (OFOptions, RegistrationConfig,
                                          compensate_arr)
from flowreg3d_tpu_torch.pipeline.device_pipeline import HostStaging

pytestmark = pytest.mark.cuda

FLOW = dict(alpha=(1.5, 1.5, 1.5), iterations=8, levels=4, min_level=0,
            update_lag=4, eta=0.8, a_data=0.45)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA-graph path runs only there")
    return torch.device("cuda")


def _frames(T=4, C=2, shape=(10, 20, 24)):
    rng = np.random.default_rng(0)
    ref = gaussian_filter(rng.random(shape + (C,)), (1.5, 2, 2, 0))
    video = np.stack([np.roll(ref, (0, s, -s, 0), axis=(0, 1, 2, 3))
                      for s in range(T)])
    return video.astype(np.float32), ref.astype(np.float32)


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_graph_replay_equals_sequential(card, a_smooth):
    video, ref = _frames()
    fp = dict(FLOW, a_smooth=a_smooth, weight=[0.5, 0.5])
    w_init = np.full(ref.shape[:3] + (3,), 0.25, np.float32)
    seq = tex.SequentialExecutor3D().process_batch(
        video, video, ref, ref, w_init, "cubic", None, fp)
    tex.clear_frame_graphs()
    bat = tex.BatchedExecutor3D().process_batch(
        video, video, ref, ref, w_init, "cubic", None, fp)
    graphs = tex.frame_graphs()
    assert len(graphs) == 1 and graphs[0].replays == video.shape[0]
    plan, _, _ = level_schedule(ref.shape[:3], FLOW["eta"], FLOW["levels"],
                                FLOW["min_level"])
    # one sampling launch a channel: every level's warp and the output warp
    assert graphs[0].launches["map_coords_f32"] == (len(plan) + 1) * 2
    for a, b in zip(seq, bat):
        assert a.device.type == "cuda" and torch.equal(a, b)
    tex.clear_frame_graphs()


def test_capture_with_host_sync_raises(card, monkeypatch):
    from flowreg3d_tpu_torch.core import pyramid as tpyr

    video, ref = _frames(T=2, C=1)
    real = tpyr.resize_volume

    def syncing_resize(vol, *args, **kwargs):
        vol.sum().item()
        return real(vol, *args, **kwargs)

    monkeypatch.setattr(tpyr, "resize_volume", syncing_resize)
    tex.clear_frame_graphs()
    with pytest.raises(RuntimeError):
        tex.BatchedExecutor3D().process_batch(
            video, video, ref, ref, np.zeros(ref.shape[:3] + (3,)), "cubic",
            None, dict(FLOW, a_smooth=1.0))
    tex.clear_frame_graphs()


def test_resident_u16_equals_host_staged(card):
    video, ref = _frames(T=5, C=1)
    video = (video * 10000).astype(np.uint16)
    opts = OFOptions(**FLOW, a_smooth=1.0, weight=[1.0], buffer_size=3,
                     output_typename=None)
    out = {}
    for tag, cfg in (("resident", RegistrationConfig()),
                     ("staged", RegistrationConfig(
                         parallelization="sequential",
                         device_resident=False))):
        out[tag] = compensate_arr(video, ref * 10000, opts, config=cfg)
    assert out["resident"][0].dtype == np.uint16
    for a, b in zip(out["resident"], out["staged"]):
        np.testing.assert_array_equal(a, b)


def test_staging_pinned_and_reused(card):
    staging = HostStaging(pinned=True)
    gen = torch.Generator(device=card).manual_seed(0)
    ptrs = []
    for T in (3, 2):
        x = torch.rand((T, 8, 16, 16), generator=gen, device=card)
        m = x > 0.5
        got = staging.download([x, m])
        np.testing.assert_array_equal(got[0], x.cpu().numpy())
        np.testing.assert_array_equal(got[1], m.cpu().numpy())
        assert all(b.is_pinned() for b in staging.buffers)
        ptrs.append([b.data_ptr() for b in staging.buffers])
    assert ptrs[0] == ptrs[1]


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_spatial_frame_kernels_equal_plain(card, a_smooth):
    from flowreg3d_tpu_torch import _ext
    from flowreg3d_tpu_torch.parallel.spatial_pyramid import (
        get_displacement_sharded)

    video, ref = _frames(T=1, C=1, shape=(24, 32, 36))
    fp = dict(FLOW, a_smooth=a_smooth)
    counters = _ext.launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    out = {uk: get_displacement_sharded(ref, video[0], devices=[card] * 2,
                                        use_kernels=uk, **fp)
           for uk in (True, False)}
    launched = {k for k, f in counters.items() if f.launches > before[k]}
    slab = ({"sor_halfsweep_const_f32"} if a_smooth == 1.0
            else {"psi_field_f32", "sor_halfsweep_psi_f32"})
    assert slab | {"map_coords_f32", "median5_f32"} <= launched
    assert bool(out[True][1]) and bool(out[False][1])
    assert torch.equal(out[True][0], out[False][0])


def _tick_fields(card, shape, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    duvw = 0.1 * torch.randn((3,) + shape, generator=gen, device=card)
    base = 2.0 * torch.rand((3,) + shape, generator=gen, device=card)
    sj = 0.1 * torch.rand((9,) + shape, generator=gen, device=card)
    sj[:3] += 0.5
    return duvw, base, sj


TICK_PARAMS = spk.psi_params(0.5, 1.0, 1.25, 1.5) + (0.7, 0.9, 1.3)


@pytest.mark.parametrize("mode", ["phases in turn", "streamed"])
@pytest.mark.parametrize("n_iters", [1, 2, 9])
def test_psi_tick_block_equals_plain(card, mode, n_iters):
    duvw, base, sj = _tick_fields(card, (13, 37, 45))
    before = spk.sor_iterations_psi.launches
    got = spk.sor_iterations_psi(duvw.clone(), base, sj, TICK_PARAMS,
                                 n_iters, mode=mode)
    want = spk.sor_iterations_psi_plain(duvw.clone(), base, sj, TICK_PARAMS,
                                        n_iters)
    assert torch.equal(got, want)
    assert torch.equal(got[:, 0], duvw[:, 0])
    assert spk.sor_iterations_psi.launches == before + 1


def test_psi_tick_block_plan_and_graph(card):
    assert spk.psi_tick_plan((13, 37, 45))["mode"] == "phases in turn"
    assert spk.psi_tick_plan((27, 514, 514))["mode"] == "streamed"
    for shape in ((13, 37, 45), (27, 514, 514)):
        duvw, base, sj = _tick_fields(card, shape, seed=1)
        scratch = torch.empty_like(duvw)
        a = duvw.clone()
        spk.sor_iterations_psi(a, base, sj, TICK_PARAMS, 3, scratch)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            spk.sor_iterations_psi(a, base, sj, TICK_PARAMS, 3, scratch)
        a.copy_(duvw)
        graph.replay()
        want = spk.sor_iterations_psi_plain(duvw.clone(), base, sj,
                                            TICK_PARAMS, 3)
        assert torch.equal(a, want)
