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
for odd and even counts, its plan by size, and its replay in a CUDA graph;
``get_displacement``'s graph: a replay bit-equal to the eager pyramid, no
host launch on a warm call, each call's flow the caller's own, ``uvw=None``
after a ``uvw`` starting from zeros, a weight vector and a weight volume,
another configuration replacing the graph; the cc prealignment's graph
bit-equal to the eager ``prealign``, and the cc batch through the batched
executor bit-equal to the sequential one, at both ``use_kernels``; over
[cuda:0, cuda:0], the Z-sharded step's graph bit-equal to the eager sharded
body at both a_smooth, a warm call one replay with no host launch, the
spatial executor one replay a frame bit-equal to the eager body and warp,
and a sharded capture meeting an upload raising; ``compute_flow_level``'s
and ``compute_flow``'s graphs bit-equal to their eager bodies on the card;
a profiled ``compensate_arr`` showing every pipeline span as a host row and
none on the card, and the frame graph's capture tallied once for two calls
of one configuration.
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
        video, video, ref, ref, w_init, flow_params=fp)
    tex.clear_frame_graphs()
    bat = tex.BatchedExecutor3D().process_batch(
        video, video, ref, ref, w_init, flow_params=fp)
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
            video, video, ref, ref, np.zeros(ref.shape[:3] + (3,)),
            flow_params=dict(FLOW, a_smooth=1.0))
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


def _eager_flow(fixed, moving, uvw, weight, **kw):
    """The eager pyramid of ``get_displacement``'s configuration."""
    from flowreg3d_tpu_torch.core import pyramid as tpyr

    key = tpyr.pyramid_config_key(tuple(fixed.shape[:3]), fixed.shape[3],
                                  **kw)
    return tpyr.build_pyramid(*key, device=fixed.device)(fixed, moving, uvw,
                                                         weight)


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_get_displacement_replays_its_graph(card, a_smooth):
    from flowreg3d_tpu_torch import _ext
    from flowreg3d_tpu_torch.core import pyramid as tpyr

    video, ref = _frames(T=2, C=2)
    fixed, moving = (torch.from_numpy(a).to(card) for a in (ref, video[1]))
    kw = dict(FLOW, a_smooth=a_smooth)
    half = torch.full(fixed.shape, 0.5, device=card)
    uvw = torch.full(fixed.shape[:3] + (3,), 0.3, device=card)
    tex.clear_frame_graphs()
    first = tpyr.get_displacement(fixed, moving, uvw=uvw, **kw)
    (graph,) = tpyr.pyramid_graphs()
    assert graph.replays == 1
    assert torch.equal(first, _eager_flow(fixed, moving, uvw, half, **kw))
    # a warm call: one replay, no kernel launched from the host
    kept = first.clone()
    counters = _ext.launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    second = tpyr.get_displacement(fixed, moving, **kw)
    assert {k: f.launches for k, f in counters.items()} == before
    assert graph.replays == 2 and graph.launches["map_coords_f32"] > 0
    # the caller's own tensors: the first is untouched by the second, and
    # uvw=None after a uvw starts from zeros
    assert second.data_ptr() != first.data_ptr()
    assert torch.equal(first, kept)
    assert torch.equal(second, _eager_flow(
        fixed, moving, torch.zeros_like(uvw), half, **kw))
    # a weight vector and the same weights as a volume
    volume = torch.stack([torch.full(fixed.shape[:3], w, device=card)
                          for w in (0.7, 0.3)], dim=-1)
    want = _eager_flow(fixed, moving, torch.zeros_like(uvw), volume, **kw)
    for weight in ([0.7, 0.3], volume):
        assert torch.equal(
            tpyr.get_displacement(fixed, moving, weight=weight, **kw), want)
    assert tpyr.pyramid_graphs() == [graph] and graph.replays == 4
    # another configuration replaces the graph
    other = dict(kw, iterations=4)
    got = tpyr.get_displacement(fixed, moving, **other)
    (graph2,) = tpyr.pyramid_graphs()
    assert graph2 is not graph and graph2.replays == 1
    assert torch.equal(got, _eager_flow(fixed, moving, torch.zeros_like(uvw),
                                        half, **other))
    tex.clear_frame_graphs()
    assert tpyr.pyramid_graphs() == []


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prealign_graph_equals_eager(card, use_kernels):
    video, ref = _frames(T=3, C=2, shape=(12, 40, 36))
    frames, ref_t = (torch.from_numpy(a).to(card) for a in (video, ref))
    w_init = torch.full(ref.shape[:3] + (3,), 0.25, device=card)
    fp = dict(cc_hw=16, cc_up=4, weight=[0.6, 0.4])
    wv = torch.tensor([0.6, 0.4], device=card)
    tex.clear_frame_graphs()
    aligned, combined = tex.BatchedExecutor3D(
        use_kernels=use_kernels)._prealign_frames(frames, ref_t, w_init, fp)
    (graph,) = tex.prealign_graphs()
    assert graph.replays == 3
    for t in range(3):
        a, c = tex.prealign(frames[t], ref_t, w_init, wv, (16, 16), 4,
                            use_kernels)
        assert torch.equal(aligned[t], a) and torch.equal(combined[t], c)
    tex.clear_frame_graphs()


@pytest.mark.parametrize("use_kernels", [True, False])
def test_cc_batch_replay_equals_sequential(card, use_kernels):
    video, ref = _frames(T=3, C=1, shape=(12, 40, 36))
    fp = dict(FLOW, a_smooth=1.0, cc_initialization=True, cc_hw=16, cc_up=4)
    w_init = np.full(ref.shape[:3] + (3,), 0.25, np.float32)
    seq = tex.SequentialExecutor3D(use_kernels=use_kernels).process_batch(
        video, video, ref, ref, w_init, flow_params=fp)
    tex.clear_frame_graphs()
    bat = tex.BatchedExecutor3D(use_kernels=use_kernels).process_batch(
        video, video, ref, ref, w_init, flow_params=fp)
    assert [g.replays for g in tex.prealign_graphs()] == [3]
    for a, b in zip(seq, bat):
        assert torch.equal(a, b)
    tex.clear_frame_graphs()


def _sharded_eager(fixed, moving, uvw, weight, devices, **kw):
    """The eager Z-sharded body of ``get_displacement_sharded``'s
    configuration."""
    from flowreg3d_tpu_torch.core.pyramid import pyramid_config_key
    from flowreg3d_tpu_torch.parallel import spatial_pyramid as tsp

    key = pyramid_config_key(tuple(fixed.shape[:3]), fixed.shape[3], **kw)
    return tsp.build_sharded_pyramid(key, devices)(fixed, moving, uvw,
                                                   weight)


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_sharded_step_replays_its_graph(card, a_smooth):
    from flowreg3d_tpu_torch import _ext
    from flowreg3d_tpu_torch.parallel import spatial_pyramid as tsp

    video, ref = _frames(T=2, C=2, shape=(24, 32, 36))
    fixed, moving = (torch.from_numpy(a).to(card) for a in (ref, video[1]))
    devices = [card] * 2
    kw = dict(FLOW, a_smooth=a_smooth)
    uvw = torch.full(fixed.shape[:3] + (3,), 0.2, device=card)
    half = torch.full((2,), 0.5, device=card)
    tex.clear_frame_graphs()
    flow, valid = tsp.get_displacement_sharded(fixed, moving, uvw=uvw,
                                               devices=devices, **kw)
    (graph,) = tex.graphs("sharded")
    assert graph.replays == 1 and bool(valid)
    want, ok = _sharded_eager(fixed, moving, uvw, half, devices, **kw)
    assert torch.equal(flow, want) and bool(ok)
    # a warm call: one replay, no kernel launched from the host
    counters = _ext.launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    again, _ = tsp.get_displacement_sharded(fixed, moving, devices=devices,
                                            **kw)
    assert {k: f.launches for k, f in counters.items()} == before
    assert graph.replays == 2 and graph.launches["map_coords_f32"] > 0
    slab = ("sor_halfsweep_const_f32" if a_smooth == 1.0
            else "sor_halfsweep_psi_f32")
    assert graph.launches[slab] > 0 and graph.copies > 0
    want, _ = _sharded_eager(fixed, moving, torch.zeros_like(uvw), half,
                             devices, **kw)
    assert torch.equal(again, want)
    tex.clear_frame_graphs()
    assert tex.graphs("sharded") == []


def test_spatial_executor_replays_a_graph_a_frame(card):
    from flowreg3d_tpu_torch.ops.warp import warp

    video, ref = _frames(T=3, C=1, shape=(24, 32, 36))
    fp = dict(FLOW, a_smooth=0.5)
    w_init = np.full(ref.shape[:3] + (3,), 0.1, np.float32)
    tex.clear_frame_graphs()
    ex = tex.SpatialExecutor3D(devices=[card] * 2)
    regs, flows = ex.process_batch(video, video, ref, ref, w_init,
                                   flow_params=fp)
    (graph,) = tex.graphs("sharded")
    assert graph.replays == 3 and ex.single_device_frames == 0
    ref_t = torch.from_numpy(ref).to(card)
    one = torch.ones(1, device=card)
    for t in range(3):
        frame = torch.from_numpy(video[t]).to(card)
        want, ok = _sharded_eager(ref_t, frame, torch.from_numpy(w_init)
                                  .to(card), one, [card] * 2, **fp)
        assert bool(ok) and torch.equal(flows[t], want)
        assert torch.equal(regs[t], warp(frame, want[..., 0], want[..., 1],
                                         want[..., 2], ref_t, 3, True))
    tex.clear_frame_graphs()


def test_sharded_capture_with_upload_raises(card, monkeypatch):
    from flowreg3d_tpu_torch.parallel import spatial_pyramid as tsp

    video, ref = _frames(T=1, C=1, shape=(24, 32, 36))
    real = tsp._warp_local

    def uploading_warp(*args, **kwargs):
        out, ok = real(*args, **kwargs)
        return out, ok & torch.tensor(True, device=out.device)

    monkeypatch.setattr(tsp, "_warp_local", uploading_warp)
    tex.clear_frame_graphs()
    with pytest.raises(RuntimeError):
        tsp.get_displacement_sharded(ref, video[0], devices=[card] * 2,
                                     **dict(FLOW, a_smooth=1.0))
    tex.clear_frame_graphs()


@pytest.mark.parametrize("a_smooth", [1.0, 0.5])
def test_level_and_2d_solvers_replay_their_graphs(card, a_smooth):
    from flowreg3d_tpu_torch import _ext
    from flowreg3d_tpu_torch.core import solver, solver2d

    rng = np.random.default_rng(2)
    shape, C = (12, 20, 22), 2
    J = [torch.from_numpy(rng.random((C,) + shape).astype(np.float32))
         .to(card) for _ in range(10)]
    weight = torch.full((C,) + shape, 0.5, device=card)
    u, v, w = (torch.from_numpy(0.1 * rng.standard_normal(shape)
                                .astype(np.float32)).to(card)
               for _ in range(3))
    args = ((1.5, 1.2, 1.0), 6, 3, [0.45, 0.3], a_smooth, 1.1, 1.2, 1.3)
    tex.clear_frame_graphs()
    got = solver.compute_flow_level_cl(J, weight, u, v, w, *args)
    want = solver.solve_level_cl(J, weight, u, v, w, *args)
    counters = _ext.launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    again = solver.compute_flow_level_cl(J, weight, u, v, w, *args)
    assert {k: f.launches for k, f in counters.items()} == before
    (graph,) = tex.graphs("level")
    assert graph.replays == 2
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)

    J2 = [rng.random((40, 44, C)) for _ in range(6)]
    w2, u2 = np.ones((40, 44, C)), np.zeros((40, 44))
    kw = dict(alpha=(0.5, 0.5), iterations=6, update_lag=2, a_smooth=a_smooth)
    for dtype in (np.float32, np.float64):
        J2d = [j.astype(dtype) for j in J2]
        got = solver2d.compute_flow(J2d, w2.astype(dtype), u2.astype(dtype),
                                    u2.astype(dtype), device=card, **kw)
        solve = solver2d.flow2d_solver(
            (40, 44), C, (0.5, 0.5), 6, 2, 0.45, a_smooth, 1.0, 1.0,
            getattr(torch, np.dtype(dtype).name), card)
        want = solve(*(torch.from_numpy(np.asarray(x, dtype)).to(card)
                       for x in (np.stack(J2d), w2, u2, u2)))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [g.replays for g in tex.graphs("flow2d")] == [1]
    tex.clear_frame_graphs()



def _u16_call():
    video, ref = _frames(T=4, C=1)
    opts = OFOptions(**FLOW, a_smooth=1.0, weight=[1.0], buffer_size=2)
    return lambda: compensate_arr((video * 10000).astype(np.uint16),
                                  ref * 10000, opts)


def test_spans_are_host_rows_only(card):
    from torch.profiler import ProfilerActivity, profile

    call = _u16_call()
    call()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    rows = [(e.key, str(e.device_type)) for e in prof.key_averages()
            if e.key.startswith("flowreg3d.")]
    assert {"flowreg3d.read", "flowreg3d.upload", "flowreg3d.enqueue",
            "flowreg3d.staging_pin", "flowreg3d.staging_wait",
            "flowreg3d.staging_copy", "flowreg3d.output"} <= {
                k for k, _ in rows}, rows
    assert all(dt.endswith("CPU") for _, dt in rows), rows
    tex.clear_frame_graphs()


def test_frame_capture_tallied_once(card):
    from flowreg3d_tpu_torch import _graph

    call = _u16_call()
    tex.clear_frame_graphs()
    before = _graph.capture_totals().get("frame", (0, 0.0))[0]
    call()
    call()
    n, seconds = _graph.capture_totals()["frame"]
    assert n == before + 1 and seconds > 0
    tex.clear_frame_graphs()
