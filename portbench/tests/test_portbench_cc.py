"""The cc-prealigned recording cell (``cc_defaults.arr``) on the CPU at tiny
sizes: the reference's phase correlation against known shifts, the port's
``compensate_arr_3D`` under ``cc_initialization`` against
``reference/prealign.check_frames_cc`` on every frame, ``correct`` false for
each fault the cell can have, and a whole run of the cell through the
harness."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import flowreg3d_tpu_torch.parallel.executors as executors
from portbench import run as harness
from portbench.lib import compare, synth
from portbench.lib.spec import Spec
from portbench.reference import prealign

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
CELL = "cc_defaults.arr"
UP = 10


def _centred_blobs(shape, seed=5):
    """(Z,Y,X,1) blobs under a Gaussian envelope of an eighth of each axis,
    so that the Hann window barely weighs the content and a periodic shift
    wraps nothing visible."""
    g = synth.generator(seed, CPU)
    vol = synth.scene(g, shape, {"density": [0.004],
                                 "sigma_zyx": [[1.5, 2.0, 2.0]]})
    for axis, n in enumerate(shape):
        x = torch.arange(n, dtype=torch.float32) - (n - 1) / 2
        dims = [1, 1, 1, 1]
        dims[axis] = n
        vol = vol * torch.exp(-0.5 * (x / (n / 8)) ** 2).reshape(dims)
    return vol


def _fourier_shift(vol, s_zyx):
    """``vol`` with its content moved by ``s_zyx`` voxels, exactly for its
    band-limited content (a phase ramp), in float64 then float32."""
    F = torch.fft.fftn(vol[..., 0].double())
    ramp = 0
    for axis, (n, s) in enumerate(zip(F.shape, s_zyx)):
        dims = [1, 1, 1]
        dims[axis] = n
        ramp = ramp + torch.fft.fftfreq(n, dtype=torch.float64).reshape(
            dims) * s
    moved = torch.fft.ifftn(F * torch.exp(-2j * np.pi * ramp)).real
    return moved.float()[..., None]


SHIFTS = [(0, 0, 0), (2, -5, 7), (-3, 4, -6), (1, 0, 0), (0, 3, 0),
          (0, 0, -4), (0.3, -1.7, 2.4), (-1.5, 0.6, -3.2), (1.1, 2.9, 0.5),
          (-0.7, -2.2, 1.3)]


@pytest.mark.parametrize("s_zyx", SHIFTS, ids=str)
def test_phase_correlation_recovers_known_shifts(s_zyx):
    """Integer and subpixel shifts in z, y and x come back within 1/cc_up
    voxel as the backward-warp displacement [dx, dy, dz]; with the XY
    projection halved by the resize, within 1/cc_up of its pixels (two
    voxels a pixel in y and x)."""
    shape = (32, 64, 64)
    ref = _centred_blobs(shape)
    mov = _fourier_shift(ref, s_zyx)
    want = torch.tensor(s_zyx[::-1], dtype=torch.float32)
    full = prealign.rigid_shift(ref, mov, [1.0], shape[1:], UP)
    assert full.shape == (3,) and full.dtype == torch.float32
    assert float((full - want).abs().max()) <= 1 / UP + 1e-4, full
    half = prealign.rigid_shift(ref, mov, [1.0], (32, 32), UP)
    assert float((half - want)[:2].abs().max()) <= 2 / UP + 1e-4, half
    assert float((half - want)[2].abs()) <= 1 / UP + 1e-4, half


@pytest.mark.parametrize("s_zyx", SHIFTS[:6], ids=str)
def test_rigid_shift_bit_equal_to_the_program(s_zyx):
    """The reference's estimate, its projections resized and disambiguated,
    is the program's bit for bit on one device: the peaks it picks are
    discrete, so a differing bit could move a frame by a tenth of a pixel."""
    from flowreg3d_tpu_torch.util.xcorr_prealignment import (
        estimate_rigid_xcorr_device)

    ref = _centred_blobs((16, 48, 40)).repeat(1, 1, 1, 2)
    mov = _fourier_shift(ref, s_zyx).repeat(1, 1, 1, 2)
    mov[..., 1] *= 0.5
    for hw in ((48, 40), (24, 20)):
        want = estimate_rigid_xcorr_device(ref, mov, target_hw=hw, up=UP)
        got = prealign.rigid_shift(ref, mov, [0.5, 0.5], hw, UP)
        np.testing.assert_array_equal(got, want)


def test_disambiguation_bit_equal_to_the_program():
    """Every candidate, thin wrapped strips among them, scored and chosen as
    the program scores and chooses it."""
    from flowreg3d_tpu_torch.ops.xcorr import _disambiguate

    g = torch.Generator().manual_seed(11)
    for _ in range(40):
        a = prealign.windowed(torch.rand(32, 40, generator=g))
        b = prealign.windowed(torch.rand(32, 40, generator=g))
        shift = (torch.rand(2, generator=g) - 0.5) * torch.tensor([64.0, 80.0])
        np.testing.assert_array_equal(prealign.disambiguate(a, b, shift),
                                      _disambiguate(a, b, shift))


def test_channels_collapse_by_their_weights():
    """A channel with zero weight does not move the estimate."""
    ref = _centred_blobs((24, 48, 48))
    mov = _fourier_shift(ref, (1, -2, 3))
    noise = torch.rand(ref.shape, generator=torch.Generator().manual_seed(1))
    two_ref, two_mov = (torch.cat([v, noise], dim=-1) for v in (ref, mov))
    np.testing.assert_array_equal(
        prealign.rigid_shift(two_ref, two_mov, [1.0, 0.0], (48, 48), UP),
        prealign.rigid_shift(ref, mov, [1.0], (48, 48), UP))


def test_complex_product_precisions():
    """``cmatmul`` is the complex product in float32, and under the TF32
    control the product of the operands rounded to TF32."""
    from portbench.reference import plain

    g = torch.Generator().manual_seed(3)
    a, b = (torch.complex(torch.randn(5, 7, generator=g),
                          torch.randn(5, 7, generator=g)) for _ in range(2))
    b = b.T
    np.testing.assert_array_equal(prealign.cmatmul(a, b), a @ b)
    rounded = [torch.complex(plain.to_tf32(x.real.contiguous()),
                             plain.to_tf32(x.imag.contiguous()))
               for x in (a, b)]
    np.testing.assert_array_equal(
        prealign.cmatmul(a, torch.conj(b), plain.tf32_matmul),
        rounded[0] @ torch.conj(rounded[1]))
    assert not torch.equal(prealign.cmatmul(a, b, plain.tf32_matmul), a @ b)


def _config():
    return json.loads((BENCH / "configs" / "cc_defaults.json").read_text())


def _small_recording(shape=(12, 32, 32), T=6, seed=SEED):
    """A u16 recording of two-channel blobs under the cell's rigid jumps,
    and its reference, the mean of its first four frames."""
    tr = Spec().traffic("arr_cc")
    g = synth.generator(seed, CPU)
    base = synth.scene(g, shape, tr["scene"])
    cam = tr["camera"]
    counts = torch.stack([synth.noisy(
        g, cam["offset"] + cam["gain"] * synth.moved(
            base, synth.displacement(g, shape, tr["motion"])), cam["noise"])
        for _ in range(T)])
    frames = synth.to_u16_on_host(counts)
    return frames, frames[:4].astype(np.float64).mean(axis=0)


def test_port_matches_the_reference_on_every_frame():
    """At 12x32x32x2, T=6 in batches of 3, cc_hw 16, the plain PyTorch
    versions of the kernels: every frame's total flow and registered volume
    as ``check_frames_cc`` has them."""
    from flowreg3d_tpu_torch.pipeline import (OFOptions, RegistrationConfig,
                                              compensate_arr_3D)

    flow = dict(_config()["flow"], buffer_size=3, cc_hw=[16, 16])
    frames, reference = _small_recording()
    registered, flows = compensate_arr_3D(
        frames, reference, OFOptions(**flow),
        config=RegistrationConfig(use_kernels=False), device=CPU)
    assert registered.dtype == np.float64 and flows.shape[-1] == 3
    from portbench.lib.entry import solver_params
    ref = prealign.check_frames_cc(
        frames, reference, flows, range(frames.shape[0]),
        solver_params(flow), flow["weight"], flow["sigma"], 3, CPU,
        cc_hw=(16, 16), cc_up=UP)
    assert sorted(ref) == list(range(frames.shape[0]))
    # the rigid part engaged: the frames' jumps are whole voxels apart
    means = flows.reshape(frames.shape[0], -1, 3).mean(axis=1)
    assert np.ptp(means[:, :2], axis=0).max() > 1.0, means
    for t, (flow_r, reg_r) in ref.items():
        n = compare.item_numbers(torch.as_tensor(flows[t]),
                                 torch.as_tensor(registered[t]), flow_r,
                                 reg_r)
        # the same float32 operations in the same order on one device: in
        # practice bit for bit; these bounds sit four orders below the
        # cell's limits (0.25 voxel, 5%), and a single differing peak of
        # the correlation moves the flow by a tenth of a voxel or more
        assert n["flow_epe"] <= 1e-5, (t, n)
        assert n["reg_rel_rms"] <= 1e-6, (t, n)


def _small():
    flow = dict(_config()["flow"], buffer_size=3, cc_hw=[16, 16])
    return {"config": {"shape": [12, 32, 32], "flow": flow},
            "traffic": {"frames": 7, "reference_frames": 4,
                        "warm_frames": 3}}


def _run(trace=0):
    result, _ = harness.run_cell(CELL, SEED, 0.05, trace, CPU,
                                 overrides=_small(), log=lambda msg: None)
    return result


def test_cell_parts_found_by_name():
    spec = Spec()
    wl = spec.workload(CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (
        "cc_defaults", "arr_cc", 1)
    cfg = spec.config("cc_defaults")
    assert cfg["flow"]["cc_initialization"] is True
    assert (cfg["flow"]["cc_hw"], cfg["flow"]["cc_up"]) == ([256, 256], 10)
    assert {k: v for k, v in cfg["flow"].items() if not k.startswith("cc_")
            } == spec.config("ofoptions_defaults")["flow"]
    tr = spec.traffic("arr_cc")
    arr = spec.traffic("arr")
    assert tr["entry"] == "arr_cc" and tr["motion"]["drift_zyx"] == [
        3.0, 12.0, 12.0]
    assert {k: v for k, v in tr.items() if k not in ("entry", "why",
                                                     "motion")} == {
        k: v for k, v in arr.items() if k not in ("entry", "why", "motion")}
    mod = spec.entry("arr_cc")
    # arr's readings and loop; only the reference's frames are its own
    assert mod.readings.__code__ is mod.arr.readings.__code__
    assert [k for k in vars(mod.Entry) if not k.startswith("__")] == [
        "reference_frames"]
    assert json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    names = [m["name"] for m in spec.metrics(CELL, 1)]
    assert names == ["prealign_ms_per_volume.cc",
                     "cc_finalize_ms_per_volume.cc", "xcorr_ms_per_volume.cc",
                     "staging_wait_ms_per_volume.cc",
                     "launch_calls_per_volume.cc", "idle_pct.cc"]
    assert all(callable(spec.reader(n)) for n in names)
    assert [m["name"] for m in spec.metrics(CELL, 0)] == ["volumes_per_s",
                                                          "setup_s"]


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["checks"]["flow_epe"]["value"] == 0.0, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"volumes_per_s", "setup_s"}


def test_traced_run_reads_the_spans():
    """On the CPU the slice has the program's spans (no device rows): the
    two new spans read numbers, the device readers nothing."""
    result = _run(trace=1)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    assert got["prealign_ms_per_volume.cc"]["value"] > 0
    assert got["cc_finalize_ms_per_volume.cc"]["value"] > 0
    assert "xcorr_ms_per_volume.cc" not in got


def _no_rigid_flow(monkeypatch):
    """The total flow left without ``w_combined``: the residual alone, and
    the raw frames warped by it."""
    orig = executors.BaseExecutor3D._finalize_cc

    def finalize(self, batch, flows, extra_flow, *args):
        return orig(self, batch, flows, torch.zeros_like(extra_flow), *args)
    monkeypatch.setattr(executors.BaseExecutor3D, "_finalize_cc", finalize)


def _prealignment_skipped(monkeypatch):
    """Each frame handed to the solve as it came, with ``w_init`` as its
    rigid flow."""
    def skipped(self, batch_proc, ref_proc, w_init, flow_params):
        T = batch_proc.shape[0]
        return batch_proc, w_init.expand((T,) + tuple(w_init.shape))
    monkeypatch.setattr(executors.BaseExecutor3D, "_prealign_frames",
                        skipped)


@pytest.mark.parametrize("fault", [_no_rigid_flow, _prealignment_skipped],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]


# device rows of a traced cc_defaults.arr call on the H100 (torch 2.11, CUDA
# 12.8): those only the prealignment launches, and a sample of the others
XCORR_ROWS = (
    "void vector_fft<256u, EPT<16u>, 1u, 32u, (padding_t)70, (twiddle_t)0, "
    "(loadstore_modifier_t)2, (layout_t)0, unsigned int, float, "
    "HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
    "void regular_fft<256u, EPT<16u>, 8u, 9u, (padding_t)14, (twiddle_t)0, "
    "(loadstore_modifier_t)2, (layout_t)1, unsigned int, float, "
    "HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
    "void regular_fft<64u, EPT<8u>, 32u, 6u, (padding_t)14, (twiddle_t)0, "
    "(loadstore_modifier_t)2, (layout_t)1, unsigned int, float, "
    "HostConfigPlaceholder>(kernel_arguments_t<unsigned int>)",
    "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n_tilesize32x32x8_stage3_warpsize"
    "2x2x1_ffma_aligna8_alignc8_execute_kernel__5x_cublas",
    "sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8_stage3_warpsize"
    "2x2x1_ffma_aligna8_alignc8_execute_split_k_kernel__5x_cublas",
)
OTHER_ROWS = (
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize"
    "2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>("
    "cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)",
    "void gemmSN_NN_kernel<float, 256, 4, 2, 8, 5, 4, false, "
    "cublasGemvTensorStridedBatched<float const>, "
    "cublasGemvTensorStridedBatched<float const>, "
    "cublasGemvTensorStridedBatched<float> >(cublasGemmSmallNParams<",
    "void (anonymous namespace)::sor_iterations_kernel<true>(float*, float "
    "const*, int, int, int, float, float, float, int, int)",
    "void (anonymous namespace)::map_coords_kernel<2>(float const*, int, int, "
    "float const*, float const*, float const*, float*, int, int, int, int, "
    "int)",
    "void at::native::roll_cuda_kernel<float>(float const*, float*, long, "
    "long, long, long, long, long)",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::ArgMaxOps<float>, unsigned int, long, 4, 4> >(",
    "Memcpy DtoD (Device -> Device)",
)


def test_xcorr_reader_names_pinned():
    is_xcorr = Spec().reader("xcorr_ms_per_volume.cc").__globals__["is_xcorr"]
    assert all(is_xcorr(n) for n in XCORR_ROWS)
    assert not any(is_xcorr(n) for n in OTHER_ROWS)


@pytest.mark.cuda
def test_control_fails_a_limit():
    """On the card at the cell's own size: the program within every limit,
    and the TF32 control against the float32 reference past at least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's "
                    "size")
    spec = Spec()
    wl = spec.workload(CELL)
    cfg, tr = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    mod = spec.entry(tr["entry"])
    entry = mod.Entry(cfg, tr, SEED, torch.device("cuda", 0))
    entry.setup()
    readings, _ = mod.readings(entry, True, 2)
    program, control = readings["program"], readings["control"]
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert any(control[k] > lim for k, lim in limits.items()
               if k in control), control
