"""Port parity: synthetic motion generation
(``flowreg3d_tpu_torch.motion_generation``) against the JAX package's, on
the CPU.

- JAX's 9 tests of tests/motion_generation/test_generators.py on the port;
- every preset and every augmentor against JAX on three seeds, bit for bit
  on flow and mask (the generators are the JAX package's numpy code);
- ``warp_volume_splat3d`` against JAX: 1e-6 in float32, 1e-10 in float64,
  and integer input keeps JAX's dtype rule (float64 out);
- ``warp_volume_backward`` against JAX at 1e-5, both orders;
- the three metrics against JAX, exactly;
- the slice as a whole: the reference's example harness
  (examples/motion_correct_3d_test.py) on a small volume (the test
  preset's flow, splat, crop, sigma-0.5 preprocessing, get_displacement,
  the cubic warp, EPE and the improvement ratio) through both packages at
  a_smooth 0.5, min_level 0: flows within 1e-4, EPE and ratio within 1e-5
  relative. (At a_smooth 1 the pyramid amplifies rounding beyond such
  bounds: ROADMAP.md, Queue 3.)
"""

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import flowreg3d_tpu as fj
import flowreg3d_tpu.motion_generation as jmg

import flowreg3d_tpu_torch as ft

from flowreg3d_tpu_torch.motion_generation import (
    Expansion3DFlowAugmentor,
    FlowGenerator3D,
    Jitter3DFlowAugmentor,
    Random3DFlowAugmentor,
    Rotational3DFlowAugmentor,
    Shear3DFlowAugmentor,
    Translational3DFlowAugmentor,
    evaluate_flow_accuracy,
    get_default_3d_generator,
    get_high_disp_3d_generator,
    get_low_disp_3d_generator,
    get_test_3d_generator,
    improvement_ratio,
    psnr,
    warp_volume_3d,
    warp_volume_backward,
    warp_volume_splat3d,
)

torch.set_num_threads(1)

SEEDS = (0, 42, 2024)


@pytest.fixture(autouse=True)
def jax_float32():
    """JAX's reference in its default float32, whatever an earlier test
    file left in the worker (tests/core/test_solver2d.py turns x64 on for
    the whole process)."""
    with jax.enable_x64(False):
        yield


PRESETS = ("get_default_3d_generator", "get_low_disp_3d_generator",
           "get_test_3d_generator", "get_high_disp_3d_generator")
AUGMENTORS = ("Rotational3DFlowAugmentor", "Translational3DFlowAugmentor",
              "Jitter3DFlowAugmentor", "Expansion3DFlowAugmentor",
              "Random3DFlowAugmentor", "Shear3DFlowAugmentor")


def _splat(vol, flow):
    return warp_volume_splat3d(vol, flow, device="cpu")


# -- JAX's tests/motion_generation/test_generators.py on the port ------------

def test_determinism_with_seed():
    gen = get_default_3d_generator()
    f1, m1 = gen(16, 20, 20, rng=42)
    f2, m2 = gen(16, 20, 20, rng=42)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(m1, m2)
    f3, _ = gen(16, 20, 20, rng=43)
    assert not np.array_equal(f1, f3)


def test_translation_augmentor_constant_field():
    aug = Translational3DFlowAugmentor(max_disp=5, p=1.0)
    flow = aug(np.zeros((8, 8, 8, 3), np.float32), rng=0)
    for c in range(3):
        assert np.ptp(flow[..., c]) == 0.0
    assert np.any(flow != 0)


def test_rotation_augmentor_zero_at_center():
    aug = Rotational3DFlowAugmentor(max_rot_deg=10, p=1.0, center_jitter=0)
    flow = aug(np.zeros((9, 9, 9, 3), np.float32), rng=1)
    c = np.linalg.norm(flow[4, 4, 4])
    edge = np.linalg.norm(flow[0, 0, 0])
    assert c < 1.0
    assert edge > c


def test_expansion_augmentor_radial():
    aug = Expansion3DFlowAugmentor(max_magnitude=0.1, min_magnitude=0.1,
                                   p=1.0, center_jitter=0, anisotropic=False)
    flow = aug(np.zeros((9, 9, 9, 3), np.float32), rng=3)
    assert flow[4, 4, 8, 0] > flow[4, 4, 5, 0] > 0
    assert flow[4, 4, 0, 0] < 0


def test_all_presets_produce_valid_fields():
    for factory in (get_default_3d_generator, get_low_disp_3d_generator,
                    get_test_3d_generator, get_high_disp_3d_generator):
        flow, invalid = factory()(12, 16, 16, rng=11)
        assert flow.shape == (12, 16, 16, 3)
        assert invalid.shape == (12, 16, 16)
        assert invalid.dtype == bool
        assert np.all(np.isfinite(flow))


def test_jitter_and_shear_and_random_apply():
    rng = np.random.default_rng(5)
    for aug in (Jitter3DFlowAugmentor(p=1.0), Shear3DFlowAugmentor(p=1.0),
                Random3DFlowAugmentor(p=1.0)):
        for _ in range(20):
            flow = aug(np.zeros((8, 10, 10, 3), np.float32), rng=rng)
            if np.any(flow != 0):
                break
        assert np.any(flow != 0)
        assert np.all(np.isfinite(flow))


def test_splat_forward_warp_translation():
    """Splatting by an integer translation must equal an array shift."""
    rng = np.random.default_rng(8)
    vol = rng.random((10, 12, 12)).astype(np.float32)
    flow = np.zeros(vol.shape + (3,), np.float32)
    flow[..., 0] = 2.0
    warped = _splat(vol, flow)
    np.testing.assert_allclose(warped[:, :, 2:], vol[:, :, :-2], atol=1e-5)


def test_splat_inverts_backward_warp():
    """forward-splat(flow) ~ backward-warp(-flow) for smooth subvoxel flows."""
    rng = np.random.default_rng(9)
    vol = gaussian_filter(rng.random((14, 18, 18)), 2.0).astype(np.float32)
    flow = np.zeros(vol.shape + (3,), np.float32)
    flow[..., 0] = 0.7
    flow[..., 1] = -0.4
    a = _splat(vol, flow)
    b = warp_volume_backward(vol, -flow, device="cpu")
    interior = np.s_[2:-2, 2:-2, 2:-2]
    assert np.mean(np.abs(a[interior] - b[interior])) < 5e-3


def test_epe_metric():
    gt = np.zeros((40, 60, 60, 3), np.float32)
    est = gt + 1.0
    assert abs(evaluate_flow_accuracy(est, gt, boundary=5) - np.sqrt(3)) < 1e-6
    assert evaluate_flow_accuracy(gt, gt, boundary=5) == 0.0


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("preset", PRESETS)
def test_presets_match_jax_bitwise(preset, seed):
    flow, mask = globals()[preset]()(10, 14, 12, rng=seed)
    flow_j, mask_j = getattr(jmg, preset)()(10, 14, 12, rng=seed)
    assert flow.dtype == flow_j.dtype == np.float32
    np.testing.assert_array_equal(flow, flow_j)
    np.testing.assert_array_equal(mask, mask_j)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", AUGMENTORS)
def test_augmentors_match_jax_bitwise(name, seed):
    """Each augmentor (firing: p = 1) through FlowGenerator3D, and alone on a
    nonzero field with a shared Generator, as the JAX one."""
    got = FlowGenerator3D([globals()[name](p=1.0)])(9, 11, 13, rng=seed)
    want = jmg.FlowGenerator3D([getattr(jmg, name)(p=1.0)])(9, 11, 13,
                                                            rng=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    base = np.random.default_rng(seed + 1).standard_normal(
        (7, 9, 8, 3)).astype(np.float32)
    rng, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    aug, aug_j = globals()[name](), getattr(jmg, name)()
    for _ in range(4):     # default p: some draws fire, some do not
        np.testing.assert_array_equal(aug(base.copy(), rng=rng),
                                      aug_j(base.copy(), rng=rng_j))


def _splat_case(seed=0, shape=(9, 13, 11)):
    rng = np.random.default_rng(seed)
    vol = rng.random(shape + (2,)).astype(np.float32)
    # subvoxel and multi-voxel moves, some out of the grid, some integral
    flow = (1.5 * rng.standard_normal(shape + (3,))).astype(np.float32)
    flow[:2] = np.round(flow[:2])
    return vol, flow


@pytest.mark.parametrize("channels", [True, False])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-10)])
def test_splat_matches_jax(dtype, tol, channels):
    vol, flow = _splat_case()
    vol = (vol if channels else vol[..., 0]).astype(dtype)
    got = _splat(vol, flow)
    want = jmg.warp_volume_splat3d(vol, flow)
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape == vol.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert (want == 0).any() and (want != 0).mean() > 0.5
    assert warp_volume_3d is warp_volume_splat3d


def test_splat_integer_input_keeps_jax_dtype_rule():
    vol, flow = _splat_case(seed=1)
    vol = (vol[..., 0] * 1000).astype(np.uint16)
    got = _splat(vol, flow)
    want = jmg.warp_volume_splat3d(vol, flow)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_backward_warp_matches_jax(method):
    rng = np.random.default_rng(4)
    vol = gaussian_filter(rng.random((10, 14, 12)), 1.0).astype(np.float32)
    flow = (0.8 * rng.standard_normal(vol.shape + (3,))).astype(np.float32)
    got = warp_volume_backward(vol, flow, method, device="cpu")
    want = jmg.warp_volume_backward(vol, flow, method)
    assert got.dtype == np.float32 and got.shape == vol.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_warps_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    vol, flow = _splat_case()
    with pytest.raises(RuntimeError, match="CUDA"):
        warp_volume_splat3d(vol, flow)
    with pytest.raises(RuntimeError, match="CUDA"):
        warp_volume_backward(vol[..., 0], flow)


def test_metrics_match_jax_exactly():
    rng = np.random.default_rng(6)
    gt = rng.standard_normal((12, 14, 16, 3)).astype(np.float32)
    est = gt + 0.3 * rng.standard_normal(gt.shape).astype(np.float32)
    for b in (0, 2):
        assert (evaluate_flow_accuracy(est, gt, boundary=b)
                == jmg.evaluate_flow_accuracy(est, gt, boundary=b))
    orig = rng.random((12, 14, 16)).astype(np.float32)
    disp = orig + 0.2 * rng.random(orig.shape).astype(np.float32)
    corr = orig + 0.05 * rng.random(orig.shape).astype(np.float32)
    for b in (0, 3):
        assert (improvement_ratio(orig, disp, corr, boundary=b)
                == jmg.improvement_ratio(orig, disp, corr, boundary=b))
    assert improvement_ratio(orig, disp, orig) == float("inf")
    for dr in (None, 1.0):
        assert psnr(orig, corr, dr) == jmg.psnr(orig, corr, dr)
    assert psnr(orig, orig) == float("inf")


def test_example_harness_matches_jax():
    shape = (20, 64, 64)
    rng = np.random.default_rng(1)
    vol = np.zeros(shape, np.float32)
    idx = tuple(rng.integers(2, n - 2, 600) for n in shape)
    vol[idx] = rng.random(600).astype(np.float32) + 0.5
    vol = gaussian_filter(vol, (1.0, 2.0, 2.0))
    original = (vol / vol.max()).astype(np.float32)
    flow_gt, _ = get_test_3d_generator()(*shape, rng=rng)
    flow_gt *= 0.3                           # within the pyramid's reach
    displaced = _splat(original, flow_gt)
    np.testing.assert_array_equal(
        displaced, jmg.warp_volume_splat3d(original, flow_gt))
    sl = (slice(3, -3),) * 3
    orig_c, disp_c, gt_c = original[sl], displaced[sl], flow_gt[sl]
    f1, f2 = (gaussian_filter(f, 0.5) for f in (orig_c, disp_c))
    lo, hi = f1.min(), f1.max()
    f1, f2 = (f1 - lo) / (hi - lo), (f2 - lo) / (hi - lo)
    params = dict(alpha=(1.5, 1.5, 1.5), iterations=20, update_lag=10,
                  a_data=0.45, a_smooth=0.5, levels=50, eta=0.8,
                  min_level=0, const_assumption="gc")
    flow_j = np.asarray(fj.get_displacement(f1, f2, **params))
    corr_j = np.asarray(fj.imregister_wrapper(
        disp_c, flow_j[..., 0], flow_j[..., 1], flow_j[..., 2], orig_c,
        interpolation_method="cubic"))
    flow = ft.get_displacement(f1, f2, device="cpu", **params).numpy()
    corr = ft.imregister_wrapper(disp_c, flow[..., 0], flow[..., 1],
                                 flow[..., 2], orig_c, "cubic",
                                 device="cpu").numpy()
    np.testing.assert_allclose(flow, flow_j, rtol=0, atol=1e-4)
    epe, epe_j = (evaluate_flow_accuracy(f, gt_c, boundary=2)
                  for f in (flow, flow_j))
    ratio = improvement_ratio(orig_c, disp_c, corr)
    ratio_j = jmg.improvement_ratio(orig_c, disp_c, corr_j)
    np.testing.assert_allclose(epe, epe_j, rtol=1e-5)
    np.testing.assert_allclose(ratio, ratio_j, rtol=1e-5)
    assert epe < 0.2 and ratio > 3
