"""The yardstick's arithmetic: rates, percentiles, spreads, the frozen kernel
bounds, and traffic that depends on the seed alone."""

import math

import numpy as np
import pytest
import torch

from portbench.lib import roofline, stats, synth
from portbench.lib.kernels import tick_bound_ms
from portbench.lib.roofline import psi_tick_ms as PSI_TICK
from portbench.lib.roofline import sor_tick_ms as SOR_TICK
from portbench.lib.trace import _merge
from portbench.reference.plain import level_schedule


def test_rate_is_all_work_over_all_time():
    assert stats.rate(90, 30.0) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("n", [1, 2, 20, 201])
def test_percentile_matches_numpy(n):
    xs = list(np.random.default_rng(n).random(n))
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


@pytest.mark.parametrize("fn, shape, iters, ms", [
    (SOR_TICK, (23, 170, 170), 5, 0.0106),      # kernel table row 1
    (SOR_TICK, (66, 514, 514), 5, 0.3005),      # row 2
    (PSI_TICK, (23, 170, 170), 10, 0.0188),     # row 6
    (PSI_TICK, (66, 514, 514), 10, 0.4945),     # row 7
])
def test_bounds_reproduce_the_kernel_table(fn, shape, iters, ms):
    assert round(fn(shape, iters), 4) == ms


def test_bound_names_what_bounds_it():
    assert roofline.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound_ms(0, 67e9) == (1.0, "operations")


def test_tick_bound_sums_levels_and_blocks():
    params = dict(iterations=20, update_lag=10)
    plan = [(0, (64, 512, 512), (1.0, 1.0, 1.0))]
    assert tick_bound_ms(plan, params, PSI_TICK) == pytest.approx(
        2 * PSI_TICK((66, 514, 514), 10))


def test_level_plans_of_the_configurations():
    canonical, eff, _ = level_schedule((64, 512, 512), 0.8, 100, 5)
    assert [s for _, s, _ in canonical][0] == (9, 69, 69)
    assert [s for _, s, _ in canonical][-1] == (21, 168, 168)
    assert len(canonical) == 5 and eff == 5
    direct, eff, _ = level_schedule((64, 512, 512), 0.8, 50, 0)
    assert len(direct) == 10 and direct[-1][1] == (64, 512, 512)


def test_merge_counts_overlaps_once():
    assert _merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


MOTION = {"drift_zyx": [1.5, 4.0, 4.0], "deform_zyx": [0.5, 1.5, 1.5],
          "waves": 2, "cycles": [0.5, 1.5]}
SCENE = {"density": [0.01, 0.004], "sigma_zyx": [[1, 2, 2], [1.5, 3, 3]]}


def _frames(seed):
    g = synth.generator(seed, torch.device("cpu"))
    base = synth.scene(g, (8, 20, 24), SCENE)
    disp = synth.displacement(g, (8, 20, 24), MOTION)
    return synth.to_u16_on_host(synth.noisy(
        g, 100 + 2000 * synth.moved(base, disp), 20.0)), disp


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17, 2 ** 40 + 3])
def test_traffic_is_deterministic_in_the_seed(seed):
    a, da = _frames(seed)
    b, db = _frames(seed)
    c, _ = _frames(seed + 1)
    assert a.dtype == np.uint16 and a.shape == (8, 20, 24, 2)
    assert np.array_equal(a, b) and torch.equal(da, db)
    assert not np.array_equal(a, c)


def test_motion_is_subvoxel_and_bounded():
    _, disp = _frames(3)
    frac = disp - disp.round()
    assert float(frac.abs().max()) > 0.1
    bound = torch.tensor([4.0 + 1.5 * 2, 4.0 + 1.5 * 2, 1.5 + 0.5 * 2])
    assert bool((disp.abs().amax(dim=(0, 1, 2)) <= bound).all())


def test_u16_download_rounds_and_clips():
    x = torch.tensor([-3.0, 0.4, 0.6, 1.5, 2.5, 65534.6, 70000.0])
    assert synth.to_u16_on_host(x).tolist() == [0, 0, 1, 2, 2, 65535, 65535]


def test_worst_keeps_nan_and_exact_agreement_reads_zero():
    from portbench.lib import compare

    assert math.isnan(compare.worst(
        [{"a": 1.0}, {"a": float("nan")}, {"a": 2.0}])["a"])
    assert compare.worst([{"a": 1.0}, {"a": 3.0}, {"a": 2.0}])["a"] == 3.0
    flow = torch.tensor([[1.0, float("inf"), float("nan")]])
    reg = torch.tensor([1.0, 2.0, 4.0])
    assert compare.item_numbers(flow, reg, flow.clone(), reg.clone()) == {
        "flow_epe": 0.0, "reg_rel_rms": 0.0}
    other = flow.clone()
    other[0, 2] = 0.0
    assert math.isnan(compare.item_numbers(other, reg, flow, reg)["flow_epe"])


def test_check_sample_draws_distinct_frames_of_every_batch():
    from portbench.lib.entry import check_sample

    ranges = [(0, 10), (10, 20), (20, 30)]
    s = check_sample(2 ** 31 + 5, ranges, 2)
    assert s == check_sample(2 ** 31 + 5, ranges, 2) and len(set(s)) == 6
    assert all(sum(a <= t < b for t in s) == 2 for a, b in ranges)
