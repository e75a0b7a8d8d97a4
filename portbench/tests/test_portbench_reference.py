"""The frozen plain reference against the port's plain path on the CPU at a
tiny size: both configurations, both entries, bit for bit."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.lib import synth
from portbench.lib.entry import solver_params
from portbench.reference import pipeline as refp
from portbench.reference import plain

BENCH = Path(__file__).resolve().parents[1]
SHAPE = (10, 36, 40)
CONFIGS = ("ofoptions_defaults", "direct_defaults")
MOTION = {"drift_zyx": [1.0, 3.0, 3.0], "deform_zyx": [0.5, 1.0, 1.0],
          "waves": 2, "cycles": [0.5, 1.5]}
SCENE = {"density": [0.02, 0.008], "sigma_zyx": [[1, 2, 2], [1.5, 3, 3]]}


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _volumes(n, channels, seed=7):
    g = synth.generator(seed, torch.device("cpu"))
    base = synth.scene(g, SHAPE, {k: v[:channels] for k, v in SCENE.items()})
    moved = [synth.noisy(g, synth.moved(base, synth.displacement(
        g, SHAPE, MOTION)), 0.01) for _ in range(n)]
    return synth.noisy(g, base, 0.01), moved


@pytest.mark.parametrize("name", CONFIGS)
def test_pair_matches_the_port(name):
    from flowreg3d_tpu_torch import get_displacement, imregister_wrapper

    cfg = _config(name)
    params = solver_params(cfg["flow"])
    C = cfg["channels"]
    fixed, (moving,) = _volumes(1, C)
    weight = cfg["flow"].get("weight")
    flow = get_displacement(fixed, moving, device="cpu",
                            const_assumption="gc", weight=weight, **params)
    reg = imregister_wrapper(moving, flow[..., 0], flow[..., 1],
                             flow[..., 2], fixed, "cubic", device="cpu")
    wvol = plain.weight_volume(weight or [1.0] * C, SHAPE, C,
                               torch.device("cpu"))
    flow_r, reg_r = plain.register(fixed, moving, torch.zeros(SHAPE + (3,)),
                                   wvol, params)
    assert float(flow.abs().max()) > 0.01
    assert torch.equal(flow, flow_r)
    assert torch.equal(reg, reg_r)


@pytest.mark.parametrize("name", CONFIGS)
def test_recording_matches_the_port(name):
    from flowreg3d_tpu_torch.pipeline import OFOptions, compensate_arr_3D

    cfg = _config(name)
    flow = dict(cfg["flow"], buffer_size=3, weight=[0.5, 0.5],
                sigma=[[1.0, 1.0, 1.0, 0.1], [1.0, 1.0, 1.0, 0.1]])
    fixed, moved = _volumes(7, 2)
    frames = synth.to_u16_on_host(100 + 2000 * torch.stack(moved))
    reference = frames[:4].astype(np.float64).mean(axis=0)
    registered, flows = compensate_arr_3D(frames, reference,
                                          OFOptions(**flow), device="cpu")
    ref = refp.check_frames(frames, reference, flows, range(7),
                            solver_params(flow), flow["weight"],
                            flow["sigma"], 3, torch.device("cpu"))
    assert registered.dtype == np.float64
    for t, (flow_r, reg_r) in ref.items():
        assert np.array_equal(flows[t], flow_r.numpy()), t
        assert np.array_equal(registered[t], reg_r.numpy()), t


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0000002])
    assert plain.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10,
                                         1.0 + 2 ** -10, -3.0]
    a = torch.randn(5, 7)
    assert not torch.equal(plain.tf32_matmul(a, a.T), a @ a.T)
