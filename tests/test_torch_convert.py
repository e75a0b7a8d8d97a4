"""Port parity end to end: the JAX pyramid's configuration key and arrays
carried across by ``flowreg3d_tpu_torch.convert`` give the same flow.

Case and parameters: tests/test_torch_pyramid.py. The bound is the
accuracy gate of tests/pipeline/test_accuracy_gate.py (flow EPE <= 0.25,
corrected volumes agree at >= 40 dB), not max |flow difference| <= 1e-3:
chained over nine levels the solver amplifies last-bit differences past
1e-3 on this case: the JAX package's own eager and jitted runs of the
same pyramid, and the port's float32 and float64 runs, differ by more
than that too, while the corrected volumes agree.
"""

import numpy as np
import pytest
import torch

from flowreg3d_tpu.core import pyramid as jpyr
from flowreg3d_tpu.motion_generation.evaluation import psnr
from flowreg3d_tpu.ops.warp import imregister_wrapper as jax_warp

from flowreg3d_tpu_torch import convert
from flowreg3d_tpu_torch.core import pyramid as tpyr
from flowreg3d_tpu_torch.ops.warp import warp as t_warp

from tests.test_torch_pyramid import PARAMS, SHAPE, pair

torch.set_num_threads(1)


def test_config_key_round_trip():
    jkey = jpyr.pyramid_config_key(SHAPE, 1, const_assumption="gc",
                                   **PARAMS)
    assert convert.config_from_jax_key(jkey) == tpyr.pyramid_config_key(
        SHAPE, 1, **PARAMS)
    jkey_plain = jpyr.pyramid_config_key(SHAPE, 1, use_pallas=False,
                                         **PARAMS)
    assert convert.config_from_jax_key(jkey_plain)[-1] is False
    with pytest.raises(ValueError):
        convert.config_from_jax_key(jkey[:-1])


def test_end_to_end_through_convert():
    fixed, moving, uvw, weight = pair()
    jkey = jpyr.pyramid_config_key(SHAPE, 1, **PARAMS)
    want = np.asarray(jpyr._build_pyramid_fn(*jkey)(fixed, moving, uvw,
                                                   weight))
    pyramid = tpyr.build_pyramid(*convert.config_from_jax_key(jkey),
                                 device="cpu")
    got = pyramid(*convert.arrays_to_torch(fixed, moving, uvw, weight,
                                           device="cpu")).numpy()
    assert got.shape == SHAPE + (3,) and np.isfinite(got).all()

    b = SHAPE[0] // 4                       # the gate's boundary crop rule
    crop = (slice(b, -b),) * 3
    epe = float(np.mean(np.linalg.norm(got[crop] - want[crop], axis=-1)))
    assert epe <= 0.25, f"port-vs-JAX flow EPE {epe} > 0.25"
    corr_port = t_warp(torch.from_numpy(moving),
                       *(torch.from_numpy(got[..., k]) for k in range(3)),
                       torch.from_numpy(fixed), 3).numpy()
    corr_jax = np.asarray(jax_warp(moving, *(want[..., k] for k in range(3)),
                                   fixed))
    agree = psnr(corr_port[crop], corr_jax[crop], data_range=1.0)
    assert agree >= 40.0, f"corrected volumes agree at {agree} dB < 40"


def test_arrays_to_torch_checks_layout():
    fixed, moving, uvw, weight = pair()
    with pytest.raises(ValueError):
        convert.arrays_to_torch(fixed, moving, uvw[..., :2], weight, "cpu")
    out = convert.arrays_to_torch(fixed, moving, uvw, weight, "cpu")
    assert [tuple(t.shape) for t in out] == [a.shape for a in
                                             (fixed, moving, uvw, weight)]
