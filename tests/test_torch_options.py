"""Port parity: the port's pydantic-free ``OFOptions`` against the JAX
package's ``OFOptions`` (pydantic), construction by construction.

Compared exactly: every field after validation (enums by value), the
quality logic (``quality_setting``, ``effective_min_level``), ``to_dict``,
``get_sigma_at`` and ``get_weight_at``; invalid values raise in both.
``convert.options_from_jax`` carries a JAX ``OFOptions`` across unchanged.
"""

import dataclasses
from enum import Enum

import numpy as np
import pytest

from flowreg3d_tpu.io.array import ArrayReader3D as JaxArrayReader
from flowreg3d_tpu.pipeline import OFOptions as JaxOFOptions

from flowreg3d_tpu_torch.convert import options_from_jax
from flowreg3d_tpu_torch.io.array import ArrayReader3D
from flowreg3d_tpu_torch.pipeline import OFOptions, QualitySetting

CONSTRUCTIONS = [
    {},
    dict(alpha=2.0, min_level=0, levels=50, iterations=20, update_lag=10,
         eta=0.8, a_smooth=0.5, a_data=0.45),
    dict(alpha=(1.0, 2.0)),
    dict(alpha=[1.0, 2.0, 3.0], weight=[2.0, 2.0]),
    dict(weight=np.array([1.0, 3.0]), sigma=[1.0, 2.0, 0.5]),
    dict(sigma=[[1, 1, 1, 0.1], [2, 2, 2, 0.2]], min_level=-1,
         quality_setting="balanced"),
    dict(min_level=-1, quality_setting="fast"),
    dict(min_level=-1, quality_setting="custom"),
    dict(min_level=3, quality_setting="balanced", constancy_assumption="gray"),
    dict(output_format="ARRAY", interpolation_method="linear",
         channel_normalization="separate", weight=[0.2, 0.3, 0.5]),
    dict(quality_setting="fast", min_level=0, levels=4, iterations=8,
         alpha=(1.5, 1.5, 1.5), weight=[1.0], sigma=[1.0, 1.0, 1.0, 0.1],
         a_smooth=0.5),
]


def _plain(v):
    if isinstance(v, Enum):
        return v.value
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _fields(opts):
    return {f.name: _plain(getattr(opts, f.name))
            for f in dataclasses.fields(OFOptions) if f.init}


@pytest.mark.parametrize("kw", CONSTRUCTIONS)
def test_construction_matches_jax(kw):
    got, want = OFOptions(**kw), JaxOFOptions(**kw)
    assert _fields(got) == _fields(want)
    assert got.quality_setting.value == want.quality_setting.value
    assert got.effective_min_level == want.effective_min_level
    assert got.to_dict() == want.to_dict()
    for c in range(3):
        np.testing.assert_array_equal(got.get_sigma_at(c),
                                      want.get_sigma_at(c))
        for n in (1, 2, 3):
            assert got.copy().get_weight_at(c, n) == \
                want.model_copy(deep=True).get_weight_at(c, n)
    assert _fields(options_from_jax(want)) == _fields(want)
    assert options_from_jax(want).effective_min_level == \
        want.effective_min_level


@pytest.mark.parametrize("kw", [
    dict(alpha=-1.0), dict(alpha=(1.0, 2.0, 3.0, 4.0)), dict(sigma=[1.0, 2.0]),
    dict(levels=0), dict(min_level=-2), dict(eta=0.0), dict(eta=1.5),
    dict(a_data=0.0), dict(a_smooth=-0.1), dict(iterations=2.5),
    dict(quality_setting="best"), dict(no_such_field=1)])
def test_invalid_values_raise_in_both(kw):
    with pytest.raises(Exception):
        JaxOFOptions(**kw)
    with pytest.raises((ValueError, TypeError)):
        OFOptions(**kw)


def test_copy_is_deep_and_reference_frames():
    vol = np.random.default_rng(0).random((3, 4, 5, 6, 1)).astype(np.float32)
    opts = OFOptions(reference_frames=[0, 2, 9])
    dup = opts.copy()
    dup.reference_frames.append(1)
    assert opts.reference_frames == [0, 2, 9]
    jax_opts = JaxOFOptions(reference_frames=[0, 2, 9])
    np.testing.assert_array_equal(
        opts.get_reference_frame(ArrayReader3D(vol)),
        jax_opts.get_reference_frame(JaxArrayReader(vol)))
    ref = vol[1]
    assert OFOptions(reference_frames=ref).get_reference_frame() is ref
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        OFOptions(reference_frames="ref.tif").get_reference_frame()


def test_quality_custom_roundtrip():
    o = OFOptions(min_level=2, quality_setting="fast")
    assert o.quality_setting == QualitySetting.CUSTOM
    assert o._quality_setting_old == QualitySetting.FAST
