"""What carries across from the JAX package.

This system has no weights. Its state is the flow configuration (the
JAX package's ``pyramid_config_key`` tuple), the pipeline's options (its
``OFOptions``) and the per-frame arrays: fixed and moving volumes
(Z,Y,X,C), the initial flow ``uvw`` (Z,Y,X,3) that the pipeline chains from
frame to frame, and the data weight (Z,Y,X,C). The helpers read plain
Python / numpy values (attributes, in the options' case), so they import
nothing of the JAX package.
"""

import dataclasses
from enum import Enum

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.pipeline.of_options import OFOptions, QualitySetting

_JAX_KEY_FIELDS = 13
_DTYPES = ("float32", "float64")


def config_from_jax_key(key):
    """The port's ``pyramid_config_key`` tuple from the JAX package's one.

    Same fields in the same order; the last one, JAX's ``use_pallas``
    (None = auto, False = plain XLA), becomes ``use_kernels`` (True unless
    the JAX key asked for the plain path).
    """
    key = tuple(key)
    if len(key) != _JAX_KEY_FIELDS:
        raise ValueError(f"expected a {_JAX_KEY_FIELDS}-field JAX pyramid "
                         f"config key, got {len(key)} fields")
    (shape, n_channels, alpha, update_lag, iterations, min_level, levels,
     eta, a_smooth, a_data, const_assumption, dtype_name, use_pallas) = key
    dtype_name = str(dtype_name)
    if dtype_name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype_name!r}; want {_DTYPES}")
    return (tuple(int(s) for s in shape), int(n_channels),
            tuple(float(a) for a in alpha), int(update_lag), int(iterations),
            int(min_level), int(levels), float(eta), float(a_smooth),
            tuple(float(a) for a in a_data), str(const_assumption),
            dtype_name, use_pallas is not False)


def arrays_to_torch(fixed, moving, uvw, weight, device=None):
    """numpy (Z,Y,X,C) fixed/moving/weight and (Z,Y,X,3) uvw -> tensors on
    ``device`` (None means 'cuda'), dtype kept."""
    dev = resolve_device(device)
    out = []
    for name, a, last in (("fixed", fixed, None), ("moving", moving, None),
                          ("uvw", uvw, 3), ("weight", weight, None)):
        a = np.asarray(a)
        if a.ndim != 4 or (last is not None and a.shape[-1] != last):
            raise ValueError(f"{name}: expected (Z,Y,X,{last or 'C'}), got "
                             f"{a.shape}")
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return tuple(out)


def options_from_jax(jax_options):
    """The port's ``OFOptions`` with every field of a JAX ``OFOptions``
    (enums by value; the open reader/writer are not carried)."""
    kwargs = {}
    for f in dataclasses.fields(OFOptions):
        if f.init:
            v = getattr(jax_options, f.name)
            kwargs[f.name] = v.value if isinstance(v, Enum) else v
    out = OFOptions(**kwargs)
    old = getattr(jax_options, "_quality_setting_old", None)
    if old is not None:
        out._quality_setting_old = QualitySetting(old.value)
    return out
