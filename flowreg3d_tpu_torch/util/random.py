"""Deterministic seeding across python, numpy and torch.

Counterpart of ``flowreg3d_tpu/util/random.py``: ``fix_seed`` seeds python,
numpy's legacy state, a stored ``numpy.random.Generator`` and torch (every
CUDA device included); ``get_torch_generator`` takes the place of JAX's
``get_jax_key``: each call with ``split`` returns a ``torch.Generator`` on
its own stream, spawned from the stored seed by a
``numpy.random.SeedSequence``, so repeated consumers get independent
streams from one seed as ``jax.random.split`` gives them.

``deterministic`` turns on ``torch.use_deterministic_algorithms(True,
warn_only=True)``, as the JAX package's ``fix_seed`` does when torch is
importable. The flag is process-global: under it every ``torch.empty`` is
filled and each nondeterministic CUDA op warns; turn it off again with
``torch.use_deterministic_algorithms(False)``.
"""

import random as _py_random

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device

_state = {"np_rng": None, "seed": None, "spawned": 0}


def fix_seed(seed=0, deterministic=True):
    """Seed python, numpy (legacy + Generator) and torch; returns the seed."""
    seed = int(seed)
    _py_random.seed(seed)
    np.random.seed(seed)
    _state["np_rng"] = np.random.default_rng(seed)
    _state["seed"] = seed
    _state["spawned"] = 0
    torch.manual_seed(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    return seed


def get_numpy_rng():
    if _state["np_rng"] is None:
        fix_seed(0)
    return _state["np_rng"]


def _stream_seed(seed, index):
    """A 64-bit seed for stream ``index`` of ``seed`` (index 0: the base)."""
    # the index-th child of SeedSequence(seed).spawn(...)
    key = () if index == 0 else (index - 1,)
    seq = np.random.SeedSequence(seed, spawn_key=key)
    return int(seq.generate_state(1, np.uint64)[0])


def get_torch_generator(device=None, split=True):
    """A ``torch.Generator`` on ``device`` (None means 'cuda'), seeded from
    the stored seed. With ``split`` (default) each call returns the next
    spawned stream; without it, the base stream."""
    dev = resolve_device(device)
    if _state["seed"] is None:
        fix_seed(0)
    index = 0
    if split:
        _state["spawned"] += 1
        index = _state["spawned"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(_stream_seed(_state["seed"], index))
    return gen


def get_seed():
    return _state["seed"]
