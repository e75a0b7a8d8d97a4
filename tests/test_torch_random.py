"""Port parity: seeding (``flowreg3d_tpu_torch.util.random``) against the
JAX package's ``flowreg3d_tpu.util.random``, on the CPU.

After either package's ``fix_seed(s)`` the python, numpy legacy and numpy
Generator draws are equal, and ``get_seed`` agrees; ``get_torch_generator``
(the port's counterpart of ``get_jax_key``) repeats under one seed and
gives a new stream on each split call. Both ``fix_seed``s turn on torch's
process-global deterministic mode, so every test restores it in a
finalizer.
"""

import random

import numpy as np
import pytest
import torch

from flowreg3d_tpu.util import random as jrandom

from flowreg3d_tpu_torch.util import random as trandom


@pytest.fixture(autouse=True)
def restore_deterministic_mode():
    mode = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    yield
    torch.use_deterministic_algorithms(mode, warn_only=warn_only)


def _draws(module):
    return (random.random(), np.random.random(3).tolist(),
            module.get_numpy_rng().random(4).tolist(),
            module.get_numpy_rng().integers(0, 1000, 3).tolist())


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fix_seed_draws_match_jax(seed):
    assert trandom.fix_seed(seed) == seed
    got = _draws(trandom)
    assert jrandom.fix_seed(seed) == seed
    want = _draws(jrandom)
    assert got == want
    assert trandom.get_seed() == jrandom.get_seed() == seed


def test_deterministic_flag():
    torch.use_deterministic_algorithms(False)
    trandom.fix_seed(3, deterministic=False)
    assert not torch.are_deterministic_algorithms_enabled()
    trandom.fix_seed(3)
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.is_deterministic_algorithms_warn_only_enabled()


def test_torch_generator_repeats_and_splits():
    trandom.fix_seed(11)
    first = [torch.rand(5, generator=trandom.get_torch_generator("cpu"))
             for _ in range(3)]
    base = torch.rand(5, generator=trandom.get_torch_generator(
        "cpu", split=False))
    again = torch.rand(5, generator=trandom.get_torch_generator(
        "cpu", split=False))
    assert torch.equal(base, again)
    for i in range(3):
        assert not torch.equal(first[i], base)
        for j in range(i):
            assert not torch.equal(first[i], first[j])
    trandom.fix_seed(11)
    second = [torch.rand(5, generator=trandom.get_torch_generator("cpu"))
              for _ in range(3)]
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    trandom.fix_seed(12)
    other = torch.rand(5, generator=trandom.get_torch_generator("cpu"))
    assert not torch.equal(other, first[0])


def test_unseeded_state_defaults_to_zero(monkeypatch):
    monkeypatch.setitem(trandom._state, "np_rng", None)
    monkeypatch.setitem(trandom._state, "seed", None)
    rng = trandom.get_numpy_rng()
    assert trandom.get_seed() == 0
    assert rng.random() == np.random.default_rng(0).random()


def test_torch_generator_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    trandom.fix_seed(0, deterministic=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trandom.get_torch_generator()
