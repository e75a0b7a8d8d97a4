"""Port parity: the exact 5^3 median against the JAX package and scipy.

The median returns one of its inputs, so the bound is exact equality.
On CPU tensors the kernel wrapper runs its plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import median_filter

from flowreg3d_tpu.ops.filters import median_filter_5x5x5 as jax_median

from flowreg3d_tpu_torch.ops import median_kernel
from flowreg3d_tpu_torch.ops.filters import median_filter_5x5x5

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(7, 40, 50), (6, 8, 9), (5, 33, 29)])
def test_median_exact_vs_jax_and_scipy(shape):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    got = median_filter_5x5x5(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_median(x)))
    np.testing.assert_array_equal(got, median_filter(x, size=5,
                                                     mode="mirror"))


def test_median_with_ties_exact():
    # few distinct values: many ties inside every window
    x = np.random.default_rng(3).integers(0, 4, (6, 12, 14)).astype(np.float32)
    got = median_filter_5x5x5(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, median_filter(x, size=5,
                                                     mode="mirror"))


def test_batched_and_single_wrappers_match_plain():
    x = np.random.default_rng(4).random((3, 6, 11, 13)).astype(np.float32)
    xt = torch.from_numpy(x)
    before = median_kernel.median5.launches
    batched = median_kernel.median_filter_5x5x5_batched(xt)
    for b in range(3):
        want = median_filter(x[b], size=5, mode="mirror")
        np.testing.assert_array_equal(batched[b].numpy(), want)
        np.testing.assert_array_equal(
            median_kernel.median_filter_5x5x5_single(xt[b]).numpy(), want)
    # CPU tensors take the plain version: no kernel launch is counted
    assert median_kernel.median5.launches == before


def test_median_float64_plain():
    x = np.random.default_rng(5).random((6, 9, 10))
    got = median_filter_5x5x5(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), median_filter(
        x, size=5, mode="mirror"))


def test_slabbed_plain_equals_one_slab(monkeypatch):
    x = torch.from_numpy(
        np.random.default_rng(6).random((2, 9, 10, 11)).astype(np.float32))
    xp = median_kernel.mirror_pad2(x)
    whole = median_kernel.median5_plain(xp)
    monkeypatch.setattr(median_kernel, "_SLAB_BYTES", 1)   # one plane a slab
    assert torch.equal(median_kernel.median5_plain(xp), whole)


def test_kernel_network_table_selects_the_median():
    """csrc/median5.cu's compare-exchange table is median_network(), and
    the network leaves the exact rank-62 value at index 62 (ties too)."""
    src = (Path(median_kernel.__file__).parents[1] / "csrc" / "median5.cu")
    table = tuple((int(i), int(j)) for i, j in
                  re.findall(r"CE\((\d+), (\d+)\);", src.read_text()))
    assert table == median_kernel.median_network()
    rng = np.random.default_rng(7)
    for trial in range(200):
        v = (rng.integers(0, 6, 125) if trial % 2 else rng.random(125))
        a = list(v.astype(np.float32))
        for i, j in table:
            a[i], a[j] = min(a[i], a[j]), max(a[i], a[j])
        assert a[62] == np.sort(v.astype(np.float32))[62]
