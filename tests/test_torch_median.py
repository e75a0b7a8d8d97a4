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


def _net(name, v):
    """Apply TILE_NETWORKS[name] along the last axis of ``v``."""
    pairs, outs = median_kernel.TILE_NETWORKS[name]()
    v = v.copy()
    for i, j in pairs:
        lo = np.minimum(v[..., i], v[..., j])
        v[..., j] = np.maximum(v[..., i], v[..., j])
        v[..., i] = lo
    return v[..., list(outs)]


def _emulate_median5(xp):
    """csrc/median5.cu's median5_kernel in numpy, block by block (every
    block at once), with its clamped loads at ragged edges."""
    B, Zp, Yp, Xp = xp.shape
    Z, Y, X = Zp - 4, Yp - 4, Xp - 4
    tx, ty = median_kernel.TILE_X, median_kernel.TILE_Y
    cx, cy, nm2 = tx + 4, ty + 4, tx // 2 + 1
    nby, nbx = -(-Y // ty), -(-X // tx)
    # stage 1: sorted z-columns of every (yy, xx) of every block's tile
    gy = np.minimum(np.arange(nby)[:, None] * ty + np.arange(cy), Yp - 1)
    gx = np.minimum(np.arange(nbx)[:, None] * tx + np.arange(cx), Xp - 1)
    zz = np.arange(Z)[:, None] + np.arange(5)
    g = xp[:, zz][:, :, :, gy][..., gx]       # (B,Z,5,nby,cy,nbx,cx)
    g = g.transpose(0, 1, 3, 5, 4, 6, 2)       # (B,Z,nby,nbx,cy,cx,5)
    cols = _net("sort5", g)
    # stage 2: the sorted 5x5 (z, y) planes of two rows from six columns
    planes = np.empty(cols.shape[:4] + (ty, cx, 25), xp.dtype)
    for j in range(ty // 2):
        c = [cols[..., 2 * j + i, :, :] for i in range(6)]
        core = _net("merge_10_10", np.concatenate(
            [_net("merge_5_5", np.concatenate(c[1:3], -1)),
             _net("merge_5_5", np.concatenate(c[3:5], -1))], -1))
        planes[..., 2 * j, :, :] = _net(
            "merge_20_5", np.concatenate([core, c[0]], -1))
        planes[..., 2 * j + 1, :, :] = _net(
            "merge_20_5", np.concatenate([core, c[5]], -1))
    # stage 3: sorted pairs of planes at odd x, forgetful merge of two
    # pairs, then rank 25 of those 26 and the fifth plane
    m2 = _net("merge_25_25", np.concatenate(
        [planes[..., 1:2 * nm2:2, :], planes[..., 2:2 * nm2 + 1:2, :]], -1))
    kept = _net("merge_50_50_keep",
                np.concatenate([m2[..., :-1, :], m2[..., 1:, :]], -1))
    out = np.empty(cols.shape[:4] + (ty, tx), xp.dtype)
    for e, first in ((0, 0), (1, 5)):
        p = planes[..., first:first + tx - 1:2, :]
        out[..., e::2] = median_kernel.rank_of_two(
            np.moveaxis(kept, -1, 0), np.moveaxis(p, -1, 0), 25)
    out = out.transpose(0, 1, 2, 4, 3, 5).reshape(B, Z, nby * ty, nbx * tx)
    return out[:, :, :Y, :X]


@pytest.mark.parametrize("shape", [(1, 6, 13, 37), (2, 5, 20, 60),
                                   (1, 7, 9, 9)])
@pytest.mark.parametrize("values", ["random", "ties"])
def test_tile_network_emulation_exact(shape, values):
    """The kernel's tile networks, emulated in numpy over whole grids of
    blocks (ragged edge tiles in y and x included), give the exact rank-62
    value of every window, on random and on few-valued (tied) inputs."""
    rng = np.random.default_rng(sum(shape))
    xp = (rng.integers(0, 4, shape) if values == "ties"
          else rng.standard_normal(shape)).astype(np.float32)
    want = np.sort(np.lib.stride_tricks.sliding_window_view(
        xp, (5, 5, 5), axis=(1, 2, 3)).reshape(
        xp.shape[0], *(n - 4 for n in shape[1:]), 125), -1)[..., 62]
    np.testing.assert_array_equal(_emulate_median5(xp), want)


def test_kernel_network_table_selects_the_median():
    """csrc/median5.cu holds the tile networks as ops/median_kernel.py
    generates them; each sorts, merges or keeps its ranks exactly (ties
    too), and rank_of_two picks the rank of a union of two sorted lists."""
    src = (Path(median_kernel.__file__).parents[1] / "csrc" / "median5.cu"
           ).read_text()
    tile = re.search(r"constexpr int TX = (\d+), TY = (\d+);", src)
    assert tile and tuple(map(int, tile.groups())) == (median_kernel.TILE_X,
                                                       median_kernel.TILE_Y)
    rng = np.random.default_rng(7)
    for name, make in median_kernel.TILE_NETWORKS.items():
        assert median_kernel.network_source(name) in src, name
        pairs, outs = make()
        n_in = 1 + max(max(max(p) for p in pairs), max(outs))
        # sorted inputs per list: merge_a_b takes a sorted a, then b
        sizes = ([1] * n_in if name.startswith("sort")
                 else [int(k) for k in name.split("_")[1:3]])
        for trial in range(100):
            v = (rng.integers(0, 4, n_in) if trial % 2
                 else rng.random(n_in)).astype(np.float32)
            lists, k = [], 0
            for n in sizes:
                lists.append(np.sort(v[k:k + n]))
                k += n
            v = np.concatenate(lists)
            full = np.sort(v)
            lo = median_kernel.KEEP_LO if name.endswith("keep") else 0
            np.testing.assert_array_equal(_net(name, v),
                                          full[lo:lo + len(outs)])
    for trial in range(100):
        k = np.sort(rng.integers(0, 3, 26) if trial % 2 else rng.random(26))
        p = np.sort(rng.integers(0, 3, 25) if trial % 2 else rng.random(25))
        assert median_kernel.rank_of_two(k, p, 25) == np.sort(
            np.concatenate([k, p]))[25]
    per_output, _ = median_kernel.tile_compare_exchanges()
    assert per_output < 300     # against 1184 of the one-thread network
