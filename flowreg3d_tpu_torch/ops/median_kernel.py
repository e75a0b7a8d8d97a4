"""Exact 5x5x5 median: the CUDA kernel ``median5_f32`` (csrc/median5.cu)
and its plain PyTorch version.

Counterpart of ``flowreg3d_tpu/ops/median_pallas.py``. ``median5`` takes
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from flowreg3d_tpu_torch import _ext

TAPS = 125
RANK = 62
# outputs a block of csrc/median5.cu computes: TILE_X along x, TILE_Y along y
TILE_X, TILE_Y = 28, 8

# z-planes per slab of the plain version: bounds its 125-tap patch stack
_SLAB_BYTES = 256 << 20


def _oddeven_merge_pairs(lo, cnt, r, pairs):
    """Batcher's odd-even merge of the two sorted halves of [lo, lo+cnt)."""
    step = r * 2
    if step < cnt:
        _oddeven_merge_pairs(lo, cnt, step, pairs)
        _oddeven_merge_pairs(lo + r, cnt, step, pairs)
        for i in range(lo + r, lo + cnt - r, step):
            pairs.append((i, i + r))
    else:
        pairs.append((lo, lo + r))


def _oddeven_merge_sort_pairs(n):
    """Batcher odd-even mergesort compare-exchange pairs for power-of-2 n."""
    pairs = []

    def sort(lo, cnt):
        if cnt > 1:
            m = cnt // 2
            sort(lo, m)
            sort(lo + m, m)
            _oddeven_merge_pairs(lo, cnt, 1, pairs)

    sort(0, n)
    return pairs


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


class _Poset:
    """What is known about the order of the values in a network's registers:
    ``le[i, j]`` means register i holds a value <= register j's. A compare-
    exchange whose outcome is known is dropped (or becomes a free renaming),
    so sorted inputs and +inf pads cost nothing."""

    def __init__(self, n):
        self.le = np.eye(n, dtype=bool)
        self.pairs = []

    def ce(self, a, b):
        """Compare-exchange of registers a, b; returns (min reg, max reg)."""
        le = self.le
        if le[a, b]:
            return a, b
        if le[b, a]:
            return b, a
        below_a, below_b = le[:, a].copy(), le[:, b].copy()
        above_a, above_b = le[a, :].copy(), le[b, :].copy()
        le[:, a], le[a, :] = below_a & below_b, above_a | above_b
        le[:, b], le[b, :] = below_a | below_b, above_a & above_b
        le[a, a] = le[b, b] = le[a, b] = True
        le[b, a] = False
        self.pairs.append((a, b))
        return a, b


def _cone(pairs, outputs):
    """The pairs in the dependency cone of the output registers."""
    needed, kept = set(outputs), []
    for i, j in reversed(pairs):
        if i in needed or j in needed:
            kept.append((i, j))
            needed.update((i, j))
    return tuple(reversed(kept))


def _run(n_real, n_regs, wires, pairs, sorted_runs):
    """Run the position network ``pairs`` over ``wires`` (position ->
    register); registers >= n_real are +inf pads, ``sorted_runs`` lists
    register ranges known sorted. Returns (register pairs, wires)."""
    po = _Poset(n_regs)
    po.le[:, n_real:] = True
    for lo, hi in sorted_runs:
        for k in range(lo, hi):
            po.le[k, k:hi] = True
    wires = list(wires)
    for i, j in pairs:
        wires[i], wires[j] = po.ce(wires[i], wires[j])
    assert all(j < n_real for p in po.pairs for j in p)
    return po.pairs, wires


@functools.cache
def sort_network(n):
    """(pairs, outs): compare-exchange pairs (i, j: min to register i, max to
    j) that sort registers 0..n-1, and the register holding each rank.
    Batcher's mergesort on the next power of 2, the +inf pads pruned."""
    p = _pow2(n)
    pairs, wires = _run(n, p, range(p), _oddeven_merge_sort_pairs(p), ())
    outs = tuple(wires[:n])
    return _cone(pairs, outs), outs


@functools.cache
def merge_network(n, m, lo=0, hi=None):
    """(pairs, outs): compare-exchanges that merge sorted registers 0..n-1
    with sorted registers n..n+m-1, pruned to the cone of merged ranks
    lo..hi (all by default), and the registers holding those ranks.

    Batcher's odd-even merge of two power-of-2 blocks, each list padded
    with +inf; pairs whose outcome the inputs' order already fixes are
    dropped, and every pair of the result is between real values.
    """
    hi = n + m - 1 if hi is None else hi
    p = _pow2(max(n, m))
    pad_a = range(n + m, n + m + p - n)
    pad_b = range(n + m + p - n, n + m + 2 * p - n - m)
    wires = [*range(n), *pad_a, *range(n, n + m), *pad_b]
    merge = []
    _oddeven_merge_pairs(0, 2 * p, 1, merge)
    pairs, wires = _run(n + m, n + m + 2 * p - n - m, wires, merge,
                        ((0, n), (n, n + m)))
    outs = tuple(wires[lo:hi + 1])
    return _cone(pairs, outs), outs


# The tile networks of csrc/median5.cu, by the name of their device
# function: each sorts or merges the lists of one stage (see its header).
# Ranks 37..62 of the 100 values of four neighbouring planes are all that
# can decide a median whose window holds those 100 and 25 more (forgetful
# selection: the 37 lowest and the 37 highest are beyond reach).
KEEP_LO, KEEP_HI = RANK - (TAPS - 100), RANK
TILE_NETWORKS = {
    "sort5": lambda: sort_network(5),
    "merge_5_5": lambda: merge_network(5, 5),
    "merge_10_10": lambda: merge_network(10, 10),
    "merge_20_5": lambda: merge_network(20, 5),
    "merge_25_25": lambda: merge_network(25, 25),
    "merge_50_50_keep": lambda: merge_network(50, 50, KEEP_LO, KEEP_HI),
}


def rank_of_two(k, p, t):
    """Rank ``t`` (0-based) of the union of sorted ``k`` and sorted ``p``
    (len(p) <= t + 1 <= len(k)): min over i of max(p[i-1], k[t-i]), i.e.
    ``len(p)`` max and ``len(p)`` min; exact under ties. Works on numpy
    arrays or Python floats; csrc/median5.cu's ``rank_of_two`` is this."""
    best = k[t]
    for i in range(1, len(p) + 1):
        best = np.minimum(best, np.maximum(p[i - 1], k[t - i]))
    return best


def network_source(name):
    """The device function of csrc/median5.cu for TILE_NETWORKS[name]:
    ``CE(i, j)`` compare-exchanges on ``v``, then ``O(rank, reg)`` copies
    of the result registers to ``o``."""
    pairs, outs = TILE_NETWORKS[name]()
    n_in = 1 + max(max(max(p) for p in pairs), max(outs))
    lines = [f"// {name}: {len(pairs)} compare-exchanges, generated by "
             "ops/median_kernel.py",
             f"__device__ __forceinline__ void {name}(",
             f"    float (&v)[{n_in}], float (&o)[{len(outs)}]) {{"]
    for stmts in (["CE(%d, %d);" % p for p in pairs],
                  ["O(%d, %d);" % ro for ro in enumerate(outs)]):
        line = " "
        for st in stmts:
            if len(line) + 1 + len(st) > 79:
                lines.append(line)
                line = " "
            line += " " + st
        lines.append(line)
    return "\n".join(lines + ["}"]) + "\n"


def tile_compare_exchanges():
    """Compare-exchanges per output of median5_f32 amortised over a block
    tile of TX x TY outputs (min/max of rank_of_two counted as half a
    compare-exchange), and the per-stage counts."""
    n = {k: len(f()[0]) for k, f in TILE_NETWORKS.items()}
    cx, cy = TILE_X + 4, TILE_Y + 4
    stage = {
        "z-columns": cy * cx * n["sort5"],
        "planes": (TILE_Y // 2) * cx * (2 * n["merge_5_5"] + n["merge_10_10"]
                                        + 2 * n["merge_20_5"]),
        "plane pairs": TILE_Y * (TILE_X // 2 + 1) * n["merge_25_25"],
        "select": TILE_Y * (TILE_X // 2) * (n["merge_50_50_keep"] + 2 * 25),
    }
    outs = TILE_X * TILE_Y
    return sum(stage.values()) / outs, {k: v / outs for k, v in stage.items()}


def median5_plain(xp):
    """(B, Z+4, Y+4, X+4) padded stack -> (B, Z, Y, X) of exact 5^3 medians
    (rank 62 of 125), by unfold + torch.median over z-slabs."""
    B, Zp, Yp, Xp = xp.shape
    Z, Y, X = Zp - 4, Yp - 4, Xp - 4
    per_plane = B * Y * X * 125 * xp.element_size()
    slab = max(1, min(Z, _SLAB_BYTES // per_plane))
    outs = []
    for z0 in range(0, Z, slab):
        zs = min(slab, Z - z0)
        patches = (xp[:, z0:z0 + zs + 4].unfold(1, 5, 1).unfold(2, 5, 1)
                   .unfold(3, 5, 1))              # (B, zs, Y, X, 5, 5, 5)
        outs.append(patches.reshape(B, zs, Y, X, 125).median(dim=-1).values)
    return torch.cat(outs, dim=1)


def median5(xp):
    """Exact 5^3 medians of a padded (B, Z+4, Y+4, X+4) stack."""
    if xp.device.type == "cpu":
        return median5_plain(xp)
    _ext.check_cuda(xp, "median5 xp", 4, torch.float32)
    B, Zp, Yp, Xp = xp.shape
    if min(Zp, Yp, Xp) < 5:
        raise ValueError(f"median5: padded shape {tuple(xp.shape)} too small")
    out = torch.empty((B, Zp - 4, Yp - 4, Xp - 4), dtype=xp.dtype,
                      device=xp.device)
    with torch.cuda.device(xp.device):
        rc = _ext.lib().median5_f32(xp.data_ptr(), out.data_ptr(), B, Zp - 4,
                                    Yp - 4, Xp - 4, _ext.stream_of(xp))
    _ext.raise_on_error(rc, "median5_f32")
    median5.launches += 1
    return out


median5.launches = 0


def mirror_pad2(x):
    """Pad the three trailing axes of (B,Z,Y,X) by 2 with mirror boundaries
    (numpy/jnp 'reflect', scipy 'mirror'); the batch axis is not padded."""
    return F.pad(x, (2, 2, 2, 2, 2, 2), mode="reflect").contiguous()


def median_filter_5x5x5_batched(x):
    """Exact 5^3 median of each volume of a (B,Z,Y,X) stack, one launch."""
    return median5(mirror_pad2(x))


def median_filter_5x5x5_single(x):
    """Exact 5^3 median of one (Z,Y,X) volume through the kernel."""
    return median5(mirror_pad2(x[None]))[0]
