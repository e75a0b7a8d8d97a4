"""Exact 5x5x5 median: the CUDA kernel ``median5_f32`` (csrc/median5.cu)
and its plain PyTorch version.

Counterpart of ``flowreg3d_tpu/ops/median_pallas.py``. ``median5`` takes
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.
"""

import functools

import torch
import torch.nn.functional as F

from flowreg3d_tpu_torch import _ext

TAPS = 125
RANK = 62

# z-planes per slab of the plain version: bounds its 125-tap patch stack
_SLAB_BYTES = 256 << 20


def _oddeven_merge_sort_pairs(n):
    """Batcher odd-even mergesort compare-exchange pairs for power-of-2 n."""
    pairs = []

    def merge(lo, cnt, r):
        step = r * 2
        if step < cnt:
            merge(lo, cnt, step)
            merge(lo + r, cnt, step)
            for i in range(lo + r, lo + cnt - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, cnt):
        if cnt > 1:
            m = cnt // 2
            sort(lo, m)
            sort(lo + m, m)
            merge(lo, cnt, 1)

    sort(0, n)
    return pairs


@functools.cache
def median_network():
    """Compare-exchange pairs (i < j: min to i, max to j) that leave the
    rank-62 value of 125 inputs at index 62.

    The 128-input Batcher network pruned to the dependency cone of output
    62; the three padding inputs would hold +inf, so the pairs that touch
    them are no-ops and are dropped. csrc/median5.cu holds this list.
    """
    pairs = _oddeven_merge_sort_pairs(128)
    needed = {RANK}
    kept = []
    for i, j in reversed(pairs):
        if i in needed or j in needed:
            kept.append((i, j))
            needed.update((i, j))
    kept.reverse()
    return tuple((i, j) for i, j in kept if j < TAPS)


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
