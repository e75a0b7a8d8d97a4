"""Filters on the slice's path.

Counterpart of ``flowreg3d_tpu/ops/filters.py:median_filter_5x5x5``; the
preprocessing filters of that module are not ported yet.
"""

from flowreg3d_tpu_torch.ops.median_kernel import median5_plain, mirror_pad2


def median_filter_5x5x5(x):
    """Exact 5x5x5 median of a (Z,Y,X) tensor, boundary 'mirror'
    (scipy.ndimage.median_filter(size=5, mode='mirror')), plain PyTorch."""
    return median5_plain(mirror_pad2(x[None]))[0]
