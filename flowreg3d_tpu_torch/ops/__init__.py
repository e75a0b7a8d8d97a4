"""Numeric primitives: resize, warp, filters, gradients, xcorr
(counterpart of ``flowreg3d_tpu/ops``)."""

from flowreg3d_tpu_torch.ops.filters import (StreamingTemporalGaussian,
                                             apply_gaussian_filter,
                                             gaussian_filter_3d,
                                             median_filter_5x5x5, normalize)
from flowreg3d_tpu_torch.ops.gradients import divergence, gradient_zyx
from flowreg3d_tpu_torch.ops.resize import (imresize2d_gauss_cubic,
                                            imresize_fused_gauss_cubic3D,
                                            resize_batch, resize_volume)
from flowreg3d_tpu_torch.ops.warp import (imregister_wrapper,
                                          map_coordinates_cubic,
                                          map_coordinates_linear)
from flowreg3d_tpu_torch.ops.xcorr import phase_cross_correlation

__all__ = [
    "normalize",
    "apply_gaussian_filter",
    "gaussian_filter_3d",
    "median_filter_5x5x5",
    "StreamingTemporalGaussian",
    "gradient_zyx",
    "divergence",
    "resize_volume",
    "resize_batch",
    "imresize_fused_gauss_cubic3D",
    "imresize2d_gauss_cubic",
    "imregister_wrapper",
    "map_coordinates_cubic",
    "map_coordinates_linear",
    "phase_cross_correlation",
]
