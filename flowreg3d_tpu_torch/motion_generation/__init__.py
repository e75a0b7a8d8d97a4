"""Synthetic 3D motion generation and evaluation (counterpart of
``flowreg3d_tpu/motion_generation``): ground-truth displacement fields from
composed augmentors (host numpy, the JAX package's draws bit for bit), the
forward splat and backward warp on the device, and the EPE / improvement /
PSNR metrics."""

from flowreg3d_tpu_torch.motion_generation.evaluation import (
    evaluate_flow_accuracy,
    improvement_ratio,
    psnr,
)
from flowreg3d_tpu_torch.motion_generation.motion_generators import (
    Expansion3DFlowAugmentor,
    FlowGenerator3D,
    Jitter3DFlowAugmentor,
    Random3DFlowAugmentor,
    Rotational3DFlowAugmentor,
    Shear3DFlowAugmentor,
    Translational3DFlowAugmentor,
    get_default_3d_generator,
    get_high_disp_3d_generator,
    get_low_disp_3d_generator,
    get_test_3d_generator,
    warp_volume_3d,
    warp_volume_backward,
    warp_volume_splat3d,
)

__all__ = [
    "FlowGenerator3D",
    "Rotational3DFlowAugmentor",
    "Translational3DFlowAugmentor",
    "Jitter3DFlowAugmentor",
    "Expansion3DFlowAugmentor",
    "Random3DFlowAugmentor",
    "Shear3DFlowAugmentor",
    "warp_volume_3d",
    "warp_volume_splat3d",
    "warp_volume_backward",
    "get_default_3d_generator",
    "get_low_disp_3d_generator",
    "get_test_3d_generator",
    "get_high_disp_3d_generator",
    "evaluate_flow_accuracy",
    "improvement_ratio",
    "psnr",
]
