"""Variational optical-flow core: motion tensors, level solvers, the
coarse-to-fine pyramid (counterpart of ``flowreg3d_tpu/core``)."""

from flowreg3d_tpu_torch.core.pyramid import get_displacement
from flowreg3d_tpu_torch.core.solver2d import compute_flow

__all__ = ["get_displacement", "compute_flow"]
