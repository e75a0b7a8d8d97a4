"""flowreg3d_tpu_torch — the PyTorch + CUDA port of flowreg3d_tpu.

Dense 3D variational optical flow (coarse-to-fine pyramid + red-black SOR
solver, constant or flow-driven diffusivity), backward warping and the
in-memory motion-correction pipeline (``flowreg3d_tpu_torch.pipeline``),
written in PyTorch with hand-written CUDA kernels for the SOR half-sweeps,
the diffusivity field, the B-spline sampling and the 5^3 median (``csrc/``).
The layouts are the JAX package's:

  single volume  (Z, Y, X, C)
  flow field     (Z, Y, X, 3) with last axis [dx(u), dy(v), dz(w)]
  solver stacks  channel-leading (10, C, p, m, n)

Entry points take ``device=None``, which means 'cuda'; without CUDA they
raise unless the caller passes ``device='cpu'``.
"""

from flowreg3d_tpu_torch.core.pyramid import (build_pyramid, get_displacement,
                                              pyramid_config_key)
from flowreg3d_tpu_torch.ops.warp import imregister_wrapper

__version__ = "0.1.0"

__all__ = ["get_displacement", "imregister_wrapper", "build_pyramid",
           "pyramid_config_key", "__version__"]
