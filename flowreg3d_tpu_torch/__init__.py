"""flowreg3d_tpu_torch — the PyTorch + CUDA port of flowreg3d_tpu.

Dense 3D variational optical flow (coarse-to-fine pyramid + red-black SOR
solver, constant or flow-driven diffusivity), backward warping, the
streaming motion-correction pipeline (``flowreg3d_tpu_torch.pipeline``),
I/O, the CLI, synthetic motion generation (``motion_generation``), deep-flow
backends (``backends``) and single- and multi-device execution, written in
PyTorch with hand-written CUDA kernels for the SOR half-sweeps, the
diffusivity field, the B-spline sampling and the 5^3 median (``csrc/``).
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

_PIPELINE_NAMES = {
    "OFOptions", "OutputFormat", "QualitySetting", "RegistrationConfig",
    "BatchMotionCorrector", "compensate_recording", "compensate_arr",
    "compensate_arr_3D", "compensate_inplace",
}


def __getattr__(name):
    # pipeline symbols are lazy so `import flowreg3d_tpu_torch` stays light
    if name in _PIPELINE_NAMES:
        import flowreg3d_tpu_torch.pipeline as _p

        return getattr(_p, name)
    raise AttributeError(
        f"module 'flowreg3d_tpu_torch' has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = ["get_displacement", "imregister_wrapper", "build_pyramid",
           "pyramid_config_key", "OFOptions", "compensate_recording",
           "compensate_arr", "__version__"]
