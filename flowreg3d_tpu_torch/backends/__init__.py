"""Deep-flow displacement backends (counterpart of
``flowreg3d_tpu/backends``).

Backends implement the ``get_displacement`` protocol
``fn(fixed, moving, uvw=..., **params) -> (Z, Y, X, 3)`` and plug into the
pipeline through ``RegistrationConfig(get_displacement_func=...)`` or the
``runtime.register_flow_backend`` registry (``flow_backend="volraft"`` /
``"volraft-mock"``, registered when this package is imported).
"""

from flowreg3d_tpu_torch.backends.volraft import (PatchRigidFlowBackend,
                                                  VolRAFTBackend, load_volraft)

__all__ = ["PatchRigidFlowBackend", "VolRAFTBackend", "load_volraft"]
