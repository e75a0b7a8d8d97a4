"""Host-side utilities: rigid prealignment and seeding (counterpart of
``flowreg3d_tpu/util``; ``get_torch_generator`` takes the place of JAX's
``get_jax_key``)."""

from flowreg3d_tpu_torch.util.random import fix_seed, get_torch_generator
from flowreg3d_tpu_torch.util.xcorr_prealignment import estimate_rigid_xcorr_3d

__all__ = ["estimate_rigid_xcorr_3d", "fix_seed", "get_torch_generator"]
