"""Device resolution for the port's entry points.

``device=None`` means ``"cuda"``. A CUDA request on a host without CUDA
raises: the port never falls back to the CPU on its own. The CPU is used
only when the caller asks for it (the tests do, with ``device="cpu"``).
"""

import torch


def fp32_matmuls():
    """Keep CUDA matmuls and cuDNN convolutions in full fp32 (no TF32).

    The resize, prefilter and warp products feed parity-critical stencils;
    the JAX reference runs them at HIGHEST precision.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """The torch.device to run on; raises if it is CUDA and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "flowreg3d_tpu_torch: a CUDA device was requested "
                f"(device={device!r}; None means 'cuda') but "
                "torch.cuda.is_available() is False. Pass device='cpu' "
                "to run the plain PyTorch path on the CPU.")
        fp32_matmuls()
        if dev.index is None:       # tensors report 'cuda:N', never 'cuda'
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
