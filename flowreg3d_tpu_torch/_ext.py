"""Build and load the hand-written CUDA kernels of ``csrc/``.

One ``nvcc`` call compiles every ``csrc/*.cu`` into one shared library
with a plain C interface (no PyTorch headers), loaded with ``ctypes``.
The library is built at first use into ``_build/`` under a name that
carries a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so an edited source or header rebuilds.
A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from flowreg3d_tpu_torch._device import fp32_matmuls

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# --fmad=false: no contraction of a*b+c into one rounding, so each kernel
# rounds exactly like its plain PyTorch version (one op, one rounding)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# C signature of every kernel entry point; each returns cudaGetLastError().
SIGNATURES = {
    # duvw, sj, P, M, N, ax, ay, az, n_iters, stream
    "sor_iterations_f32": (_P, _P, _I, _I, _I, _F, _F, _F, _I, _P),
    # P, M, N, out[5]: the launch plan sor_iterations_f32 takes
    "sor_iterations_plan": (_I, _I, _I, _IP),
    # coeff, Ze, Ye, Xe, cz, cy, cx, out, Oz, Oy, Ox, Z, Y, X, order, stream
    "map_coords_f32": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _P),
    # xp, out, B, Z, Y, X, stream
    "median5_f32": (_P, _P, _I, _I, _I, _I, _P),
    # duvw, base, psi, P, M, N, a, a - 1, 0.5/hx, 0.5/hy, 0.5/hz, z_lo,
    # z_hi, stream
    "psi_field_f32": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _I, _I,
                      _P),
    # duvw, base, sj, psi, P, M, N, ax, ay, az, parity, z_off, z_lo, z_hi,
    # stream
    "sor_halfsweep_psi_f32": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I,
                              _I, _I, _I, _P),
    # duvw, base, sj, P, M, N, ax, ay, az, parity, z_off, z_lo, z_hi, stream
    "sor_halfsweep_const_f32": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I,
                                _I, _I, _P),
    # duvw, scratch, base, sj, P, M, N, a, a - 1, 0.5/hx, 0.5/hy, 0.5/hz,
    # ax, ay, az, n_iters, mode (0: by size), stream
    "sor_iterations_psi_f32": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                               _F, _F, _F, _F, _I, _I, _P),
    # P, M, N, mode, out[7]: the launch plan sor_iterations_psi_f32 takes
    "sor_iterations_psi_plan": (_I, _I, _I, _I, _IP),
}

# what the last build printed (ptxas register / spill report), for logs
build_info = {"seconds": None, "log": "", "path": None}


def _nvcc():
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("flowreg3d_tpu_torch: nvcc not found (PATH, CUDA_HOME, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library_path():
    """Where the library built from the present sources lies (it may not
    exist yet)."""
    return BUILD_DIR / f"libflowreg3d_kernels_{_digest(_sources())}.so"


def build():
    """Compile the kernels if needed; returns the shared library's path."""
    srcs = _sources()
    so = library_path()
    if so.exists():
        build_info.update(seconds=0.0, path=str(so))
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=r.stdout + r.stderr, path=str(so))
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def lib():
    """The loaded kernel library (built on first call)."""
    fp32_matmuls()
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def check_cuda(t, name, ndim, dtype):
    """Raise unless ``t`` is a contiguous CUDA tensor of the given rank/type."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.numel() == 0:
        raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")


def stream_of(t):
    """Handle of PyTorch's current stream on ``t``'s device."""
    return _P(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on_error(rc, kernel):
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def launch_counters():
    """Every kernel wrapper by kernel name. A wrapper counts each launch of
    its kernel from the host in its ``launches`` attribute; the launches a
    CUDA-graph replay runs are counted by the graph
    (``parallel/executors.py:FrameGraph``)."""
    from flowreg3d_tpu_torch.core import solver_kernel, solver_psi_kernel
    from flowreg3d_tpu_torch.ops import median_kernel, warp_kernel

    return {"sor_iterations_f32": solver_kernel.sor_iterations,
            "map_coords_f32": warp_kernel.map_coords,
            "median5_f32": median_kernel.median5,
            "psi_field_f32": solver_psi_kernel.psi_field,
            "sor_halfsweep_psi_f32": solver_psi_kernel.halfsweep_psi,
            "sor_halfsweep_const_f32": solver_psi_kernel.halfsweep,
            "sor_iterations_psi_f32": solver_psi_kernel.sor_iterations_psi}
