"""The port stands alone: it imports neither JAX, the JAX package nor
pydantic, and its entry points (the pipeline's included) run on CUDA unless
the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "flowreg3d_tpu_torch"

_STEP = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
import flowreg3d_tpu_torch as ft
rng = np.random.default_rng(0)
fixed = rng.random((8, 20, 20)).astype(np.float32)
moving = np.roll(fixed, (0, 1, -1), axis=(0, 1, 2))
flow = ft.get_displacement(fixed, moving, alpha=(1.5,) * 3, update_lag=2,
                           iterations=4, min_level=0, levels=3, a_smooth=1.0,
                           device="cpu")
reg = ft.imregister_wrapper(moving, flow[..., 0], flow[..., 1], flow[..., 2],
                            fixed, device="cpu")
assert tuple(flow.shape) == (8, 20, 20, 3) and bool(reg.isfinite().all())
flow = ft.get_displacement(fixed, moving, iterations=2, update_lag=1,
                           levels=2, device="cpu")      # a_smooth 0.5
assert bool(flow.isfinite().all())
from flowreg3d_tpu_torch.pipeline import OFOptions, compensate_arr
opts = OFOptions(iterations=2, update_lag=1, levels=2, min_level=0,
                 a_smooth=0.5, weight=[1.0])
reg, w = compensate_arr(np.stack([fixed, moving]), fixed, options=opts,
                        device="cpu")
assert reg.shape == (2, 8, 20, 20) and w.shape == (2, 8, 20, 20, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flowreg3d_tpu",
                                    "pydantic"))
print("LOADED", bad)
"""

# an import of jax, of the JAX package (flowreg3d_tpu, not
# flowreg3d_tpu_torch) or of pydantic, at any indentation
_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flowreg3d_tpu|pydantic)(\.|\s|$)",
    re.M)


def test_import_and_cpu_step_load_no_jax():
    r = subprocess.run([sys.executable, "-c", _STEP.format(repo=str(REPO))],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout, r.stdout


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    import flowreg3d_tpu_torch as ft

    vol = np.zeros((8, 12, 12), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.get_displacement(vol, vol, a_smooth=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.imregister_wrapper(vol, vol, vol, vol, vol)
    key = ft.pyramid_config_key((8, 12, 12), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.build_pyramid(*key)
    from flowreg3d_tpu_torch.pipeline import OFOptions, compensate_arr

    with pytest.raises(RuntimeError, match="CUDA"):
        compensate_arr(vol[None], vol, OFOptions(weight=[1.0]))


def test_no_jax_imports_in_port_sources():
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not offenders, offenders
