"""Batch executors: the per-frame flow + warp, run over a batch of frames.

Counterpart of ``flowreg3d_tpu/parallel/executors.py``: the executor
registry (with the reference's names as aliases), ``BaseExecutor3D`` (the
weight volume, the flow configuration key, ``process_batch``) and
``SequentialExecutor3D`` (a host loop over frames). Per frame: the flow
from the port's pyramid (``core/pyramid.build_pyramid``), then the warp of
the raw frame onto the reference. Inputs are uploaded once and every result
stays on the executor's device; the caller downloads.

``use_kernels=True`` runs the CUDA kernels on CUDA tensors (the JAX
package's ``use_pallas``); ``use_kernels=False`` runs their plain PyTorch
versions. Not ported yet, and raising where asked for: the batched and mesh
executors, cross-correlation pre-alignment and flow backends.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.core.pyramid import build_pyramid, pyramid_config_key
from flowreg3d_tpu_torch.ops.warp import warp

_EXECUTORS = {}
_ALIASES = {"sequential3d": "sequential", "threading3d": "batched",
            "multiprocessing3d": "mesh"}
_NOT_PORTED = ("batched", "mesh", "spatial")
_ORDERS = {"cubic": 3, "linear": 1}


def register_executor(name, cls):
    _EXECUTORS[name] = cls


def list_executors():
    return sorted(_EXECUTORS)


def get_executor(name=None, **kwargs):
    """Executor by name; None means 'sequential', the one ported so far."""
    name = _ALIASES.get(name, name) if name is not None else "sequential"
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"executor '{name}' is not ported to flowreg3d_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 10); use 'sequential'")
    if name not in _EXECUTORS:
        raise ValueError(f"Unknown executor '{name}'; have {list_executors()}")
    return _EXECUTORS[name](**kwargs)


def _config_key(reference_proc, flow_params, dtype, use_kernels):
    fp = {k: v for k, v in flow_params.items()
          if k not in ("weight", "cc_initialization", "cc_hw", "cc_up")}
    if "const_assumption" not in fp and "constancy_assumption" in fp:
        fp["const_assumption"] = fp.pop("constancy_assumption")
    return pyramid_config_key(tuple(reference_proc.shape[:3]),
                              reference_proc.shape[3], dtype=dtype,
                              use_kernels=use_kernels, **fp)


class BaseExecutor3D:
    """Executor protocol and the shared per-batch assembly."""

    name = "base"

    def __init__(self, dtype=torch.float32, device=None, use_kernels=True):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.use_kernels = bool(use_kernels)

    def cleanup(self):
        pass

    @classmethod
    def register(cls):
        register_executor(cls.name, cls)

    def get_info(self):
        return {"name": self.name, "device": str(self.device),
                "use_kernels": self.use_kernels}

    def _on_device(self, x, ndim):
        """``x`` (array or tensor) on the device in the working dtype, with a
        trailing channel axis added to reach ``ndim`` dims."""
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        return x[..., None] if x.dim() == ndim - 1 else x

    def _weight_volume(self, flow_params, ref_proc):
        Z, Y, X, C = ref_proc.shape
        w = flow_params.get("weight")
        if w is None:
            return torch.full((Z, Y, X, C), 1.0 / C, dtype=self.dtype,
                              device=self.device)
        w = np.asarray(w, np.float32)
        if w.ndim == 1:
            w = w[:C] if w.size >= C else np.pad(
                w, (0, C - w.size), constant_values=1.0 / C)
            w = w / w.sum()
        elif w.ndim == 3:
            w = w[..., None]
        w = np.broadcast_to(w, (Z, Y, X, C)).copy()
        return torch.from_numpy(w).to(device=self.device, dtype=self.dtype)

    def process_batch(self, batch, batch_proc, reference_raw, reference_proc,
                      w_init, interpolation_method="cubic",
                      progress_callback=None, flow_params=None):
        """Register a batch: returns (registered (T,Z,Y,X,C), flows
        (T,Z,Y,X,3)), float tensors on the executor's device."""
        flow_params = dict(flow_params or {})
        if flow_params.get("cc_initialization", False):
            raise NotImplementedError(
                "cc_initialization is not ported to flowreg3d_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 9)")
        if interpolation_method not in _ORDERS:
            raise ValueError(f"Unsupported interpolation method "
                             f"{interpolation_method!r}; use 'linear' or "
                             "'cubic'")
        batch, batch_proc = (self._on_device(b, 5) for b in (batch,
                                                               batch_proc))
        ref_raw, ref_proc = (self._on_device(r, 4) for r in (reference_raw,
                                                             reference_proc))
        weight = self._weight_volume(flow_params, ref_proc)
        key = _config_key(ref_proc, flow_params, self.dtype, self.use_kernels)
        w_init = torch.as_tensor(w_init).to(device=self.device,
                                            dtype=self.dtype)
        uvw = w_init.expand((batch.shape[0],) + tuple(w_init.shape))
        return self._run(batch, batch_proc, ref_raw, ref_proc, uvw, weight,
                         key, _ORDERS[interpolation_method],
                         progress_callback)

    def _run(self, batch, batch_proc, ref_raw, ref_proc, uvw, weight, key,
             order, progress_callback):
        raise NotImplementedError


class SequentialExecutor3D(BaseExecutor3D):
    """Frame-by-frame host loop: the pyramid, then the warp of the raw
    frame, one frame at a time on one device."""

    name = "sequential"

    def _run(self, batch, batch_proc, ref_raw, ref_proc, uvw, weight, key,
             order, progress_callback):
        pyramid = build_pyramid(*key, device=self.device)
        regs, flows = [], []
        for t in range(batch.shape[0]):
            flow = pyramid(ref_proc, batch_proc[t], uvw[t], weight)
            regs.append(warp(batch[t], flow[..., 0], flow[..., 1],
                             flow[..., 2], ref_raw, order, self.use_kernels))
            flows.append(flow)
            if progress_callback:
                progress_callback(1)
        return torch.stack(regs), torch.stack(flows)


SequentialExecutor3D.register()
