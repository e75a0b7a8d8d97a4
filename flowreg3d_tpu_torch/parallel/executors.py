"""Batch executors: the per-frame flow + warp, run over a batch of frames.

Counterpart of ``flowreg3d_tpu/parallel/executors.py``: the executor
registry (with the reference's names as aliases), ``BaseExecutor3D`` (the
weight volume, the flow configuration key, ``process_batch`` with the
cross-correlation prealignment) and two executors:

- ``sequential``: a host loop over frames, every operation launched
  eagerly; the check the batched executor is held against;
- ``batched`` (the default): on CUDA, one frame's whole pyramid and the warp
  of its raw frame are captured once per (configuration, interpolation) as
  a CUDA graph with static input and output buffers (``FrameGraph``), and
  the graph is replayed once per frame, back to back over the batch, with
  no host sync; on the CPU, a plain loop as ``sequential``. This is the
  JAX package's ``lax.map`` over the one compiled per-frame program. A
  graph holds one frame's working memory whatever the batch length, so the
  JAX executor's ``chunk`` / ``voxel_budget`` (frames per ``lax.map``)
  have nothing to bound here and are not taken; progress is reported per
  frame.

Per frame: the flow from the port's pyramid (``core/pyramid.build_pyramid``),
then the warp of the raw frame onto the reference. Inputs are uploaded once
and every result stays on the executor's device; the caller downloads.
``use_kernels=True`` runs the CUDA kernels on CUDA tensors (the JAX
package's ``use_pallas``); ``use_kernels=False`` runs their plain PyTorch
versions. A failed capture or replay raises: nothing falls back to the eager
loop. Not ported yet, and raising where asked for: the mesh and spatial
executors (ROADMAP.md Queue 1 item 11).
"""

import time

import numpy as np
import torch

from flowreg3d_tpu_torch import _ext
from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.core.pyramid import build_pyramid, pyramid_config_key
from flowreg3d_tpu_torch.ops.warp import warp
from flowreg3d_tpu_torch.util.xcorr_prealignment import (
    estimate_rigid_xcorr_device)

_EXECUTORS = {}
_ALIASES = {"sequential3d": "sequential", "threading3d": "batched",
            "multiprocessing3d": "mesh"}
_NOT_PORTED = ("mesh", "spatial")
_ORDERS = {"cubic": 3, "linear": 1}


def register_executor(name, cls):
    _EXECUTORS[name] = cls


def list_executors():
    return sorted(_EXECUTORS)


def get_executor(name=None, **kwargs):
    """Executor by name or alias; None auto-selects 'batched' (the port runs
    one device; 'mesh' waits for ROADMAP.md Queue 1 item 11)."""
    name = "batched" if name is None else _ALIASES.get(name, name)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"executor '{name}' is not ported to flowreg3d_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 11); use 'batched' or 'sequential'")
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


def prealign(frame_proc, ref_proc, w_init, weight_vec, cc_hw, cc_up,
             use_kernels=True):
    """Steps 1-4 of the cc pipeline on one frame, on its device with no host
    sync: trilinear warp by ``w_init``, the rigid xcorr residual of the
    projections, combine, warp again. Returns (aligned (Z,Y,X,C),
    w_combined (Z,Y,X,3)). Counterpart of the JAX ``_prealign_traced``."""
    mov_partial = warp(frame_proc, w_init[..., 0], w_init[..., 1],
                       w_init[..., 2], ref_proc, 1, use_kernels)
    w_cross = estimate_rigid_xcorr_device(ref_proc, mov_partial,
                                          target_hw=cc_hw, up=cc_up,
                                          weight_vec=weight_vec)
    w_combined = w_init + w_cross
    aligned = warp(frame_proc, w_combined[..., 0], w_combined[..., 1],
                   w_combined[..., 2], ref_proc, 1, use_kernels)
    return aligned, w_combined


class FrameGraph:
    """One frame's pyramid and raw-frame warp, captured as a CUDA graph.

    Static buffers hold the frame (raw and preprocessed), its initial flow
    and the reference (raw, preprocessed, weight); ``run`` copies one
    frame in, replays the graph and copies the flow and the registered
    frame out, all on the current stream. The capture follows PyTorch's
    recipe: one warm eager run on a side stream first (it builds the kernel
    library and the cached device tables that a capture may not upload),
    then the capture. The kernel wrappers count only host launches: the
    warm run counts, the capture is taken back out, and a replay counts
    nothing there. ``launches`` holds the kernel launches of one replay by
    wrapper name and ``replays`` how often the graph ran, so the kernels a
    replay ran are ``launches`` times ``replays``.
    """

    def __init__(self, key, order, device):
        shape, C, dtype = key[0], key[1], getattr(torch, key[11])
        self.key, self.order, self.device = key, order, device
        self.use_kernels = key[12]
        self.pyramid = build_pyramid(*key, device=device)

        def buf(last):
            return torch.zeros(shape + (last,), dtype=dtype, device=device)

        self.ref_raw, self.ref_proc, self.weight = buf(C), buf(C), buf(C)
        self.raw, self.proc, self.uvw = buf(C), buf(C), buf(3)
        self.replays = 0
        t = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(device).wait_stream(side)
        counters = _ext.launch_counters()
        before = {k: fn.launches for k, fn in counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.flow, self.reg = self._body()
        self.launches = {}
        for k, fn in counters.items():
            if fn.launches != before[k]:
                self.launches[k] = fn.launches - before[k]
            fn.launches = before[k]
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t

    def _body(self):
        flow = self.pyramid(self.ref_proc, self.proc, self.uvw, self.weight)
        reg = warp(self.raw, flow[..., 0], flow[..., 1], flow[..., 2],
                   self.ref_raw, self.order, self.use_kernels)
        return flow, reg

    def set_reference(self, ref_raw, ref_proc, weight):
        self.ref_raw.copy_(ref_raw)
        self.ref_proc.copy_(ref_proc)
        self.weight.copy_(weight)

    def run(self, raw, proc, uvw, reg_out, flow_out):
        self.raw.copy_(raw)
        self.proc.copy_(proc)
        self.uvw.copy_(uvw)
        self.graph.replay()
        reg_out.copy_(self.reg)
        flow_out.copy_(self.flow)
        self.replays += 1


# the last captured graph, by (config key, interpolation, device). It holds
# its private memory pool (1.55 GiB at OFOptions() defaults and 7.43 GiB at
# the direct API's options at 64x512x512, PERF.md), so only one is kept: a
# repeated call reuses it, another configuration replaces it, and
# ``clear_frame_graphs`` frees it.
_GRAPHS = {}


def frame_graph(key, order, device):
    """The cached ``FrameGraph`` of a configuration, captured on first use
    (dropping the graph of any other configuration first)."""
    k = (key, order, device)
    if k not in _GRAPHS:
        _GRAPHS.clear()
        _GRAPHS[k] = FrameGraph(key, order, device)
    return _GRAPHS[k]


def frame_graphs():
    """The captured graphs (at most one)."""
    return list(_GRAPHS.values())


def clear_frame_graphs():
    """Drop every captured graph and its memory pool."""
    _GRAPHS.clear()


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

    @staticmethod
    def _cc_params(flow_params):
        cc_hw = flow_params.get("cc_hw", 256)
        if isinstance(cc_hw, int):
            cc_hw = (cc_hw, cc_hw)
        weight = flow_params.get("weight")
        wvec = None
        if weight is not None and np.ndim(weight) == 1:
            wvec = np.asarray(weight, np.float32).reshape(-1)
        return tuple(cc_hw), int(flow_params.get("cc_up", 10)), wvec

    def _prealign_frames(self, batch_proc, ref_proc, w_init, flow_params):
        """Prealign every frame; returns (aligned (T,Z,Y,X,C), w_combined
        (T,Z,Y,X,3)) on the device. Eager per frame in every executor: its
        few launches are small next to a pyramid's."""
        cc_hw, cc_up, wvec = self._cc_params(flow_params)
        wv = (None if wvec is None
              else torch.from_numpy(wvec).to(self.device))
        outs = [prealign(batch_proc[t], ref_proc, w_init, wv, cc_hw, cc_up,
                         self.use_kernels)
                for t in range(batch_proc.shape[0])]
        return (torch.stack([a for a, _ in outs]),
                torch.stack([c for _, c in outs]))

    def _finalize_cc(self, batch, flows, extra_flow, ref_raw, order):
        """cc step 6: total flow = combined + residual; re-warp the raw
        frames."""
        total = flows + extra_flow
        registered = torch.stack([
            warp(batch[t], total[t, ..., 0], total[t, ..., 1],
                 total[t, ..., 2], ref_raw, order, self.use_kernels)
            for t in range(batch.shape[0])])
        return registered, total

    def process_batch(self, batch, batch_proc, reference_raw, reference_proc,
                      w_init, interpolation_method="cubic",
                      progress_callback=None, flow_params=None):
        """Register a batch: returns (registered (T,Z,Y,X,C), flows
        (T,Z,Y,X,3)), float tensors on the executor's device. With
        ``flow_params['cc_initialization']`` each frame is first prealigned
        rigidly (``prealign``) and the residual flow is solved from zero."""
        flow_params = dict(flow_params or {})
        if interpolation_method not in _ORDERS:
            raise ValueError(f"Unsupported interpolation method "
                             f"{interpolation_method!r}; use 'linear' or "
                             "'cubic'")
        order = _ORDERS[interpolation_method]
        batch, batch_proc = (self._on_device(b, 5) for b in (batch,
                                                               batch_proc))
        ref_raw, ref_proc = (self._on_device(r, 4) for r in (reference_raw,
                                                             reference_proc))
        weight = self._weight_volume(flow_params, ref_proc)
        key = _config_key(ref_proc, flow_params, self.dtype, self.use_kernels)
        w_init = torch.as_tensor(w_init).to(device=self.device,
                                            dtype=self.dtype)
        T = batch.shape[0]
        if flow_params.get("cc_initialization", False):
            aligned, combined = self._prealign_frames(batch_proc, ref_proc,
                                                      w_init, flow_params)
            _, flows = self._run(batch, aligned, ref_raw, ref_proc,
                                 torch.zeros_like(combined), weight, key,
                                 order, progress_callback)
            return self._finalize_cc(batch, flows, combined, ref_raw, order)
        uvw = w_init.expand((T,) + tuple(w_init.shape))
        return self._run(batch, batch_proc, ref_raw, ref_proc, uvw, weight,
                         key, order, progress_callback)

    def _run(self, batch, batch_proc, ref_raw, ref_proc, uvw, weight, key,
             order, progress_callback):
        raise NotImplementedError


class SequentialExecutor3D(BaseExecutor3D):
    """Frame-by-frame host loop: the pyramid, then the warp of the raw
    frame, one frame at a time on one device, every operation eager."""

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


class BatchedExecutor3D(BaseExecutor3D):
    """One CUDA-graph replay a frame (module docstring); the CPU runs the
    frames eagerly, as ``sequential``."""

    name = "batched"

    def _run(self, batch, batch_proc, ref_raw, ref_proc, uvw, weight, key,
             order, progress_callback):
        regs = torch.empty(batch.shape, dtype=self.dtype, device=self.device)
        flows = torch.empty(tuple(batch.shape[:4]) + (3,), dtype=self.dtype,
                            device=self.device)
        if self.device.type == "cuda":
            graph = frame_graph(key, order, self.device)
            graph.set_reference(ref_raw, ref_proc, weight)
            frame = graph.run
        else:
            pyramid = build_pyramid(*key, device=self.device)

            def frame(raw, proc, uvw_t, reg_out, flow_out):
                flow_out.copy_(pyramid(ref_proc, proc, uvw_t, weight))
                reg_out.copy_(warp(raw, flow_out[..., 0], flow_out[..., 1],
                                   flow_out[..., 2], ref_raw, order,
                                   self.use_kernels))
        for t in range(batch.shape[0]):
            frame(batch[t], batch_proc[t], uvw[t], regs[t], flows[t])
            if progress_callback:
                progress_callback(1)
        return regs, flows


SequentialExecutor3D.register()
BatchedExecutor3D.register()
