"""Batch executors: the per-frame flow + warp, run over a batch of frames.

Counterpart of ``flowreg3d_tpu/parallel/executors.py``: the executor
registry (with the reference's names as aliases), ``BaseExecutor3D`` (the
weight volume, the flow configuration key, ``process_batch`` with the
cross-correlation prealignment) and four executors:

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
  frame;
- ``mesh``: the batched executor with every visible card as its default
  ``devices`` (a device may repeat). The batched executor splits the
  frames into contiguous chunks, one a device of ``devices`` (by default
  its own device alone, one chunk), copies the references to each device,
  replays each device's frames through that device's own ``FrameGraph``
  on its current stream, and queues every device's frames before any
  result is read; ``run_shards`` leaves each chunk's results on its device
  (the resident engine finalizes and downloads them there), ``_run``
  gathers them on the executor's device;
- ``spatial``: one frame at a time, its pyramid Z-sharded over the devices
  (``parallel/spatial_pyramid.build_sharded_pyramid``) and its raw frame
  warped on the first shard's device; on CUDA one replay a frame of its
  graph (kind ``"sharded"``) (the JAX package's ``jax.jit(shard_map(...))``), one host
  read of its ``valid`` flag a frame; a frame whose flow needs z-samples
  beyond the warp's halo is recomputed on the single-device path, and
  ``get_info()['single_device_frames']`` counts those frames.

Per frame: the flow from the port's pyramid (``core/pyramid.build_pyramid``),
then the warp of the raw frame onto the reference. Under
``cc_initialization`` each frame is first prealigned (``prealign``); the
batched and mesh executors replay that on CUDA too, one ``PrealignGraph``
per (shape, channels, ``cc_hw``, ``cc_up``, weight vector, ``use_kernels``)
and device (the JAX package's ``_jit_prealign_single``). The graphs and
their cache are ``_graph.py``'s; ``clear_frame_graphs`` frees them all. A
flow backend (``process_batch(..., get_displacement_func=...)``) replaces
the pyramid in every executor with the base class's eager per-frame loop,
as in JAX.
Inputs are uploaded once and every result stays on the executor's device;
the caller downloads.
``use_kernels=True`` runs the CUDA kernels on CUDA tensors (the JAX
package's ``use_pallas``); ``use_kernels=False`` runs their plain PyTorch
versions. A failed capture or replay raises: nothing falls back to the eager
loop. ``get_executor(None)`` picks ``mesh`` when more than one card is
visible, else ``batched``, as JAX does.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch import _graph
from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch._trace import span
from flowreg3d_tpu_torch.core.pyramid import build_pyramid, pyramid_config_key
from flowreg3d_tpu_torch.ops.warp import warp
from flowreg3d_tpu_torch.parallel.mesh import (batch_devices, batch_ranges,
                                               replicate, shard_batch)
from flowreg3d_tpu_torch.parallel.spatial_pyramid import (
    _DEF_HALO_W, build_sharded_pyramid)
from flowreg3d_tpu_torch.util.xcorr_prealignment import (
    estimate_rigid_xcorr_device)

_EXECUTORS = {}
_ALIASES = {"sequential3d": "sequential", "threading3d": "batched",
            "multiprocessing3d": "mesh"}
_ORDERS = {"cubic": 3, "linear": 1}


def register_executor(name, cls):
    _EXECUTORS[name] = cls


def list_executors():
    return sorted(_EXECUTORS)


def get_executor(name=None, **kwargs):
    """Executor by name or alias; None auto-selects 'mesh' when more than
    one card is visible, else 'batched'."""
    if name is None:
        many = torch.cuda.is_available() and torch.cuda.device_count() > 1
        name = "mesh" if many else "batched"
    name = _ALIASES.get(name, name)
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


class FrameGraph(_graph.CapturedGraph):
    """One frame's pyramid and raw-frame warp, captured as a CUDA graph.

    Static buffers hold the frame (raw and preprocessed), its initial flow
    and the reference (raw, preprocessed, weight); ``run`` copies one
    frame in, replays the graph and copies the flow and the registered
    frame out, all on the current stream. The capture, its launch counts
    and its cache are ``_graph.py``'s.
    """

    def __init__(self, key, order, device):
        shape, C, dtype = key[0], key[1], getattr(torch, key[11])
        self.key, self.order = key, order
        self.use_kernels = key[12]
        self.pyramid = build_pyramid(*key, device=device)

        def buf(last):
            return torch.zeros(shape + (last,), dtype=dtype, device=device)

        self.ref_raw, self.ref_proc, self.weight = buf(C), buf(C), buf(C)
        self.raw, self.proc, self.uvw = buf(C), buf(C), buf(3)
        super().__init__(device)
        self.flow, self.reg = self.outputs

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
        self.replay()
        reg_out.copy_(self.reg)
        flow_out.copy_(self.flow)


class PrealignGraph(_graph.CapturedGraph):
    """``prealign`` of one frame captured as a CUDA graph (the counterpart of
    the JAX ``_jit_prealign_single``): static buffers for the frame, the
    reference, ``w_init`` and the channel weights (when given); ``run``
    copies a frame in, replays and returns copies of (aligned,
    w_combined)."""

    def __init__(self, key, device):
        shape, C, dtype_name, self.cc_hw, self.cc_up, n_w, use_kernels = key
        dtype = getattr(torch, dtype_name)
        self.use_kernels = use_kernels
        self.frame, self.ref = (torch.zeros(shape + (C,), dtype=dtype,
                                            device=device) for _ in range(2))
        self.w_init = torch.zeros(shape + (3,), dtype=dtype, device=device)
        self.wvec = (None if n_w is None
                     else torch.ones(n_w, dtype=torch.float32, device=device))
        super().__init__(device)
        self.aligned, self.combined = self.outputs

    def _body(self):
        return prealign(self.frame, self.ref, self.w_init, self.wvec,
                        self.cc_hw, self.cc_up, self.use_kernels)

    def set_reference(self, ref_proc, w_init, wvec):
        self.ref.copy_(ref_proc)
        self.w_init.copy_(w_init)
        if wvec is not None:
            self.wvec.copy_(wvec)

    def run(self, frame):
        with torch.cuda.device(self.device):
            self.frame.copy_(frame)
            self.replay()
            return self.aligned.clone(), self.combined.clone()


def frame_graph(key, order, device):
    """The cached ``FrameGraph`` of a configuration on ``device``, captured
    on first use (dropping that device's frame graph of any other
    configuration first)."""
    return _graph.cached("frame", (key, order), device,
                         lambda: FrameGraph(key, order, device))


def frame_graphs():
    """The captured frame graphs (at most one a device)."""
    return _graph.graphs("frame")


def prealign_graphs():
    """The captured prealignment graphs (at most one a device)."""
    return _graph.graphs("prealign")


def graphs(kind):
    """The cached graphs of ``kind`` (at most one a device or device
    list): ``"frame"``, ``"prealign"``, ``"pyramid"`` (``get_displacement``),
    ``"sharded"`` (``get_displacement_sharded`` and the spatial executor's
    frame), ``"sharded_level"`` (``compute_flow_level_sharded``),
    ``"level"`` (``compute_flow_level``) or ``"flow2d"``
    (``core.compute_flow``)."""
    return _graph.graphs(kind)


def clear_frame_graphs():
    """Drop every captured graph and its memory pools: the frames', the
    prealignment's, ``get_displacement``'s, the Z-sharded pyramids' and
    frames', and the level solvers'."""
    _graph.clear()


class BaseExecutor3D:
    """Executor protocol and the shared per-batch assembly."""

    name = "base"

    def __init__(self, dtype=torch.float32, device=None, use_kernels=True):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.use_kernels = bool(use_kernels)

    def setup(self):
        return self

    def cleanup(self):
        pass

    def __enter__(self):
        return self.setup()

    def __exit__(self, *exc):
        self.cleanup()

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

    def _prealigner(self, ref_proc, w_init, flow_params):
        """``align(frame_proc) -> (aligned, w_combined)``: ``prealign`` of
        one frame against ``ref_proc`` from ``w_init``, eager here."""
        cc_hw = flow_params.get("cc_hw", 256)
        if isinstance(cc_hw, int):
            cc_hw = (cc_hw, cc_hw)
        cc_hw, cc_up = tuple(cc_hw), int(flow_params.get("cc_up", 10))
        weight = flow_params.get("weight")
        wv = None
        if weight is not None and np.ndim(weight) == 1:
            wv = torch.from_numpy(np.asarray(weight, np.float32).reshape(-1))
            wv = wv.to(self.device)
        return self._align_fn(ref_proc, w_init, wv, cc_hw, cc_up)

    def _align_fn(self, ref_proc, w_init, wv, cc_hw, cc_up):
        return lambda frame: prealign(frame, ref_proc, w_init, wv, cc_hw,
                                      cc_up, self.use_kernels)

    def _prealign_frames(self, batch_proc, ref_proc, w_init, flow_params):
        """Prealign every frame; returns (aligned (T,Z,Y,X,C), w_combined
        (T,Z,Y,X,3)) on the device."""
        with span("flowreg3d.prealign"):
            align = self._prealigner(ref_proc, w_init, flow_params)
            outs = [align(batch_proc[t]) for t in range(batch_proc.shape[0])]
            return (torch.stack([a for a, _ in outs]),
                    torch.stack([c for _, c in outs]))

    def _finalize_cc(self, batch, flows, extra_flow, ref_raw, order):
        """cc step 6: total flow = combined + residual; re-warp the raw
        frames."""
        with span("flowreg3d.cc_finalize"):
            total = flows + extra_flow
            registered = torch.stack([
                warp(batch[t], total[t, ..., 0], total[t, ..., 1],
                     total[t, ..., 2], ref_raw, order, self.use_kernels)
                for t in range(batch.shape[0])])
            return registered, total

    def run_shards(self, batch, batch_proc, ref_raw, ref_proc, uvw, weight,
                   key, order, progress_callback):
        """The batch's frames as (start, stop, registered, flows) shards,
        the tensors on the shard's device: here one shard, the executor's
        own ``_run``."""
        return [(0, batch.shape[0], *self._run(
            batch, batch_proc, ref_raw, ref_proc, uvw, weight, key, order,
            progress_callback))]

    def process_batch(self, batch, batch_proc, reference_raw, reference_proc,
                      w_init, get_displacement_func=None, imregister_func=None,
                      interpolation_method="cubic", progress_callback=None,
                      flow_params=None):
        """Register a batch: returns (registered (T,Z,Y,X,C), flows
        (T,Z,Y,X,3)), float tensors on the executor's device. With
        ``flow_params['cc_initialization']`` each frame is first prealigned
        rigidly (``prealign``) and the residual flow is solved from zero. A
        ``get_displacement_func`` replaces the pyramid: the batch goes
        through ``_run_custom_backend``'s per-frame loop."""
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
        w_init = torch.as_tensor(w_init).to(device=self.device,
                                            dtype=self.dtype)
        if get_displacement_func is not None:
            return self._run_custom_backend(
                batch, batch_proc, ref_raw, ref_proc, w_init,
                get_displacement_func, imregister_func, interpolation_method,
                progress_callback, flow_params)
        weight = self._weight_volume(flow_params, ref_proc)
        key = _config_key(ref_proc, flow_params, self.dtype, self.use_kernels)
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

    # solver-facing kwargs only; pipeline-internal keys stay host-side
    _PIPELINE_KEYS = ("cc_initialization", "cc_hw", "cc_up", "weight",
                      "update_initialization_w")

    def _run_custom_backend(self, batch, batch_proc, ref_raw, ref_proc,
                            w_init, get_displacement_func, imregister_func,
                            interp, progress_callback, flow_params):
        """The flow-backend path, a per-frame loop in every executor (JAX
        ``parallel/executors.py:_run_custom_backend``): the backend gets
        host numpy float32 ``ref_proc``, ``frame_proc`` and ``uvw`` and the
        solver-facing options; its flow is uploaded and the raw frame
        warped onto the reference (the port's warp on the executor's
        device, or ``imregister_func`` called on host numpy arrays). Under
        cc prealignment the backend solves the residual of ``prealign``
        from zero. Returns float tensors like ``process_batch``; the
        caller casts to the input's dtype."""
        of_params = {k: v for k, v in flow_params.items()
                     if k not in self._PIPELINE_KEYS}
        use_cc = bool(flow_params.get("cc_initialization", False))
        if use_cc:
            align = self._prealigner(ref_proc, w_init, flow_params)

        def host(x):
            return x.detach().cpu().numpy()

        ref_proc_h = host(ref_proc)
        # the residual after prealignment is solved from zero
        uvw_h = np.zeros_like(host(w_init)) if use_cc else host(w_init)
        regs, flows = [], []
        for t in range(batch.shape[0]):
            frame_proc = batch_proc[t]
            if use_cc:
                frame_proc, base_flow = align(batch_proc[t])
            flow = self._on_device(np.asarray(get_displacement_func(
                ref_proc_h, host(frame_proc), uvw=uvw_h, **of_params),
                np.float32), 4)
            if use_cc:
                flow = flow + base_flow
            if imregister_func is None:
                reg = warp(batch[t], flow[..., 0], flow[..., 1],
                           flow[..., 2], ref_raw, _ORDERS[interp],
                           self.use_kernels)
            else:
                f = host(flow)
                reg = self._on_device(np.asarray(imregister_func(
                    host(batch[t]), f[..., 0], f[..., 1], f[..., 2],
                    host(ref_raw), interpolation_method=interp)), 4)
            regs.append(reg)
            flows.append(flow)
            if progress_callback:
                progress_callback(1)
        return torch.stack(regs), torch.stack(flows)


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
    frames eagerly, as ``sequential``. The frames go over ``devices`` (None:
    the executor's device alone), one contiguous chunk a device, so that
    ``mesh`` is this executor with every visible card as its default."""

    name = "batched"

    def __init__(self, dtype=torch.float32, device=None, use_kernels=True,
                 devices=None):
        super().__init__(dtype, device, use_kernels)
        self.devices = self._devices(devices)

    def _devices(self, devices):
        return [self.device] if devices is None else batch_devices(devices)

    def get_info(self):
        info = super().get_info()
        info.update(devices=[str(d) for d in self.devices],
                    n_devices=len(self.devices))
        return info

    def run_shards(self, batch, batch_proc, ref_raw, ref_proc, uvw, weight,
                   key, order, progress_callback):
        """The batch's frames on the shards: a list of (start, stop,
        registered, flows) per non-empty chunk, the tensors on the chunk's
        device. A chunk's inputs are copied to its device and its frames
        queued there; every device is given its first frame before any its
        second, so that the cards work side by side."""
        refs = [replicate(x, self.devices) for x in (ref_raw, ref_proc,
                                                     weight)]
        chunks = [shard_batch(x, self.devices)
                  for x in (batch, batch_proc, uvw)]
        shards = []
        for k, ((a, b), dev) in enumerate(zip(
                batch_ranges(batch.shape[0], len(self.devices)),
                self.devices)):
            if b <= a:
                continue
            regs = torch.empty((b - a,) + tuple(batch.shape[1:]),
                               dtype=self.dtype, device=dev)
            flows = torch.empty((b - a,) + tuple(batch.shape[1:4]) + (3,),
                                dtype=self.dtype, device=dev)
            shards.append(dict(
                range=(a, b), dev=dev, regs=regs, flows=flows,
                inputs=[c[k] for c in chunks],
                frame=self._frame_fn(key, order, dev,
                                     *(r[dev] for r in refs))))
        for t in range(max((s["range"][1] - s["range"][0] for s in shards),
                           default=0)):
            for s in shards:
                if t < s["range"][1] - s["range"][0]:
                    raw, proc, u0 = (x[t] for x in s["inputs"])
                    s["frame"](raw, proc, u0, s["regs"][t], s["flows"][t])
                    if progress_callback:
                        progress_callback(1)
        return [(*s["range"], s["regs"], s["flows"]) for s in shards]

    def _align_fn(self, ref_proc, w_init, wv, cc_hw, cc_up):
        """On CUDA, a replay of the cached ``PrealignGraph`` a frame."""
        if self.device.type != "cuda":
            return super()._align_fn(ref_proc, w_init, wv, cc_hw, cc_up)
        key = (tuple(ref_proc.shape[:3]), ref_proc.shape[3],
               str(ref_proc.dtype).removeprefix("torch."), cc_hw, cc_up,
               None if wv is None else wv.numel(), self.use_kernels)
        graph = _graph.cached("prealign", key, self.device,
                              lambda: PrealignGraph(key, self.device))
        graph.set_reference(ref_proc, w_init, wv)
        return graph.run

    def _frame_fn(self, key, order, dev, ref_raw, ref_proc, weight):
        """One frame on ``dev``: its device's graph on CUDA, else eager."""
        if dev.type == "cuda":
            graph = frame_graph(key, order, dev)
            graph.set_reference(ref_raw, ref_proc, weight)

            def frame(*args):
                with torch.cuda.device(dev):
                    graph.run(*args)
            return frame
        pyramid = build_pyramid(*key, device=dev)

        def frame(raw, proc, uvw_t, reg_out, flow_out):
            flow_out.copy_(pyramid(ref_proc, proc, uvw_t, weight))
            reg_out.copy_(warp(raw, flow_out[..., 0], flow_out[..., 1],
                               flow_out[..., 2], ref_raw, order,
                               self.use_kernels))
        return frame

    def _run(self, batch, batch_proc, ref_raw, ref_proc, uvw, weight, key,
             order, progress_callback):
        shards = self.run_shards(batch, batch_proc, ref_raw, ref_proc, uvw,
                                 weight, key, order, progress_callback)
        if len(shards) == 1 and shards[0][2].device == self.device:
            return shards[0][2:]
        regs = torch.empty(batch.shape, dtype=self.dtype, device=self.device)
        flows = torch.empty(tuple(batch.shape[:4]) + (3,), dtype=self.dtype,
                            device=self.device)
        for a, b, r, f in shards:
            regs[a:b].copy_(r, non_blocking=True)
            flows[a:b].copy_(f, non_blocking=True)
        return regs, flows


class MeshExecutor3D(BatchedExecutor3D):
    """The batched executor over a list of devices, one ``FrameGraph`` a
    distinct device (module docstring). ``device`` is where the batch comes
    from and the results go (None: 'cuda'); ``devices`` the shards (None:
    every visible card, ``parallel/mesh.batch_devices``)."""

    name = "mesh"

    def _devices(self, devices):
        return batch_devices(devices, self.device)


class SpatialExecutor3D(BaseExecutor3D):
    """Frames one at a time, each Z-sharded over ``devices`` (module
    docstring); results on ``device`` (None: 'cuda'). ``halo_w``: the
    warp's z halo (None: the pyramid's default)."""

    name = "spatial"

    def __init__(self, dtype=torch.float32, device=None, use_kernels=True,
                 devices=None, halo_w=None):
        super().__init__(dtype, device, use_kernels)
        self.devices = batch_devices(devices, self.device)
        self.halo_w = halo_w
        self.single_device_frames = 0

    def get_info(self):
        info = super().get_info()
        info.update(devices=[str(d) for d in self.devices],
                    n_devices=len(self.devices), sharding="z-spatial",
                    single_device_frames=self.single_device_frames)
        return info

    def _frame_fn(self, key, order, inputs):
        """``frame(ref_raw, ref_proc, weight, raw, proc, uvw) -> (flow,
        valid, reg)``: one frame Z-sharded over the devices (the sharded
        pyramid's body; the weight a vector or a volume), its raw frame
        warped on the first shard's device; ``inputs``, tensors of those
        shapes. On CUDA the replay of the cached graph of the frame (kind
        ``"sharded"``, the batched executor's ``FrameGraph`` counterpart);
        on the CPU the eager body."""
        home = self.devices[0]
        halo_w = self.halo_w or _DEF_HALO_W
        specs = [(x.shape, self.dtype) for x in inputs]

        def body():
            pyramid = build_sharded_pyramid(key, self.devices, halo_w=halo_w)

            def frame(ref_raw, ref_proc, weight, raw, proc, uvw):
                flow, valid = pyramid(ref_proc, proc, uvw, weight)
                reg = warp(raw, flow[..., 0], flow[..., 1], flow[..., 2],
                           ref_raw, order, self.use_kernels)
                return flow, valid, reg
            return frame

        if home.type == "cuda":
            return _graph.cached(
                "sharded", (key, order, halo_w, specs[2][0], "frame"),
                tuple(self.devices),
                lambda: _graph.BodyGraph(body(), specs, home,
                                         self.devices)).run
        return body()

    def _run(self, batch, batch_proc, ref_raw, ref_proc, uvw, weight, key,
             order, progress_callback):
        flat = weight.reshape(-1, weight.shape[-1])
        # a per-channel weight goes as its vector, not a volume to shard
        wvec = flat[0] if bool((flat == flat[0]).all()) else weight
        home = self.devices[0]
        ref = [x.to(home) for x in (ref_raw, ref_proc, wvec)]
        frame = self._frame_fn(key, order, ref + [batch[0], batch_proc[0],
                                                  uvw[0]])
        regs = torch.empty(batch.shape, dtype=self.dtype, device=self.device)
        flows = torch.empty(tuple(batch.shape[:4]) + (3,), dtype=self.dtype,
                            device=self.device)
        for t in range(batch.shape[0]):
            flows[t], valid, regs[t] = frame(
                *ref, *(x[t].to(home) for x in (batch, batch_proc, uvw)))
            if not bool(valid):
                self.single_device_frames += 1
                flows[t] = build_pyramid(*key, device=self.device)(
                    ref_proc, batch_proc[t], uvw[t], weight)
                regs[t] = warp(batch[t], flows[t, ..., 0], flows[t, ..., 1],
                               flows[t, ..., 2], ref_raw, order,
                               self.use_kernels)
            if progress_callback:
                progress_callback(1)
        return regs, flows


SequentialExecutor3D.register()
BatchedExecutor3D.register()
MeshExecutor3D.register()
SpatialExecutor3D.register()
