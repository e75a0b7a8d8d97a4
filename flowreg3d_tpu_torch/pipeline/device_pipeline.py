"""The pipeline's batch step: raw frames up once, registered frames down
once.

Counterpart of ``flowreg3d_tpu/pipeline/device_pipeline.py``. Per batch:

  upload the raw batch once in its native dtype (u16: 33.5 MB a
  64x512x512 frame, against 67 MB as float32) and cast it on the device
    -> preprocess on the device (normalise against the reference's range,
       then the Gaussian, the temporal sigma across the batch included), or
       a user ``preproc_funct`` on the host batch, its result uploaded
    -> flows and the raw frames warped by them from the executor, one
       shared w_init
    -> finalize on the device: the native-dtype cast (rint and clip for
       integers), the (T, 4) statistics and the in-bounds valid flag and
       mask
  download the registered batch in its native dtype and the statistics.

The initial w (mean flow of the first <= 22 frames; zero under the cc
prealignment), the w_init tail mean (last <= 20 flows) and the reference
update (mean of the last <= 100 compensated frames) stay on the device. The
downloads go through ``HostStaging``: on CUDA one page-locked buffer per
output, sized to one batch and reused by every batch, ``non_blocking``
copies and one sync a batch, then one copy out of the pinned buffer, so the
pinned memory never exceeds one batch. That copy lands the registered
frames and the flows in the caller's arrays where it gives them
(``run_batch``'s ``outs``: the in-memory writers' next frames, cast to their
dtype on the way, claimed from the writers' toucher by ``run_batch``'s
``claim`` before the first byte goes in), and everything else in fresh
pageable arrays. The full flows come down only when asked for
(``keep_flows_host``). The CPU path never pins.

The flows come as (start, stop, registered, flows) shards from one of two
sources. Where ``resident_supported`` allows it, the executor's
``run_shards``: one shard on the run's device for the sequential and
batched executors (the batched one replays one CUDA graph a frame), one a
device for the mesh executor (JAX's mesh mode; the batch is uploaded and
preprocessed on the run's device, since the temporal Gaussian spans the
batch). Elsewhere (the cc prealignment, a flow backend, the spatial
executor, ``device_resident=False``) one shard of the executor's
``process_batch`` on its device. Each shard is finalized on its device
(cast, statistics, valid flags and masks) and downloaded through that
device's own ``HostStaging`` into its frames of the batch's host arrays.
Only the flows the w_init tail mean needs (the last <= 20), and all of them
when the reference is updated, come back to the run's device.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch._trace import span
from flowreg3d_tpu_torch.io.array import cast_frames
from flowreg3d_tpu_torch.ops.filters import apply_gaussian_filter, normalize
from flowreg3d_tpu_torch.ops.warp import warp
from flowreg3d_tpu_torch.pipeline.stats import flow_statistics_tensor

__all__ = ["ResidentPipeline", "resident_supported", "preprocess",
           "updated_reference", "valid_mask", "cast_output", "download_dtype",
           "destinations", "HostStaging"]

_ORDERS = {"cubic": 3, "linear": 1}
# integer dtypes the registered frames are cast to on the device (others
# come down as float32 and are cast on the host)
_DEVICE_CAST = (np.uint8, np.int8, np.int16, np.uint16)


def resident_supported(options, config, executor) -> bool:
    """True when the batch step takes its flows from the executor's
    ``run_shards``: not for a user ``preproc_funct`` or a flow backend
    (host protocols), nor for the cc prealignment, nor for the spatial
    executor, which drives its frames itself; these take theirs from its
    ``process_batch``."""
    if config.device_resident is False:
        return False
    if options.preproc_funct is not None:
        return False
    if config.get_displacement_func is not None:
        return False
    if config.flow_backend not in (None, "", "variational"):
        return False
    if options.cc_initialization:
        return False
    return executor.name in ("sequential", "batched", "mesh")


def preprocess(frames, options, normalization_ref=None, host_frames=None):
    """normalize (against the reference's range when given), then the
    MATLAB-order Gaussian, on the device tensor ``frames``. A user
    ``preproc_funct`` replaces the chain: as in the JAX package it gets the
    host numpy array ``host_frames``, and its result is uploaded as
    float32."""
    if options.preproc_funct is not None:
        return torch.as_tensor(np.asarray(options.preproc_funct(
            host_frames))).to(device=frames.device, dtype=torch.float32)
    mode = ("separate" if options.channel_normalization.value == "separate"
            else "together")
    normalized = normalize(frames, ref=normalization_ref,
                           channel_normalization=mode)
    return apply_gaussian_filter(normalized,
                                 np.asarray(options.sigma, float))


def updated_reference(batch_proc, flows, ref_proc, order, use_kernels):
    """The new preprocessed reference: the mean of the last <= 100
    preprocessed frames warped by their flows."""
    T = batch_proc.shape[0]
    comp = [warp(batch_proc[t], flows[t, ..., 0], flows[t, ..., 1],
                 flows[t, ..., 2], ref_proc, order, use_kernels)
            for t in range(T - min(100, T), T)]
    return torch.stack(comp).mean(dim=0)


def valid_mask(flows):
    """(T,Z,Y,X) bool: the warp's sample coordinates stayed in bounds (the
    voxel was not filled from the reference), in the flows' dtype."""
    T, Z, Y, X, _ = flows.shape

    def grid(n, shape):
        return torch.arange(n, dtype=flows.dtype,
                            device=flows.device).reshape(shape)

    mx = grid(X, (1, 1, 1, X)) + flows[..., 0]
    my = grid(Y, (1, 1, Y, 1)) + flows[..., 1]
    mz = grid(Z, (1, Z, 1, 1)) + flows[..., 2]
    return ((mx >= 0) & (mx < X) & (my >= 0) & (my < Y)
            & (mz >= 0) & (mz < Z))


def download_dtype(dtype):
    """The numpy dtype registered frames of input ``dtype`` come down in:
    the input's where the device casts it, else float32."""
    dtype = np.dtype(dtype)
    return dtype if dtype.type in _DEVICE_CAST else np.dtype(np.float32)


def cast_output(registered, dtype):
    """Registered frames (float tensor) in the input's numpy dtype where the
    device casts it (integers rounded half to even and clipped), else
    float32."""
    dtype = np.dtype(dtype)
    if dtype.type not in _DEVICE_CAST:
        return registered.to(torch.float32)
    info = np.iinfo(dtype)
    out = torch.clamp(torch.round(registered), info.min, info.max)
    return out.to(getattr(torch, dtype.name))


def destinations(n, registered=None, flows=None):
    """Where each of a batch's ``n`` downloads goes, in their order (the
    registered frames first, the flows last when they come down):
    ``registered`` and ``flows`` where given, None (a fresh array) for the
    rest."""
    dest = [registered] + [None] * (n - 1)
    if flows is not None:
        dest[-1] = flows
    return dest


class HostStaging:
    """Downloads through one reusable host buffer per output slot.

    ``download(tensors)`` copies the i-th tensor into slot i's buffer (grown
    when a batch needs more, else reused), then into a fresh pageable numpy
    array that the caller owns, or into the i-th of ``outs`` where that is
    not None (a numpy array of the tensor's shape, such as a slice of a
    whole batch's array or of a writer's, cast to its dtype by the copy);
    the buffers are never handed out. With ``pinned`` (a CUDA device) the
    buffers are page-locked and filled by ``non_blocking`` copies with one
    sync; the CPU path does not pin. ``claim``, where given, is called
    before the copy out of the buffers begins.
    """

    def __init__(self, pinned):
        self.pinned = bool(pinned)
        self.buffers = []       # flat uint8 host tensors, one per slot

    def _slot(self, i, x):
        nbytes = x.numel() * x.element_size()
        if i == len(self.buffers):
            self.buffers.append(None)
        if self.buffers[i] is None or self.buffers[i].numel() < nbytes:
            self.buffers[i] = None      # free the old block first
            with span("flowreg3d.staging_pin"):
                self.buffers[i] = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=self.pinned)
        return self.buffers[i][:nbytes].view(x.dtype).view(x.shape)

    def download(self, tensors, outs=None, claim=None):
        staged = [self._slot(i, x) for i, x in enumerate(tensors)]
        for s, x in zip(staged, tensors):
            s.copy_(x, non_blocking=self.pinned)
        if self.pinned:
            with span("flowreg3d.staging_wait"):
                torch.cuda.current_stream(tensors[0].device).synchronize()
        if claim is not None:
            with span("flowreg3d.prefault_wait"):
                claim()
        with span("flowreg3d.staging_copy"):
            outs = [torch.empty(s.shape, dtype=s.dtype).numpy()
                    if out is None else out
                    for s, out in zip(staged, outs or [None] * len(staged))]
            for s, out in zip(staged, outs):
                if out.shape != tuple(s.shape):     # a copy would broadcast
                    raise ValueError(f"download of {tuple(s.shape)} into "
                                     f"{out.shape}")
                torch.from_numpy(out).copy_(s)
        return outs


class ResidentPipeline:
    """Per-run state of the batch step: the raw and processed reference,
    the weight volume and the flow configuration key, on the executor's
    device, the run's ``HostStaging`` (and one more for each other device
    the executor's shards run on) and the flow source. ``flow_params``
    None: the flows of ``run_shards``; given: those of ``process_batch``
    with these parameters and ``get_displacement_func`` (``weight`` and
    ``config_key`` unused)."""

    def __init__(self, options, executor, reference_raw, reference_proc,
                 weight, config_key, staging, flow_params=None,
                 get_displacement_func=None):
        self.options = options
        self.executor = executor
        self.key = config_key
        self.order = _ORDERS[options.interpolation_method.value]
        self.ref_raw_d = reference_raw
        self.ref_proc_d = reference_proc
        self.weight_d = weight
        self.staging = staging
        self._stagings = {executor.device: staging}
        self.flow_params = flow_params
        self.get_displacement_func = get_displacement_func

    def ref_proc_np(self):
        """Host float64 copy of the (possibly updated) processed reference."""
        return self.ref_proc_d.detach().cpu().numpy().astype(np.float64)

    def _staging_of(self, device):
        if device not in self._stagings:
            self._stagings[device] = HostStaging(device.type == "cuda")
        return self._stagings[device]

    @staticmethod
    def _outputs(registered, flows, dtype, want_mask, keep_flows_host):
        """Cast, statistics, valid flags (and masks, flows) of frames on one
        device, on that device."""
        mask = valid_mask(flows)
        want = [cast_output(registered, dtype),
                flow_statistics_tensor(flows), mask.flatten(1).all(dim=1)]
        if want_mask:
            want.append(mask.to(torch.uint8))
        if keep_flows_host:
            want.append(flows)
        return want

    def _shards(self, raw, proc, w_init, progress_callback):
        """The frames' (start, stop, registered, flows) shards, each frame
        solved from ``w_init``: the executor's ``run_shards``, or one shard
        of its ``process_batch`` on its device."""
        if self.flow_params is None:
            uvw = w_init.expand((raw.shape[0],) + tuple(w_init.shape))
            return self.executor.run_shards(
                raw, proc, self.ref_raw_d, self.ref_proc_d, uvw,
                self.weight_d, self.key, self.order, progress_callback)
        return [(0, raw.shape[0], *self.executor.process_batch(
            raw, proc, self.ref_raw_d, self.ref_proc_d, w_init,
            get_displacement_func=self.get_displacement_func,
            interpolation_method=self.options.interpolation_method.value,
            progress_callback=progress_callback,
            flow_params=self.flow_params))]

    @staticmethod
    def _flows_from(shards, lo, device):
        """The shards' flows of frames ``lo`` on, in frame order on
        ``device``."""
        flows = [f[max(lo - a, 0):].to(device) for a, b, _, f in shards
                 if b > lo]
        return flows[0] if len(flows) == 1 else torch.cat(flows)

    def run_batch(self, batch, w_init=None, use_w_init=True,
                  want_mask=False, keep_flows_host=False,
                  update_reference=False, progress_callback=None,
                  initial_progress_callback=None, outs=(None, None),
                  claim=None):
        """One batch (T,Z,Y,X[,C]) numpy array in its native dtype.

        Returns a dict: registered (numpy, input dtype), stats (numpy
        (T, 4)), valid (numpy bool (T,)), masks (numpy uint8 (T,Z,Y,X) or
        None), flows (numpy or None), w_init (device (Z,Y,X,3) tail mean),
        initial_w (device, or None when ``w_init`` was given).

        ``outs``: host arrays of the batch's (registered, flows), either
        None, that the downloads fill (each shard its frames), cast to
        their dtypes on the way; given, they are what the dict holds.
        ``claim``: called once, before the first shard's download copies
        into them (``io.array.claim_frames`` of the writers they belong to).
        """
        batch = np.asarray(batch)
        if batch.ndim == 4:
            batch = batch[..., None]
        dev = self.executor.device
        with span("flowreg3d.upload"):
            raw_d = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
            raw = raw_d.to(self.executor.dtype)
            del raw_d
        T = batch.shape[0]

        with span("flowreg3d.enqueue"):
            proc = preprocess(raw, self.options, self.ref_raw_d, batch)
            initial_w = None
            if w_init is None:
                initial_w = w_init = torch.zeros(
                    tuple(batch.shape[1:4]) + (3,), dtype=self.executor.dtype,
                    device=dev)
                if not self.options.cc_initialization:
                    n = min(22, T)
                    initial_w = w_init = self._flows_from(self._shards(
                        raw[:n], proc[:n], w_init, initial_progress_callback),
                        0, dev).mean(dim=0)
            current = w_init if use_w_init else torch.zeros_like(w_init)

            shards = self._shards(raw, proc, current, progress_callback)
            flows = self._flows_from(
                shards, 0 if update_reference else T - min(20, T), dev)
            new_w_init = flows[-20:].mean(dim=0)
            if update_reference:
                self.ref_proc_d = updated_reference(
                    proc, flows, self.ref_proc_d, self.order,
                    self.executor.use_kernels)
        # each shard's outputs go down through its device's staging into
        # its frames of the batch's host arrays: the caller's where given
        host = None
        for a, b, r, f in shards:
            with span("flowreg3d.enqueue"):
                want = self._outputs(r, f, batch.dtype, want_mask,
                                     keep_flows_host)
            if host is None:
                host = [torch.empty((T,) + tuple(x.shape[1:]),
                                    dtype=x.dtype).numpy() if h is None else h
                        for x, h in zip(want, destinations(len(want), *outs))]
            self._staging_of(f.device).download(want, [h[a:b] for h in host],
                                                claim)
            claim = None        # the first shard claims the whole batch
        del shards, want
        reg, stats_h, valid_h = host[:3]
        return {
            "registered": reg if outs[0] is not None
            else cast_frames(reg, batch.dtype),
            "stats": stats_h,
            "valid": valid_h,
            "masks": host[3] if want_mask else None,
            "flows": host[-1] if keep_flows_host else None,
            "w_init": new_w_init,
            "initial_w": initial_w,
        }
