"""Device-resident batch engine: raw frames up once, registered frames down
once.

Counterpart of ``flowreg3d_tpu/pipeline/device_pipeline.py``. Per batch:

  upload the raw batch once in its native dtype (u16: 33.5 MB a
  64x512x512 frame, against 67 MB as float32)
    -> preprocess on the device (normalise against the reference's range,
       then the Gaussian, the temporal sigma across the batch included)
    -> flows from the executor, one shared w_init (the batched executor
       replays one CUDA graph a frame)
    -> finalize on the device: the warp of the raw frame (in the executor's
       graph), the native-dtype cast (rint and clip for integers), the
       (T, 4) statistics and the in-bounds valid flag and mask
  download the registered batch in its native dtype and the statistics.

The initial w (mean flow of the first <= 22 frames), the w_init tail mean
(last <= 20 flows) and the reference update (mean of the last <= 100
compensated frames) stay on the device. The downloads go through
``HostStaging``: on CUDA one page-locked buffer per output, sized to one
batch and reused by every batch, ``non_blocking`` copies and one sync a
batch, then a copy into pageable memory that is handed out, so the pinned
memory never exceeds one batch. The full flows come down only when asked
for (``keep_flows_host``). The CPU path never pins.

The stages and the download are the host-staged path's own
(``preprocess``, ``updated_reference``, ``valid_mask``, ``cast_output``,
``HostStaging``), so the two paths compute the same numbers; they differ in
what the upload carries (the native dtype here, float32 there) and where
the registered frames are cast.

The flows come from the executor's ``run_shards``: one shard on the run's
device for the sequential and batched executors, one a device for the mesh
executor (JAX's mesh mode; the batch is uploaded and preprocessed on the
run's device as above, since the temporal Gaussian spans the batch). Each
shard is finalized on its device (cast, statistics, valid flags and masks)
and downloaded through that device's own ``HostStaging`` into its frames
of the batch's host arrays. Only the flows the w_init tail mean needs (the
last <= 20), and all of them when the reference is updated, come back to
the run's device.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch._trace import span
from flowreg3d_tpu_torch.ops.filters import apply_gaussian_filter, normalize
from flowreg3d_tpu_torch.ops.warp import warp
from flowreg3d_tpu_torch.pipeline.stats import flow_statistics_tensor

__all__ = ["ResidentPipeline", "resident_supported", "preprocess",
           "updated_reference", "valid_mask", "cast_output", "HostStaging"]

_ORDERS = {"cubic": 3, "linear": 1}
# integer dtypes the registered frames are cast to on the device (others
# come down as float32 and are cast on the host)
_DEVICE_CAST = (np.uint8, np.int8, np.int16, np.uint16)


def resident_supported(options, config, executor) -> bool:
    """True when the batch can run device-resident: not for a user
    ``preproc_funct`` or a flow backend (host protocols), nor for the cc
    prealignment, which the host-staged path runs; the spatial executor
    drives its frames itself."""
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


def preprocess(frames, options, normalization_ref=None):
    """normalize (against the reference's range when given), then the
    MATLAB-order Gaussian, on the device tensor ``frames``."""
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


def host_cast(registered, dtype):
    """A downloaded registered batch in the input's dtype (integers rounded
    half to even and clipped)."""
    if registered.dtype == dtype:
        return registered
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(registered), info.min, info.max).astype(dtype)
    return registered.astype(dtype)


class HostStaging:
    """Downloads through one reusable host buffer per output slot.

    ``download(tensors)`` copies the i-th tensor into slot i's buffer (grown
    when a batch needs more, else reused), then into a fresh pageable numpy
    array that the caller owns, or into the i-th of ``outs`` (numpy arrays of
    the tensors' shapes and dtypes, such as slices of a whole batch's
    arrays); the buffers are never handed out. With ``pinned`` (a CUDA
    device) the buffers are page-locked and filled by ``non_blocking``
    copies with one sync; the CPU path does not pin.
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

    def download(self, tensors, outs=None):
        staged = [self._slot(i, x) for i, x in enumerate(tensors)]
        for s, x in zip(staged, tensors):
            s.copy_(x, non_blocking=self.pinned)
        if self.pinned:
            with span("flowreg3d.staging_wait"):
                torch.cuda.current_stream(tensors[0].device).synchronize()
        with span("flowreg3d.staging_copy"):
            if outs is None:
                outs = [torch.empty(s.shape, dtype=s.dtype).numpy()
                        for s in staged]
            for s, out in zip(staged, outs):
                torch.from_numpy(out).copy_(s)
        return outs


class ResidentPipeline:
    """Per-run device state of the resident engine: the raw and processed
    reference, the weight volume and the flow configuration key, on the
    executor's device, and the run's ``HostStaging`` (and one more for each
    other device the executor's shards run on)."""

    def __init__(self, options, executor, reference_raw, reference_proc,
                 weight, config_key, staging):
        self.options = options
        self.executor = executor
        self.key = config_key
        self.order = _ORDERS[options.interpolation_method.value]
        self.ref_raw_d = reference_raw
        self.ref_proc_d = reference_proc
        self.weight_d = weight
        self.staging = staging
        self._stagings = {executor.device: staging}

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

    def _flows(self, raw, proc, w_init, progress_callback):
        T = raw.shape[0]
        uvw = w_init.expand((T,) + tuple(w_init.shape))
        return self.executor._run(raw, proc, self.ref_raw_d, self.ref_proc_d,
                                  uvw, self.weight_d, self.key, self.order,
                                  progress_callback)

    def run_batch(self, batch, w_init=None, use_w_init=True,
                  want_mask=False, keep_flows_host=False,
                  update_reference=False, progress_callback=None,
                  initial_progress_callback=None):
        """One batch (T,Z,Y,X[,C]) numpy array in its native dtype.

        Returns a dict: registered (numpy, input dtype), stats (numpy
        (T, 4)), valid (numpy bool (T,)), masks (numpy uint8 (T,Z,Y,X) or
        None), flows (numpy or None), w_init (device (Z,Y,X,3) tail mean),
        initial_w (device, or None when ``w_init`` was given).
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
            proc = preprocess(raw, self.options, self.ref_raw_d)
            initial_w = None
            if w_init is None:
                n = min(22, T)
                zeros = torch.zeros(tuple(batch.shape[1:4]) + (3,),
                                    dtype=self.executor.dtype, device=dev)
                _, fl = self._flows(raw[:n], proc[:n], zeros,
                                    initial_progress_callback)
                initial_w = w_init = fl.mean(dim=0)
                del fl
            current = w_init if use_w_init else torch.zeros_like(w_init)

            uvw = current.expand((T,) + tuple(current.shape))
            shards = self.executor.run_shards(
                raw, proc, self.ref_raw_d, self.ref_proc_d, uvw,
                self.weight_d, self.key, self.order, progress_callback)
            # the flows needed here, in frame order on the run's device
            lo = 0 if update_reference else T - min(20, T)
            flows = [f[max(lo - a, 0):].to(dev) for a, b, _, f in shards
                     if b > lo]
            flows = flows[0] if len(flows) == 1 else torch.cat(flows)
            new_w_init = flows[-20:].mean(dim=0)
            if update_reference:
                self.ref_proc_d = updated_reference(
                    proc, flows, self.ref_proc_d, self.order,
                    self.executor.use_kernels)
        # each shard's outputs go down through its device's staging into
        # its frames of the batch's host arrays
        host = None
        for a, b, r, f in shards:
            with span("flowreg3d.enqueue"):
                want = self._outputs(r, f, batch.dtype, want_mask,
                                     keep_flows_host)
            if host is None:
                host = [torch.empty((T,) + tuple(x.shape[1:]),
                                    dtype=x.dtype).numpy() for x in want]
            self._staging_of(f.device).download(want, [h[a:b] for h in host])
        del shards, want
        reg, stats_h, valid_h = host[:3]
        return {
            "registered": host_cast(reg, batch.dtype),
            "stats": stats_h,
            "valid": valid_h,
            "masks": host[3] if want_mask else None,
            "flows": host[-1] if keep_flows_host else None,
            "w_init": new_w_init,
            "initial_w": initial_w,
        }
