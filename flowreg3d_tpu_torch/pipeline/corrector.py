"""BatchMotionCorrector: the streaming motion-correction engine.

Counterpart of ``flowreg3d_tpu/pipeline/corrector.py``, host-staged path:
reference setup (raw and preprocessed reference, per-channel weight volume),
preprocessing ("MATLAB order": normalise against the reference's range,
then the Gaussian), progress callbacks with task ids, the initial w (mean
flow of the first <= 22 frames), w_init propagation (mean of the last <= 20
flows of each batch), per-frame flow statistics, optional reference updating
(<= 100 compensated frames) and the batch loop.

Each batch is uploaded once; preprocessing, flows, warps, statistics and
w_init stay on the device, and the registered frames (and flows, when
``save_w``) come back once per batch. ``device=None`` means 'cuda'.

Not ported yet, and raising where asked for (ROADMAP.md Queue 1 items 8-10,
12): checkpoint/resume, prefetch, the async writer, profiling, the
device-resident engine, flow backends, cross-correlation initialisation,
valid-mask outputs and file formats (so also metadata files). The port's
``RegistrationConfig`` therefore defaults ``prefetch``, ``async_write`` and
``device_resident`` to off.
"""

import warnings
from dataclasses import dataclass
from time import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.io.factory import get_video_file_writer
from flowreg3d_tpu_torch.ops.filters import apply_gaussian_filter, normalize
from flowreg3d_tpu_torch.ops.warp import warp
from flowreg3d_tpu_torch.parallel.executors import get_executor
from flowreg3d_tpu_torch.pipeline.of_options import OFOptions
from flowreg3d_tpu_torch.pipeline.stats import flow_statistics


@dataclass
class RegistrationConfig:
    """Execution knobs.

    ``parallelization``: None or 'sequential' (alias 'sequential3d'); the
    other executors are not ported yet. ``use_kernels``: run the CUDA
    kernels (True) or their plain PyTorch versions (False).
    """

    verbose: bool = False
    parallelization: Optional[str] = None
    use_kernels: bool = True
    checkpoint: bool = False
    profile_dir: Optional[str] = None
    prefetch: int = 0
    async_write: bool = False
    device_resident: Optional[bool] = False
    get_displacement_func: Optional[Callable] = None
    flow_backend: Optional[str] = None


# config field -> (the values that ask for nothing, where it is queued)
_NOT_PORTED = {
    "checkpoint": ((False,), "Queue 1 item 8"),
    "profile_dir": ((None,), "Queue 1 item 8"),
    "prefetch": ((0, None), "Queue 1 item 8"),
    "async_write": ((False,), "Queue 1 item 8"),
    "device_resident": ((False, None), "Queue 1 item 8"),
    "get_displacement_func": ((None,), "Queue 1 item 13"),
    "flow_backend": ((None, "", "variational"), "Queue 1 item 13"),
}


class BatchMotionCorrector:
    """Streaming batch registration pipeline."""

    def __init__(self, options: OFOptions,
                 config: Optional[RegistrationConfig] = None, device=None):
        self.options = options
        self.config = config or RegistrationConfig()
        for name, (off, queue) in _NOT_PORTED.items():
            if getattr(self.config, name) not in off:
                raise NotImplementedError(
                    f"RegistrationConfig.{name}={getattr(self.config, name)!r}"
                    " is not ported to flowreg3d_tpu_torch yet (ROADMAP.md "
                    f"{queue})")
        for name, queue in (("cc_initialization", "Queue 1 item 9"),
                            ("save_valid_idx", "Queue 1 item 8")):
            if getattr(options, name):
                raise NotImplementedError(
                    f"OFOptions.{name} is not ported to flowreg3d_tpu_torch "
                    f"yet (ROADMAP.md {queue})")
        self.device = resolve_device(device)

        self.mean_disp: List[float] = []
        self.max_disp: List[float] = []
        self.mean_div: List[float] = []
        self.mean_translation: List[float] = []

        self.reference_raw = None       # (Z,Y,X,C) float64 numpy
        self.reference_proc = None      # (Z,Y,X,C) tensor on the device
        self.weight = None
        self.w_init = None              # (Z,Y,X,3) tensor on the device

        self.video_reader = None
        self.video_writer = None
        self.w_writer = None

        self.progress_callbacks: List[Callable[[int, Optional[int]], None]] = []
        self._progress: Dict[str, Tuple[int, Optional[int]]] = {}
        self._total_frames: Optional[int] = None
        self._reference_raw_d = None

        self.executor = get_executor(self.config.parallelization,
                                     device=self.device,
                                     use_kernels=self.config.use_kernels)
        if self.config.verbose:
            print(f"Using {self.executor.name} executor "
                  f"({self.executor.get_info()})")

    # -- setup --------------------------------------------------------------

    def _setup_io(self):
        self.video_reader = self.options.get_video_reader()
        self.video_writer = self.options.get_video_writer()
        if self.options.save_w:
            self.w_writer = get_video_file_writer(None,
                                                  self.options.output_format)

    def _setup_reference(self, reference_frame=None):
        if reference_frame is None:
            ref = self.options.get_reference_frame(
                self.video_reader, config=self.config, device=self.device)
        else:
            ref = reference_frame
        ref = self._select_channels(np.asarray(ref))
        self.reference_raw = np.asarray(ref, np.float64)
        if self.reference_raw.ndim == 3:
            self.reference_raw = self.reference_raw[..., np.newaxis]
        Z, Y, X, C = self.reference_raw.shape

        self.weight = np.ones((Z, Y, X, C), np.float64)
        for c in range(C):
            self.weight[..., c] = self.options.get_weight_at(c, C)

        self._reference_raw_d = self._upload(self.reference_raw)
        self.reference_proc = self._preprocess_frames(self._reference_raw_d)

    def _upload(self, frames):
        return torch.as_tensor(np.asarray(frames)).to(device=self.device,
                                                      dtype=torch.float32)

    # -- preprocessing ------------------------------------------------------

    def _select_channels(self, frames):
        """Apply options.channel_idx (0-based channel subset) if set."""
        idx = self.options.channel_idx
        if idx:
            frames = np.asarray(frames)[..., list(idx)]
        return frames

    def _preprocess_frames(self, frames, normalization_ref=None):
        """normalize (optionally against the reference's range), then the
        Gaussian; a user ``preproc_funct`` (tensor in, tensor or array out)
        replaces the chain."""
        if self.options.preproc_funct is not None:
            return torch.as_tensor(self.options.preproc_funct(frames)).to(
                device=self.device, dtype=torch.float32)
        mode = ("separate" if self.options.channel_normalization.value
                == "separate" else "together")
        normalized = normalize(frames, ref=normalization_ref,
                               channel_normalization=mode)
        return apply_gaussian_filter(normalized,
                                     np.asarray(self.options.sigma, float))

    # -- progress -----------------------------------------------------------

    def register_progress_callback(self, callback):
        self.progress_callbacks.append(callback)

    def _notify(self, n_done, task_id="main"):
        done, total = self._progress.get(task_id, (0, self._total_frames))
        done += n_done
        self._progress[task_id] = (done, total)
        if task_id != "main":
            return
        for cb in self.progress_callbacks:
            try:
                cb(done, total)
            except Exception as e:  # a user's callback must not stop the run
                warnings.warn(f"progress callback {cb!r} raised {e!r}")

    # -- batch processing ---------------------------------------------------

    def _flow_params(self):
        fp = self.options.to_dict()
        fp["weight"] = self.weight
        return fp

    def _process_batch(self, batch, batch_proc, w_init, task_id="main"):
        cb = None
        if self.progress_callbacks and task_id == "main":
            cb = lambda n: self._notify(n, task_id)  # noqa: E731
        return self.executor.process_batch(
            batch, batch_proc, self._reference_raw_d, self.reference_proc,
            w_init, self.options.interpolation_method.value, cb,
            self._flow_params())

    def _compute_initial_w(self, batch, batch_proc):
        Z, Y, X = self.reference_proc.shape[:3]
        n_init = min(22, batch.shape[0])
        zeros = torch.zeros((Z, Y, X, 3), dtype=torch.float32,
                            device=self.device)
        _, w = self._process_batch(batch[:n_init], batch_proc[:n_init], zeros,
                                   task_id="initial_w")
        return w.mean(dim=0)

    def _update_reference(self, batch_proc, w):
        n = min(100, batch_proc.shape[0])
        order = 3 if self.options.interpolation_method.value == "cubic" else 1
        comp = [warp(batch_proc[t], w[t, ..., 0], w[t, ..., 1], w[t, ..., 2],
                     self.reference_proc, order, self.config.use_kernels)
                for t in range(batch_proc.shape[0] - n, batch_proc.shape[0])]
        self.reference_proc = torch.stack(comp).mean(dim=0)

    @staticmethod
    def _to_host(registered, dtype):
        """Download and cast to the input's dtype (integers rounded and
        clipped)."""
        out = registered.cpu().numpy()
        if np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            return np.clip(np.rint(out), info.min, info.max).astype(dtype)
        return out.astype(dtype, copy=False)

    # -- run ----------------------------------------------------------------

    def run(self, reference_frame=None):
        self._setup_io()
        self._setup_reference(reference_frame)
        self._total_frames = len(self.video_reader)

        if self.config.verbose:
            print(f"Starting compensation with "
                  f"quality={self.options.quality_setting.value}, "
                  f"buffer={self.options.buffer_size}")

        batch_idx = 0
        total_frames = 0
        start_time = time()
        try:
            while self.video_reader.has_batch():
                batch_idx += 1
                t0 = time()
                batch = self._select_channels(self.video_reader.read_batch())
                batch_d = self._upload(batch)
                batch_proc = self._preprocess_frames(
                    batch_d, normalization_ref=self._reference_raw_d)

                if self.w_init is None:
                    self.w_init = self._compute_initial_w(batch_d, batch_proc)
                current_w_init = (self.w_init
                                  if self.options.update_initialization_w
                                  else torch.zeros_like(self.w_init))

                registered, w = self._process_batch(batch_d, batch_proc,
                                                    current_w_init)
                if self.options.update_initialization_w:
                    self.w_init = w[-20:].mean(dim=0)

                stats = flow_statistics(w)
                self.mean_disp.extend(stats["mean_disp"])
                self.max_disp.extend(stats["max_disp"])
                self.mean_div.extend(stats["mean_div"])
                self.mean_translation.extend(stats["mean_translation"])

                self.video_writer.write_frames(
                    self._to_host(registered, batch.dtype))
                if self.w_writer is not None:
                    self.w_writer.write_frames(w.cpu().numpy())
                if self.options.update_reference:
                    self._update_reference(batch_proc, w)

                total_frames += registered.shape[0]
                if self.config.verbose:
                    dt = time() - t0
                    print(f"Batch {batch_idx}: {registered.shape[0]} frames "
                          f"in {dt:.2f}s ({registered.shape[0] / dt:.1f} fps)")
        finally:
            self.executor.cleanup()

        if self.config.verbose:
            dt = time() - start_time
            print(f"Processed {total_frames} frames in {dt:.2f}s "
                  f"(avg {total_frames / max(dt, 1e-6):.1f} fps)")
        for closer in (self.video_writer, self.w_writer, self.video_reader):
            if closer is not None:
                closer.close()
        return self.reference_raw

