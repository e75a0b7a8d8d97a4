"""BatchMotionCorrector: the streaming motion-correction engine.

Counterpart of ``flowreg3d_tpu/pipeline/corrector.py``: I/O setup (the
output directory, the read-ahead ``PrefetchReader3D`` and the background
``AsyncWriter3D`` around the reader and writer, flows to ``w.h5`` with
datasets u, v, w when ``save_w``, the valid mask to ``valid_mask.h5`` when
``save_valid_mask``; a flow or mask writer that cannot be made warns and is
skipped), reference setup (raw and preprocessed reference, per-channel
weight volume), preprocessing ("MATLAB order": normalise against the
reference's range, then the Gaussian), progress callbacks with task ids,
the initial w (mean flow of the first <= 22 frames; zero under cc
prealignment), w_init propagation (mean of the last <= 20 flows of each
batch), per-frame flow statistics, valid-frame flags (``save_valid_idx``),
optional reference updating (<= 100 compensated frames), checkpoint/resume
(``checkpoint.npz`` after every batch: frames done, w_init, the references
and the statistics; a resumed run seeks past the frames done, and its output
file holds the frames after them), metadata files (``statistics.npz``,
``reference_frame.npy``, ``valid_idx.npy``), profiling into a Chrome trace
(``profile_dir``) and the batch loop. ``compensate_recording`` is the
file-based entry point.

Two engines run a batch. The device-resident one
(``pipeline/device_pipeline.py``) is the default wherever the configuration
allows it (``device_resident=None``); ``device_resident=True`` requires it
and raises where the configuration does not allow it;
``device_resident=False`` forces the host-staged path: the batch is uploaded
as float32 and the registered frames are cast on the host. Both engines
download through the run's ``HostStaging`` (one page-locked buffer per
output on CUDA, sized to one batch, reused by every batch and freed when
the run ends) into fresh arrays, which is what lets the async writer hold a
batch while the next one downloads. ``used_device_resident`` reports which
engine ran. ``device=None`` means 'cuda'. The reader's thread decodes with
numpy only; every upload and download stays on the calling thread.

A flow backend (``get_displacement_func``, or a registered
``flow_backend`` name instantiated once on the run's device) replaces the
variational solver on the host-staged path: the executor calls it per
frame on host numpy arrays and warps the raw frame on the device.
"""

import os
import warnings
from dataclasses import dataclass
from pathlib import Path
from time import strftime, time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch._trace import span
from flowreg3d_tpu_torch.io.async_writer import AsyncWriter3D
from flowreg3d_tpu_torch.io.factory import get_video_file_writer
from flowreg3d_tpu_torch.io.prefetch import PrefetchReader3D
from flowreg3d_tpu_torch.parallel.executors import _config_key, get_executor
from flowreg3d_tpu_torch.pipeline.device_pipeline import (HostStaging,
                                                          ResidentPipeline,
                                                          host_cast,
                                                          preprocess,
                                                          resident_supported,
                                                          updated_reference,
                                                          valid_mask)
from flowreg3d_tpu_torch.pipeline.of_options import OFOptions, OutputFormat
from flowreg3d_tpu_torch.pipeline.stats import flow_statistics_tensor


@dataclass
class RegistrationConfig:
    """Execution knobs.

    ``parallelization``: None = auto ('mesh' when more than one card is
    visible, else 'batched'), or 'batched' / 'sequential' / 'mesh' /
    'spatial' (aliases 'threading3d' / 'sequential3d' /
    'multiprocessing3d'). ``devices``: the devices of 'mesh' and 'spatial'
    (a device may repeat; None: every visible card, or the run's device on
    the CPU). ``use_kernels``: run the CUDA kernels
    (True) or their plain PyTorch versions (False). ``device_resident``:
    None = the resident engine wherever the configuration allows it, True =
    require it, False = the host-staged path. ``profile_dir``: write a
    torch.profiler Chrome trace of the run there. ``prefetch``: batches the
    reader's thread decodes ahead (0: none). ``async_write``: a writer
    thread encodes file output. ``checkpoint``: write ``checkpoint.npz``
    after every batch of a file run, and resume from it.
    ``get_displacement_func``: a callable with the ``get_displacement``
    protocol replacing the variational solver; ``flow_backend``: the name
    of a registered backend (``runtime.register_flow_backend``; 'volraft'
    and 'volraft-mock' are built in) to instantiate for it.
    """

    verbose: bool = False
    parallelization: Optional[str] = None
    devices: Optional[List] = None
    use_kernels: bool = True
    checkpoint: bool = False
    profile_dir: Optional[str] = None
    prefetch: int = 2
    async_write: bool = True
    device_resident: Optional[bool] = None
    get_displacement_func: Optional[Callable] = None
    flow_backend: Optional[str] = None


class BatchMotionCorrector:
    """Streaming batch registration pipeline."""

    def __init__(self, options: OFOptions,
                 config: Optional[RegistrationConfig] = None, device=None):
        self.options = options
        self.config = config or RegistrationConfig()
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
        self.valid_writer = None
        self.valid_idx: List[bool] = []
        self._resident = None
        self._staging = None
        self.used_device_resident = False   # which engine the last run used

        self.progress_callbacks: List[Callable[[int, Optional[int]], None]] = []
        self._progress: Dict[str, Tuple[int, Optional[int]]] = {}
        self._total_frames: Optional[int] = None
        self._reference_raw_d = None

        devices = ({} if self.config.devices is None
                   else {"devices": self.config.devices})
        self.executor = get_executor(self.config.parallelization,
                                     device=self.device,
                                     use_kernels=self.config.use_kernels,
                                     **devices)
        if self.config.verbose:
            print(f"Using {self.executor.name} executor "
                  f"({self.executor.get_info()})")

    # -- setup --------------------------------------------------------------

    def _to_file(self):
        return self.options.output_format != OutputFormat.ARRAY

    def _setup_io(self):
        output_path = Path(self.options.output_path)
        if self._to_file():
            output_path.mkdir(parents=True, exist_ok=True)
        self.video_reader = self.options.get_video_reader()
        if self.config.prefetch and self.config.prefetch > 0:
            self.video_reader = PrefetchReader3D(
                self.video_reader, prefetch_depth=self.config.prefetch)
        self.video_writer = self.options.get_video_writer()
        if self.config.async_write and self._to_file():
            self.video_writer = AsyncWriter3D(self.video_writer)
        if self.options.save_w:
            try:
                if self._to_file():
                    self.w_writer = get_video_file_writer(
                        str(output_path / "w.h5"), "HDF5",
                        dataset_names=["u", "v", "w"])
                else:
                    self.w_writer = get_video_file_writer(None, "ARRAY")
            except Exception as e:
                warnings.warn(f"Failed to create displacement writer: {e}. "
                              "Displacements will not be saved.")
                self.w_writer = None
                self.options.save_w = False
        # a voxel is valid when its warp sample stayed in bounds (was not
        # filled from the reference volume)
        self.valid_writer = None
        if self.options.save_valid_mask and self._to_file():
            try:
                self.valid_writer = get_video_file_writer(
                    str(output_path / "valid_mask.h5"), "HDF5")
            except Exception as e:
                warnings.warn(f"Failed to create valid-mask writer: {e}.")

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
        self.reference_proc = self._preprocess_frames(self._reference_raw_d,
                                                      self.reference_raw)

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

    def _preprocess_frames(self, frames, host_frames,
                           normalization_ref=None):
        """normalize (optionally against the reference's range), then the
        Gaussian, on the device tensor ``frames``. A user ``preproc_funct``
        replaces the chain: as in the JAX package it gets the host numpy
        array ``host_frames``, and its result is uploaded as float32."""
        if self.options.preproc_funct is not None:
            return self._upload(self.options.preproc_funct(host_frames))
        return preprocess(frames, self.options, normalization_ref)

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
        fp["cc_initialization"] = self.options.cc_initialization
        fp["cc_hw"] = self.options.cc_hw
        fp["cc_up"] = self.options.cc_up
        return fp

    def _process_batch(self, batch, batch_proc, w_init, task_id="main"):
        cb = None
        if self.progress_callbacks and task_id == "main":
            cb = lambda n: self._notify(n, task_id)  # noqa: E731
        return self.executor.process_batch(
            batch, batch_proc, self._reference_raw_d, self.reference_proc,
            w_init, get_displacement_func=self._resolve_flow_backend(),
            interpolation_method=self.options.interpolation_method.value,
            progress_callback=cb, flow_params=self._flow_params())

    def _resolve_flow_backend(self):
        """The callable replacing the variational solver, or None. A named
        backend is instantiated once, on the run's device, and kept on the
        config, as in the JAX package."""
        if self.config.get_displacement_func is not None:
            return self.config.get_displacement_func
        if self.config.flow_backend not in (None, "", "variational"):
            import flowreg3d_tpu_torch.backends  # noqa: F401  (built-ins)
            from flowreg3d_tpu_torch.runtime import get_flow_backend

            fn = get_flow_backend(self.config.flow_backend,
                                  device=self.device,
                                  use_kernels=self.config.use_kernels)
            self.config.get_displacement_func = fn  # instantiate once
            return fn
        return None

    def _compute_initial_w(self, batch, batch_proc):
        Z, Y, X = self.reference_proc.shape[:3]
        zeros = torch.zeros((Z, Y, X, 3), dtype=torch.float32,
                            device=self.device)
        if self.options.cc_initialization:
            return zeros
        n_init = min(22, batch.shape[0])
        _, w = self._process_batch(batch[:n_init], batch_proc[:n_init], zeros,
                                   task_id="initial_w")
        return w.mean(dim=0)

    def _update_reference(self, batch_proc, w):
        order = 3 if self.options.interpolation_method.value == "cubic" else 1
        self.reference_proc = updated_reference(batch_proc, w,
                                                self.reference_proc, order,
                                                self.config.use_kernels)

    @staticmethod
    def _valid_mask(w):
        """(T,Z,Y,X) bool tensor: the warp's sample coordinates stayed in
        bounds (``w`` a (T,Z,Y,X,3) tensor or array)."""
        return valid_mask(torch.as_tensor(w))

    # -- device-resident engine ---------------------------------------------

    def _setup_resident(self):
        """The run's download staging, and the resident engine where the
        configuration allows it. Unlike the JAX package, a failure to build
        the engine raises instead of warning and taking the host-staged
        path."""
        self._staging = HostStaging(pinned=self.device.type == "cuda")
        self._resident = None
        if not resident_supported(self.options, self.config, self.executor):
            if self.config.device_resident is True:
                raise ValueError(
                    "device_resident=True but the configuration requires the "
                    "host-staged path (a custom preproc_funct, a flow "
                    "backend or cc_initialization)")
            return
        fp = self._flow_params()
        self._resident = ResidentPipeline(
            self.options, self.executor, self._reference_raw_d,
            self.reference_proc,
            self.executor._weight_volume(fp, self.reference_proc),
            _config_key(self.reference_proc, fp, self.executor.dtype,
                        self.executor.use_kernels), self._staging)

    def _process_batch_resident(self, batch):
        """One batch through the resident engine; returns its result
        dict."""
        icb = ((lambda n: self._notify(n, "initial_w"))
               if self.progress_callbacks else None)
        cb = (lambda n: self._notify(n)) if self.progress_callbacks else None
        out = self._resident.run_batch(
            batch, w_init=self.w_init,
            use_w_init=self.options.update_initialization_w,
            want_mask=self.valid_writer is not None,
            keep_flows_host=self.w_writer is not None,
            update_reference=self.options.update_reference,
            progress_callback=cb, initial_progress_callback=icb)
        if self.w_init is None:
            self.w_init = out["initial_w"]
        if self.options.update_initialization_w:
            self.w_init = out["w_init"]
        self.reference_proc = self._resident.ref_proc_d
        return out

    # -- run ----------------------------------------------------------------

    def run(self, reference_frame=None):
        if not self.config.profile_dir:
            return self._run(reference_frame)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = self._run(reference_frame)
        trace_dir = Path(self.config.profile_dir)
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(
            trace_dir / f"trace_{strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
            ".json"))
        return out

    def _run(self, reference_frame=None):
        self._setup_io()
        self._setup_reference(reference_frame)
        self._total_frames = len(self.video_reader)
        frames_done = self._resume()
        self._setup_resident()
        self.used_device_resident = self._resident is not None

        if self.config.verbose:
            print(f"Starting compensation with "
                  f"quality={self.options.quality_setting.value}, "
                  f"buffer={self.options.buffer_size}, device-resident "
                  f"{self.used_device_resident}")

        batch_idx = 0
        total_frames = frames_done
        start_time = time()
        try:
            while self.video_reader.has_batch():
                batch_idx += 1
                t0 = time()
                with span("flowreg3d.read"):
                    batch = self._select_channels(
                        self.video_reader.read_batch())
                if self._resident is not None:
                    out = self._process_batch_resident(batch)
                    registered, stats = out["registered"], out["stats"]
                    flows, valid, masks = (out["flows"], out["valid"],
                                           out["masks"])
                else:
                    registered, stats, flows, valid, masks = \
                        self._host_staged_batch(batch)
                self.mean_disp.extend(stats[:, 0].tolist())
                self.max_disp.extend(stats[:, 1].tolist())
                self.mean_div.extend(stats[:, 2].tolist())
                self.mean_translation.extend(stats[:, 3].tolist())
                self.video_writer.write_frames(registered)
                if self.w_writer is not None:
                    self.w_writer.write_frames(flows)
                if self.valid_writer is not None:
                    self.valid_writer.write_frames(masks[..., None])
                if self.options.save_valid_idx:
                    self.valid_idx.extend(valid.tolist())

                total_frames += registered.shape[0]
                self._save_checkpoint(total_frames)
                if self.config.verbose:
                    dt = time() - t0
                    print(f"Batch {batch_idx}: {registered.shape[0]} frames "
                          f"in {dt:.2f}s ({registered.shape[0] / dt:.1f} fps)")
        except BaseException:
            # an interrupted run keeps its checkpoint; its threads and files
            # are closed before the error goes on
            self._close_streams()
            raise
        finally:
            self.executor.cleanup()
            self._resident = None
            self._staging = None

        if self.config.verbose:
            dt = time() - start_time
            print(f"Processed {total_frames} frames in {dt:.2f}s "
                  f"(avg {total_frames / max(dt, 1e-6):.1f} fps)")
        self._save_metadata()
        self._cleanup()
        return self.reference_raw

    def _host_staged_batch(self, batch):
        """One batch on the host-staged path: returns (registered numpy in
        the input dtype, stats (T, 4), flows numpy or None, valid (T,),
        masks uint8 (T,Z,Y,X) or None)."""
        with span("flowreg3d.upload"):
            batch_d = self._upload(batch)
        with span("flowreg3d.enqueue"):
            batch_proc = self._preprocess_frames(
                batch_d, batch, normalization_ref=self._reference_raw_d)

            if self.w_init is None:
                self.w_init = self._compute_initial_w(batch_d, batch_proc)
            current_w_init = (self.w_init
                              if self.options.update_initialization_w
                              else torch.zeros_like(self.w_init))

            registered, w = self._process_batch(batch_d, batch_proc,
                                                current_w_init)
            if self.options.update_initialization_w:
                self.w_init = w[-20:].mean(dim=0)

            mask = self._valid_mask(w)
            want = [registered, flow_statistics_tensor(w),
                    mask.flatten(1).all(dim=1)]
            if self.valid_writer is not None:
                want.append(mask.to(torch.uint8))
            if self.w_writer is not None:
                want.append(w)
            if self.options.update_reference:
                self._update_reference(batch_proc, w)
        host = self._staging.download(want)
        masks = host[3] if self.valid_writer is not None else None
        flows = host[-1] if self.w_writer is not None else None
        return (host_cast(host[0], batch.dtype), host[1], flows, host[2],
                masks)

    # -- checkpoint / resume ------------------------------------------------

    def _checkpoint_path(self):
        return Path(self.options.output_path) / "checkpoint.npz"

    def _save_checkpoint(self, frames_done):
        """Between batches: the frames done, w_init and the preprocessed
        reference (downloaded from the device; never inside a capture), the
        raw reference and the statistics so far. Written to a temporary
        file and renamed, so an interrupt leaves the previous checkpoint."""
        if not self.config.checkpoint or not self._to_file():
            return
        path = self._checkpoint_path()
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, frames_done=frames_done,
                     w_init=(self.w_init.cpu().numpy()
                             if self.w_init is not None else 0),
                     reference_raw=self.reference_raw,
                     reference_proc=self.reference_proc.cpu().numpy(),
                     mean_disp=np.asarray(self.mean_disp),
                     max_disp=np.asarray(self.max_disp),
                     mean_div=np.asarray(self.mean_div),
                     mean_translation=np.asarray(self.mean_translation),
                     valid_idx=np.asarray(self.valid_idx, bool))
        os.replace(tmp, path)

    def _resume(self):
        """Restore the state of an existing checkpoint and move the reader
        past the frames it has done; returns their number (0 without a
        checkpoint). The restored w_init and references are uploaded as
        float32, as the interrupted run held them, so the run replays the
        same graph and gives its output bit for bit."""
        p = self._checkpoint_path()
        if not (self.config.checkpoint and self._to_file() and p.exists()):
            return 0
        with np.load(p, allow_pickle=False) as ckpt:
            ckpt = dict(ckpt)
        frames_done = int(ckpt["frames_done"])
        w_init = np.asarray(ckpt["w_init"], np.float32)
        self.w_init = self._upload(w_init) if w_init.ndim else None
        self.reference_raw = np.asarray(ckpt["reference_raw"], np.float64)
        self._reference_raw_d = self._upload(self.reference_raw)
        self.reference_proc = self._upload(ckpt["reference_proc"])
        # the statistics so far, so the metadata of a resumed run matches an
        # uninterrupted one
        for key in ("mean_disp", "max_disp", "mean_div", "mean_translation"):
            if key in ckpt:
                getattr(self, key).extend(
                    np.asarray(ckpt[key]).reshape(-1).tolist())
        if "valid_idx" in ckpt:
            self.valid_idx.extend(np.asarray(ckpt["valid_idx"], bool)
                                  .reshape(-1).tolist())
        if self.config.verbose:
            print(f"Resuming from checkpoint at frame {frames_done}")
        # fast-forward without decoding the frames done
        self.video_reader.seek_frame(frames_done)
        return frames_done

    # -- teardown -----------------------------------------------------------

    def _save_metadata(self):
        if not self.options.save_meta_info or not self._to_file():
            return
        out = Path(self.options.output_path)
        try:
            out.mkdir(parents=True, exist_ok=True)
            np.savez(out / "statistics.npz",
                     mean_disp=np.asarray(self.mean_disp),
                     max_disp=np.asarray(self.max_disp),
                     mean_div=np.asarray(self.mean_div),
                     mean_translation=np.asarray(self.mean_translation))
            np.save(out / "reference_frame.npy", self.reference_raw)
            if self.options.save_valid_idx:
                np.save(out / "valid_idx.npy",
                        np.asarray(self.valid_idx, bool))
        except Exception as e:
            warnings.warn(f"Failed to save metadata: {e}")

    def _close_streams(self):
        """Close the writers (flushing the async one) and the reader; the
        first error raised is returned."""
        error = None
        for closer in (self.video_writer, self.w_writer, self.valid_writer,
                       self.video_reader):
            if closer is not None:
                try:
                    closer.close()
                except Exception as e:
                    error = error or e
        return error

    def _cleanup(self):
        """Close the streams; then delete the checkpoint, unless a writer
        failed (its error is raised)."""
        error = self._close_streams()
        if error is not None:
            raise error
        p = self._checkpoint_path()
        if self.config.checkpoint and p.exists():
            p.unlink()


def compensate_recording(options: OFOptions, reference_frame=None,
                         config: Optional[RegistrationConfig] = None,
                         device=None):
    """Register the recording ``options.input_file`` (a file, a folder, a
    list of channel files, an array or a reader) and write the result to
    ``options.output_path`` in ``options.output_format``, with the metadata
    files. Returns the raw reference (Z,Y,X,C). ``device=None`` means
    'cuda'."""
    return BatchMotionCorrector(options, config, device).run(reference_frame)
