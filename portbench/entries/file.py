"""The file pipeline: ``compensate_recording(OFOptions(input_file=<TIFF>,
output_path=<dir>, **flow), config=RegistrationConfig(**registration))``
over one u16 recording on disk, back to back; an item is a volume. The
configuration's ``flow`` carries the deployment's I/O options (TIFF out, the
reference frames by index, ``save_w``, ``save_meta_info``); without a
``"registration"`` key, the default config (the read-ahead reader, the async
writer, the batched executor on one card).

Set-up makes the recording on the card from the seed, as ``arr`` does, and
writes it volume by volume with the benchmark's plain TIFF writer
(``reference/tiff.py``) into a temporary directory: ``rec.tif`` (``frames``
volumes) and ``warm.tif`` (its first ``warm_frames``, the warm-up call's
input); neither the host nor the card holds the whole recording. The
directory goes with the entry, or when the process ends. Every call writes
``<dir>/out/compensated.TIFF`` over the last call's.

The mix's keys are ``arr``'s; ``reference_frames`` is not read (the reference
is the configuration's). The check follows the program's chain: before each
batch the entry clones the corrector's initial flow on the card, and the
plain reference (``reference/recording.py``) starts that batch from it; the
output file and the input are decoded by ``reference/tiff.py``.
"""

import os
import shutil
import tempfile
import time
import weakref
from pathlib import Path

import numpy as np
import torch

from portbench.entries import arr
from portbench.lib import compare, synth
from portbench.lib.trace import Slice, span, sync
from portbench.reference import plain, tiff
from portbench.reference.recording import check_frames_file, mean_reference

OUTPUT = "compensated.TIFF"     # the program's name for a TIFF output
NUMBERS = ("reg_rel_rms", "reference_max_abs")


class Recording:
    """A recording on disk: its ``path`` and ``shape`` (T, Z, Y, X, C)."""

    def __init__(self, path, shape):
        self.path = str(path)
        self.shape = tuple(shape)


class Entry(arr.Entry):
    """The file pipeline over one recording on disk."""

    labels = ("compensate_recording", "BatchMotionCorrector.run")

    def setup(self):
        from flowreg3d_tpu_torch.pipeline import OFOptions
        from flowreg3d_tpu_torch.pipeline.corrector import (
            RegistrationConfig, compensate_recording)

        self._compensate = compensate_recording
        self._options = OFOptions
        reg = self.registration()
        self._config = None if reg is None else RegistrationConfig(**reg)
        self.dir = Path(tempfile.mkdtemp(prefix="portbench_file_"))
        weakref.finalize(self, shutil.rmtree, self.dir, True)
        self.out_dir = self.dir / "out"
        tr = self.traffic
        n, n_warm = int(tr["frames"]), int(tr["warm_frames"])
        volume = self.shape + (self.channels,)
        self.frames = Recording(self.dir / "rec.tif", (n,) + volume)
        warm = Recording(self.dir / "warm.tif", (n_warm,) + volume)
        g = synth.generator(self.seed, self.device)
        base = synth.scene(g, self.shape, tr["scene"])
        cam = tr["camera"]
        with tiff.Writer(self.frames.path, volume, np.uint16) as rec, \
                tiff.Writer(warm.path, volume, np.uint16) as first:
            for t in range(n):
                disp = synth.displacement(g, self.shape, tr["motion"])
                vol = synth.to_u16_on_host(synth.noisy(
                    g, cam["offset"] + cam["gain"] * synth.moved(base, disp),
                    cam["noise"]))
                rec.write(vol)
                if t < n_warm:
                    first.write(vol)
        del base
        torch.cuda.empty_cache()
        unhook = self._hook_run("warm_run_s")
        try:
            self.call(warm)
        finally:
            unhook()
        self.last = None

    def notes(self):
        return (f"{super().notes()}; recording {self.frames.path} "
                f"({os.path.getsize(self.frames.path) / 1e9:.3f} GB), "
                f"{self.free_gib():.1f} GiB free beside it")

    def free_gib(self):
        """Free space of the filesystem that holds the recording."""
        st = os.statvfs(self.dir)
        return st.f_bavail * st.f_frsize / 2 ** 30

    def call(self, recording):
        """One ``compensate_recording`` call; returns its volumes. Before
        each batch the corrector's initial flow is cloned on the card (None
        before batch 0) for the check."""
        from flowreg3d_tpu_torch.pipeline.corrector import BatchMotionCorrector

        self.last = None
        step = BatchMotionCorrector._process_batch_resident
        inits = []

        def cloned(corrector, batch):
            w = corrector.w_init
            inits.append(None if w is None else w.clone())
            return step(corrector, batch)

        opts = self._options(input_file=recording.path,
                             output_path=self.out_dir, **self.flow)
        BatchMotionCorrector._process_batch_resident = cloned
        try:
            ref = self._compensate(opts, config=self._config,
                                   device=self.device)
        finally:
            BatchMotionCorrector._process_batch_resident = step
        self.last = (recording, ref, inits)
        return recording.shape[0]

    def traced_slice(self):
        """One whole call under the profiler; returns (Slice, volumes)."""
        sl = Slice(self.device, self.labels)
        unhook = self._hook_run("slice_run_s")
        try:
            def work():
                with span("compensate_recording"):
                    return self.call(self.frames)
            n = sl.run(work)
        finally:
            unhook()
        return sl, n

    def compared(self, mm=plain.fp32_matmul):
        """The numbers of the last call's output against the reference
        (each None where the output file is not the input's layout), and
        the reference's registered volume of each sampled frame."""
        recording, ref_p, inits = self.last
        values = dict.fromkeys(NUMBERS)
        with tiff.Reader(recording.path) as src:
            try:
                out = tiff.Reader(self.out_dir / OUTPUT)
            except (OSError, ValueError):
                return values, {}
            with out:
                if out.shape != src.shape or out.dtype != src.dtype:
                    return values, {}
                return self._compared(src, out, ref_p, inits, values, mm)

    def _compared(self, src, out, ref_p, inits, values, mm):
        fl = self.flow
        mean = mean_reference(src, fl["reference_frames"])
        if np.shape(ref_p) == mean.shape:
            values["reference_max_abs"] = float(np.abs(
                np.asarray(ref_p, np.float64) - mean).max())
        try:
            regs = check_frames_file(
                src, mean, inits, self.sample(), self.params, fl["weight"],
                fl["sigma"], int(fl["buffer_size"]), self.device, mm)
        except ValueError:
            return values, {}
        values["reg_rel_rms"] = compare.worst([reg_numbers(
            torch.as_tensor(out.volume(t).astype(np.float64)).to(
                self.device), reg)
            for t, reg in regs.items()])["reg_rel_rms"]
        return values, regs

    def check(self, mm=plain.fp32_matmul):
        values, _ = self.compared(mm)
        self.last = None
        return values


def reg_numbers(reg_p, reg_r):
    """``compare.item_numbers``' ``reg_rel_rms`` of a registered volume: this
    deployment writes no flows, so none are compared (a zero flow stands on
    both sides)."""
    zero = torch.zeros((1, 3), dtype=torch.float64, device=reg_r.device)
    return {"reg_rel_rms": compare.item_numbers(zero, reg_p, zero,
                                                reg_r)["reg_rel_rms"]}


def readings(entry, control, items):
    """One call over the recording; the program's numbers on the frames its
    check samples and, with ``control``, the TF32 reference's registered
    frames against the float32 one's. ``items`` is not used: the sample is
    the check's."""
    entry.call(entry.frames)
    entry.release()
    t = time.perf_counter()
    program, ref = entry.compared()
    sync(entry.device)
    out = {"program": program}
    ref_s = time.perf_counter() - t
    if control and ref:
        _, other = entry.compared(plain.tf32_matmul)
        out["control"] = compare.worst([reg_numbers(other[k], ref[k])
                                        for k in ref])
    return out, {"reference_s": ref_s, "sample": entry.sample(),
                 "free_gib": entry.free_gib()}
