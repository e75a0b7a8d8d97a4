"""The in-memory pipeline: ``compensate_arr_3D(frames, reference,
OFOptions(**flow), config=RegistrationConfig(**registration))`` over one
integer recording held in host memory, back to back; an item is a volume.
Without a ``"registration"`` key in the configuration or the mix, the
default config (one card: the batched executor and the resident engine; more
than one: the mesh executor over every card).

The mix's keys: ``frames``, ``reference_frames`` (the reference is the mean of
the first ones), ``warm_frames`` (the warm-up call's recording), ``scene``,
``motion`` and ``camera`` (``lib/synth.py``), ``check.frames_per_batch``.
"""

import time

import numpy as np
import torch

from portbench.lib import compare, stats, synth
from portbench.lib.entry import Entry as Base
from portbench.lib.entry import check_sample
from portbench.lib.trace import Slice, span, sync
from portbench.reference import pipeline as ref_pipeline
from portbench.reference import plain


class Entry(Base):
    """The in-memory pipeline over one recording."""

    labels = ("compensate_arr_3D", "BatchMotionCorrector.run")
    item = "volumes"
    corrector = None

    def notes(self):
        """The last hooked call's executor and per-frame displacements."""
        c = self.corrector
        if c is None:
            return ""
        return (f"executor {c.executor.get_info()}; mean_disp "
                f"{[round(v, 3) for v in c.mean_disp]}; max_disp "
                f"{[round(v, 3) for v in c.max_disp]}")

    def setup(self):
        from flowreg3d_tpu_torch.pipeline import OFOptions, compensate_arr_3D
        from flowreg3d_tpu_torch.pipeline.corrector import RegistrationConfig

        self._compensate = compensate_arr_3D
        self._options = OFOptions
        reg = self.registration()
        self._config = None if reg is None else RegistrationConfig(**reg)
        tr = self.traffic
        g = synth.generator(self.seed, self.device)
        base = synth.scene(g, self.shape, tr["scene"])
        cam = tr["camera"]
        n = int(tr["frames"])
        counts = torch.empty((n,) + self.shape + (self.channels,),
                             device=self.device)
        for t in range(n):
            disp = synth.displacement(g, self.shape, tr["motion"])
            counts[t] = synth.noisy(
                g, cam["offset"] + cam["gain"] * synth.moved(base, disp),
                cam["noise"])
        del base
        self.frames = synth.to_u16_on_host(counts)
        del counts
        self.reference = (torch.as_tensor(
            self.frames[:int(tr["reference_frames"])].astype(np.float64))
            .mean(dim=0).numpy())
        torch.cuda.empty_cache()
        self.last = None
        unhook = self._hook_run("warm_run_s")
        try:
            self.call(self.frames[:int(tr["warm_frames"])])
        finally:
            unhook()
        self.last = None

    def call(self, frames):
        """One ``compensate_arr_3D`` call; returns its volumes."""
        self.last = None
        self.last = self._compensate(frames, self.reference,
                                     self._options(**self.flow),
                                     config=self._config, device=self.device)
        return frames.shape[0]

    def window(self, seconds, traced=False):
        """Back-to-back calls until ``seconds`` have passed; the last call's
        overrun counts. Returns (volumes, seconds, per-call seconds)."""
        unhook = self._hook_run("run_s") if traced else None
        try:
            t0 = time.perf_counter()
            done, calls = 0, []
            while time.perf_counter() - t0 < seconds:
                self.attempted += self.frames.shape[0]
                t = time.perf_counter()
                done += self.call(self.frames)
                calls.append(time.perf_counter() - t)
            if traced:
                self.spans.update(call_s=calls, volumes=done)
            return done, time.perf_counter() - t0, calls
        finally:
            if unhook:
                unhook()

    def e2e(self, done, seconds, calls):
        return {"volumes_per_s": stats.rate(done, seconds)}

    def _hook_run(self, key):
        """Time ``BatchMotionCorrector.run`` inside each call into
        ``spans[key]`` (a host-clock span from the benchmark's side); returns
        the function that removes the hook."""
        from flowreg3d_tpu_torch.pipeline.corrector import BatchMotionCorrector

        run = BatchMotionCorrector.run
        spans = self.spans.setdefault(key, [])

        def timed(corrector, *args, **kwargs):
            self.corrector = corrector
            t = time.perf_counter()
            with span("BatchMotionCorrector.run"):
                out = run(corrector, *args, **kwargs)
            spans.append(time.perf_counter() - t)
            return out

        BatchMotionCorrector.run = timed

        def unhook():
            BatchMotionCorrector.run = run
        return unhook

    def traced_slice(self):
        """One whole call under the profiler; returns (Slice, volumes)."""
        sl = Slice(self.device, self.labels)
        unhook = self._hook_run("slice_run_s")
        try:
            def work():
                with span("compensate_arr_3D"):
                    return self.call(self.frames)
            n = sl.run(work)
        finally:
            unhook()
        return sl, n

    def sample(self):
        """The frames the check compares, and the recording's batches."""
        ranges = ref_pipeline.batch_ranges(self.frames.shape[0],
                                           int(self.flow["buffer_size"]))
        return check_sample(self.seed, ranges,
                            int(self.traffic["check"]["frames_per_batch"]))

    def reference_frames(self, flows, mm=plain.fp32_matmul):
        """The reference's (flow, registered) of each sampled frame."""
        fl = self.flow
        return ref_pipeline.check_frames(
            self.frames, self.reference, flows, self.sample(), self.params,
            fl["weight"], fl["sigma"], int(fl["buffer_size"]), self.device,
            mm)

    def check(self, mm=plain.fp32_matmul):
        """The numbers of the last call's output against the reference."""
        registered, flows = self.last
        self.last = None
        ref = self.reference_frames(flows, mm)
        return compare.worst([compare.item_numbers(
            torch.as_tensor(flows[t]).to(self.device),
            torch.as_tensor(registered[t]).to(self.device), flow_r, reg_r)
            for t, (flow_r, reg_r) in ref.items()])


def readings(entry, control, items):
    """One call over the recording; the program's numbers on the frames its
    check samples and, with ``control``, the TF32 reference's against the
    float32 one. ``items`` is not used: the sample is the check's."""
    entry.call(entry.frames)
    entry.release()
    registered, flows = entry.last
    t = time.perf_counter()
    ref = entry.reference_frames(flows)
    sync(entry.device)
    ref_s = time.perf_counter() - t
    out = {"program": compare.worst([compare.item_numbers(
        torch.as_tensor(flows[k]).to(entry.device),
        torch.as_tensor(registered[k]).to(entry.device), *ref[k])
        for k in ref])}
    if control:
        other = entry.reference_frames(flows, plain.tf32_matmul)
        out["control"] = compare.worst([compare.item_numbers(
            *other[k], *ref[k]) for k in ref])
    return out, {"reference_s": ref_s, "sample": entry.sample()}
