"""The direct API: ``get_displacement(fixed, moving_j, **flow)`` and then
``imregister_wrapper(moving_j, u, v, w, fixed, "cubic")`` on device tensors,
ended by ``torch.cuda.synchronize()``, over a pool of moving volumes used in
turn; an item is a pair.

The mix's keys: ``pool``, ``scene`` and ``motion`` (``lib/synth.py``),
``noise``, ``presmooth_sigma`` (the callers' Gaussian before normalising by the
fixed volume's range), ``profile_pairs`` (the traced slice).
"""

import time

import numpy as np
import torch

from portbench.lib import compare, stats, synth
from portbench.lib.entry import Entry as Base
from portbench.lib.trace import Slice, span, sync
from portbench.reference import plain

ULP = 1.0 + 2.0 ** -22


class Entry(Base):
    """The direct API over a pool of pairs on the device."""

    labels = ("get_displacement", "imregister_wrapper")
    item = "pairs"

    def setup(self):
        from flowreg3d_tpu_torch import get_displacement, imregister_wrapper

        self._flow_fn = get_displacement
        self._warp_fn = imregister_wrapper
        tr = self.traffic
        g = synth.generator(self.seed, self.device)
        sub = dict(tr["scene"])
        sub["density"] = sub["density"][:self.channels]
        sub["sigma_zyx"] = sub["sigma_zyx"][:self.channels]
        base = synth.scene(g, self.shape, sub)
        fixed = synth.noisy(g, base, tr["noise"])
        moving = [synth.noisy(g, synth.moved(
            base, synth.displacement(g, self.shape, tr["motion"])),
            tr["noise"]) for _ in range(int(tr["pool"]))]
        del base
        # the callers' preprocessing: a Gaussian, then both volumes
        # normalised by the fixed volume's range
        s = float(tr["presmooth_sigma"])
        fixed = synth.blur(fixed.movedim(-1, 0), (s, s, s)).movedim(0, -1)
        lo, hi = fixed.min(), fixed.max()
        self.fixed = ((fixed - lo) / (hi - lo)).contiguous()
        self.moving = [((synth.blur(m.movedim(-1, 0), (s, s, s))
                         .movedim(0, -1) - lo) / (hi - lo)).contiguous()
                       for m in moving]
        del fixed, moving
        weight = self.flow.get("weight")
        self.kwargs = dict(self.params, const_assumption="gc",
                           weight=None if weight is None
                           else np.asarray(weight, np.float64))
        self.outputs = {}
        torch.cuda.empty_cache()
        for j in range(min(2, len(self.moving))):
            self.pair(j)
        self.outputs = {}

    def pair(self, j):
        """One pair, ended by a synchronize; keeps its outputs."""
        moving = self.moving[j]
        with span("get_displacement"):
            flow = self._flow_fn(self.fixed, moving, device=self.device,
                                 **self.kwargs)
        with span("imregister_wrapper"):
            reg = self._warp_fn(moving, flow[..., 0], flow[..., 1],
                                flow[..., 2], self.fixed, "cubic",
                                device=self.device)
        sync(self.device)
        self.outputs[j] = (flow, reg)

    def window(self, seconds, traced=False):
        """Pairs back to back until ``seconds`` have passed. Returns (pairs,
        seconds, per-pair seconds)."""
        t0 = time.perf_counter()
        lat = []
        i = 0
        while time.perf_counter() - t0 < seconds:
            self.attempted += 1
            t = time.perf_counter()
            self.pair(i % len(self.moving))
            lat.append(time.perf_counter() - t)
            i += 1
        return i, time.perf_counter() - t0, lat

    def e2e(self, done, seconds, lat):
        return {"pairs_per_s": stats.rate(done, seconds),
                "pair_ms_p95": stats.percentile(lat, 95) * 1e3}

    def traced_slice(self):
        sl = Slice(self.device, self.labels)
        n = int(self.traffic["profile_pairs"])

        def work():
            for i in range(n):
                self.pair(i % len(self.moving))
            return n
        return sl, sl.run(work)

    def weight_volume(self):
        weight = self.kwargs["weight"]
        return plain.weight_volume(
            np.full(self.channels, 1.0) if weight is None else weight,
            self.shape, self.channels, self.device)

    def check(self, mm=plain.fp32_matmul):
        """Every pool entry's last output against the reference's."""
        wvol = self.weight_volume()
        zeros = torch.zeros(self.shape + (3,), device=self.device)
        per_item = []
        for j in sorted(self.outputs):
            flow_p, reg_p = self.outputs.pop(j)
            flow_r, reg_r = plain.register(self.fixed, self.moving[j], zeros,
                                           wvol, self.params, mm)
            per_item.append(compare.item_numbers(flow_p, reg_p, flow_r,
                                                 reg_r))
            del flow_p, reg_p, flow_r, reg_r
        return compare.worst(per_item)


def native_tf32(a, b):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def readings(entry, control, items):
    """The first ``items`` pool pairs through the program and their numbers
    against the reference; with ``control`` also the TF32 reference's, and on
    the first two pairs two readings that set no limit: the reference with
    the card's own TF32 matrix products, and on inputs scaled by 1 + 2**-22."""
    js = list(range(min(items, len(entry.moving))))
    for j in js:
        entry.pair(j)
    entry.release()
    wvol = entry.weight_volume()
    zeros = torch.zeros(entry.shape + (3,), device=entry.device)
    out = {k: [] for k in ("program", "control", "native_tf32", "ulp")}
    timings, flow_max, wild = [], [], []
    for j in js:
        fixed, moving = entry.fixed, entry.moving[j]
        t = time.perf_counter()
        ref = plain.register(fixed, moving, zeros, wvol, entry.params)
        sync(entry.device)
        timings.append(time.perf_counter() - t)
        mag = torch.linalg.vector_norm(ref[0], dim=-1)
        flow_max.append(float(mag.max()))
        wild.append(float((mag > 10).double().mean()))
        flow_p, reg_p = entry.outputs.pop(j)
        out["program"].append(compare.item_numbers(flow_p, reg_p, *ref))
        del flow_p, reg_p
        if not control:
            continue
        extra = j < 2      # the readings that set no limit: two pairs a seed
        for key, args in (
                ("control", (fixed, moving, plain.tf32_matmul)),
                ("native_tf32", (fixed, moving, native_tf32)),
                ("ulp", (fixed * ULP, moving * ULP, plain.fp32_matmul))):
            if key != "control" and not extra:
                continue
            f, r = plain.register(args[0], args[1], zeros, wvol,
                                  entry.params, args[2])
            out[key].append(compare.item_numbers(f, r, *ref))
            del f, r
    return ({k: compare.worst(v) for k, v in out.items() if v},
            {"reference_s": timings, "flow_max": flow_max,
             "share_over_10px": wild})
