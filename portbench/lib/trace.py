"""The traced slice of a run: ``torch.profiler`` over a bounded piece of work,
reduced to what the per-layer readers read.

- ``rows``: the profiler's ``key_averages`` as dicts (name, device: whether it
  ran on the card, count, self device microseconds, CPU microseconds);
- ``busy_s``: the union of each card's kernel, copy and fill intervals over
  the slice, so that overlapping operations count once, averaged over the
  cards that ran any; ``window_s`` the slice's
  length on the host clock, from before its first call to after the
  synchronize that ends it;
- ``breakdown``: the ten device operations that took most time, and the idle
  time of the first card over the slice (before its first operation, between
  operations and after its last) summed by the innermost harness span (a
  ``record_function`` label) open on the host at the gap's middle; ``slice``
  where none but the slice's own is.
"""

import bisect
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _self_device_us(e):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def _is_device(e):
    dt = getattr(e, "device_type", "")
    return str(dt() if callable(dt) else dt).endswith("CUDA")


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _kineto_events(prof):
    """(name, card index or None on the host, start ns, end ns) of every
    profiled event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_index() if _is_device(e) else None,
                    start, start + e.duration_ns()))
    return out


def sync(device):
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


SLICE = "slice"


class Slice:
    """A traced slice: ``run(work)`` profiles ``work()`` and synchronizes."""

    def __init__(self, device, labels=()):
        self.device = device
        self.labels = tuple(labels) + (SLICE,)
        self.rows = []
        self.busy_s = None
        self.window_s = None
        self.breakdown = None

    def run(self, work):
        sync(self.device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            with record_function(SLICE):
                result = work()
                sync(self.device)
            self.window_s = time.perf_counter() - t0
        self._reduce(prof)
        return result

    def _reduce(self, prof):
        # the harness's own labels also appear as device ranges (user
        # annotations): they are spans, not operations, and are left out
        self.rows = [dict(name=e.key, device=_is_device(e), count=e.count,
                          self_device_us=_self_device_us(e),
                          cpu_us=float(getattr(e, "cpu_time_total", 0.0)))
                     for e in prof.key_averages()
                     if not (_is_device(e) and e.key in self.labels)]
        events = [ev for ev in _kineto_events(prof)
                  if ev[1] is None or ev[0] not in self.labels]
        cards = sorted({dev for _, dev, _, _ in events if dev is not None})
        per_card = [_merge([(a, b) for _, dev, a, b in events
                            if dev == card and b > a]) for card in cards]
        self.busy_s = (sum(sum(b - a for a, b in busy) for busy in per_card)
                       / 1e9 / max(1, len(per_card)))
        busy = per_card[0] if per_card else []
        spans = sorted((a, b, name) for name, dev, a, b in events
                       if dev is None and name in self.labels)
        starts = [s[0] for s in spans]
        outer = [(a, b) for a, b, name in spans if name == SLICE]
        lo, hi = (outer[0] if outer else
                  (busy[0][0], busy[-1][1]) if busy else (0, 0))
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        idle = {}
        for end, nxt in zip(edges[::2], edges[1::2]):
            if nxt <= end:
                continue
            mid = (end + nxt) / 2
            label = SLICE
            for a, b, name in reversed(spans[:bisect.bisect_right(starts,
                                                                  mid)]):
                if b >= mid:
                    label = name
                    break
            idle[label] = idle.get(label, 0.0) + (nxt - end) / 1e9
        ops = sorted(((r["name"], r["self_device_us"] / 1e6)
                      for r in self.rows if r["device"]),
                     key=lambda x: -x[1])[:10]
        self.breakdown = {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(),
                                                    key=lambda x: -x[1])][:10],
        }

    def device_us(self, match):
        """Self device microseconds and launches of the device rows whose
        name ``match(name)`` accepts."""
        rows = [r for r in self.rows if r["device"] and match(r["name"])]
        return (sum(r["self_device_us"] for r in rows),
                sum(r["count"] for r in rows))

    def host_count(self, names):
        """How often the host made the named calls (CUDA runtime rows)."""
        return sum(r["count"] for r in self.rows
                   if not r["device"] and r["name"] in names)


span = record_function
