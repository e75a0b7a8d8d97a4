"""CUDA graphs of the port's compiled programs, and the bounded cache of them.

The port's counterpart of the JAX package's ``jax.jit`` program builders
(``core/pyramid.py:_build_pyramid_fn``, ``parallel/executors.py:_jit_*``,
``parallel/spatial_pyramid.py``'s ``jax.jit(shard_map(...))``): a program is
captured once per configuration and device list as a CUDA graph over static
input and output buffers, and replayed.

``CapturedGraph`` is the capture recipe, PyTorch's: one warm eager run of the
body on side streams first (it builds the kernel library, the cached device
tables and the cuFFT plans, none of which a capture may create), then the
capture on a stream of the graph's own device (``torch.cuda.graph``'s shared
default stream lives on the device current at its first use). The kernel
wrappers count only host launches: the warm run counts, the capture is taken
back out, and a replay counts nothing. ``launches`` holds the kernel launches
of one replay by wrapper name and ``replays`` how often the graph ran, so the
kernels the replays ran are ``launches`` times ``replays``; ``copies`` holds
one replay's copies between shards (the counters in ``copy_counters``, such
as ``parallel/mesh.peer_copy``'s, which, like the wrappers, count host calls
only). A capture that meets a host sync or an upload raises; nothing falls
back to the eager body. ``BodyGraph`` captures a builder's body over static
input buffers, the form every program of one configuration takes.

A body whose shards sit on several cards is one graph across them: each
other card's work runs on a stream of its own, forked from the capture
stream and joined back to it by events (copies between cards wait on both
cards' current streams, so they become edges of the graph), and its
allocations go to a ``torch.cuda.MemPool`` that the graph holds, so that no
block the replays write is handed to eager work. On one card (a device list
such as ``[cuda:0, cuda:0]``) this is the single-device capture.

The cache keeps at most one graph of a kind (``"frame"``, ``"pyramid"``,
``"prealign"``, ``"level"``, ``"flow2d"``; ``"sharded"`` and
``"sharded_level"`` keyed by the device list) a device. A graph holds its
private memory pools (at 64x512x512 the pyramid and a frame's warp take 1.55
GiB at ``OFOptions()`` defaults and 7.43 GiB at the direct API's options,
PERF.md), so a repeated configuration replays its graph, another replaces
it, and ``clear`` frees them all. ``capture_totals`` tallies the captures
and their seconds by kind since the process started; ``clear`` leaves it.
"""

import contextlib
import time

import torch

from flowreg3d_tpu_torch import _ext
from flowreg3d_tpu_torch._trace import span


# Host-call counters besides the kernel wrappers' (``_ext.launch_counters``)
# that a capture takes back out: objects counting in an int ``copies``
# attribute; ``parallel/mesh.py`` registers ``peer_copy`` here.
copy_counters = []


class CapturedGraph:
    """``_body()`` (defined by a subclass over its static buffers, returning
    its outputs) captured as a CUDA graph on ``device``; ``outputs`` are the
    static output tensors that ``replay`` overwrites. ``devices``: every
    device the body touches besides ``device`` (repeats and ``device``
    itself are ignored)."""

    def __init__(self, device, devices=()):
        self.device = device
        self.replays = 0
        others = [d for d in dict.fromkeys(devices) if d != device]
        every = [device] + others
        t = time.perf_counter()
        side = {d: torch.cuda.Stream(d) for d in every}
        for d in every:
            side[d].wait_stream(torch.cuda.current_stream(d))
        with self._on(side, device):
            self._body()
        for d in every:
            torch.cuda.current_stream(d).wait_stream(side[d])
        counters = _ext.launch_counters()
        before = {k: fn.launches for k, fn in counters.items()}
        copies = [c.copies for c in copy_counters]
        self.pools = {}
        for d in others:
            with torch.cuda.device(d):
                self.pools[d] = torch.cuda.MemPool()
        capture = torch.cuda.Stream(device)
        forks = {d: torch.cuda.Stream(d) for d in others}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=capture):
            for d in others:
                forks[d].wait_stream(capture)
            with self._on(forks, device, self.pools):
                self.outputs = self._body()
            for d in others:
                capture.wait_stream(forks[d])
        self.launches = {}
        for k, fn in counters.items():
            if fn.launches != before[k]:
                self.launches[k] = fn.launches - before[k]
            fn.launches = before[k]
        self.copies = 0
        for c, n in zip(copy_counters, copies):
            self.copies += c.copies - n
            c.copies = n
        for d in every:
            torch.cuda.synchronize(d)
        self.capture_s = time.perf_counter() - t

    @staticmethod
    @contextlib.contextmanager
    def _on(streams, device, pools=None):
        """Each device's current stream set to ``streams[d]`` (and its
        allocations routed to ``pools[d]``), ``device`` current."""
        with contextlib.ExitStack() as stack:
            for d, s in streams.items():
                stack.enter_context(torch.cuda.stream(s))
                if pools and d in pools:
                    stack.enter_context(torch.cuda.use_mem_pool(pools[d], d))
            stack.enter_context(torch.cuda.device(device))
            yield

    def _body(self):
        raise NotImplementedError

    def replay(self):
        """Run the captured program on the current stream."""
        self.graph.replay()
        self.replays += 1


class BodyGraph(CapturedGraph):
    """``body(*inputs)`` captured on ``device`` (across ``devices``) over
    static input buffers, zeros of ``specs`` ((shape, dtype) pairs) on
    ``device``; the body returns a tuple of tensors."""

    def __init__(self, body, specs, device, devices=()):
        self.body = body
        self.inputs = [torch.zeros(shape, dtype=dtype, device=device)
                       for shape, dtype in specs]
        super().__init__(device, devices)

    def _body(self):
        return self.body(*self.inputs)

    def run(self, *values):
        """Copy each of ``values`` into its input buffer, replay, and
        return copies of the outputs (the next replay overwrites them)."""
        with torch.cuda.device(self.device):
            for buf, x in zip(self.inputs, values):
                buf.copy_(x)
            self.replay()
            return tuple(x.clone() for x in self.outputs)


# (kind, device) -> (configuration key, graph)
_CACHE = {}
# kind -> [captures, seconds], over the process
_CAPTURES = {}


def cached(kind, key, device, make):
    """The graph of ``kind`` for configuration ``key`` on ``device`` (a
    device, or a tuple of them for a graph across a device list); on a miss
    that device's graph of the kind is dropped first, then ``make()``
    captures the new one."""
    entry = _CACHE.get((kind, device))
    if entry is None or entry[0] != key:
        _CACHE.pop((kind, device), None)
        t = time.perf_counter()
        with span("flowreg3d.graph_capture"):
            graph = make()
        tally = _CAPTURES.setdefault(kind, [0, 0.0])
        tally[0] += 1
        tally[1] += time.perf_counter() - t
        entry = _CACHE[(kind, device)] = (key, graph)
    return entry[1]


def capture_totals():
    """{kind: (captures, seconds)} of every capture ``cached`` made since
    the process started."""
    return {k: (n, s) for k, (n, s) in _CAPTURES.items()}


def graphs(kind):
    """The cached graphs of ``kind`` (at most one a device)."""
    return [g for (k, _), (_, g) in _CACHE.items() if k == kind]


def clear():
    """Drop every cached graph and its memory pools."""
    _CACHE.clear()
