"""CUDA graphs of the port's compiled programs, and the bounded cache of them.

The port's counterpart of the JAX package's ``jax.jit`` program builders
(``core/pyramid.py:_build_pyramid_fn``, ``parallel/executors.py:_jit_*``): a
program is captured once per configuration and device as a CUDA graph over
static input and output buffers, and replayed.

``CapturedGraph`` is the capture recipe, PyTorch's: one warm eager run of the
body on a side stream first (it builds the kernel library, the cached device
tables and the cuFFT plans, none of which a capture may create), then the
capture on a stream of the graph's own device (``torch.cuda.graph``'s shared
default stream lives on the device current at its first use). The kernel
wrappers count only host launches: the warm run counts, the capture is taken
back out, and a replay counts nothing. ``launches`` holds the kernel launches
of one replay by wrapper name and ``replays`` how often the graph ran, so the
kernels the replays ran are ``launches`` times ``replays``. A capture that
meets a host sync or an upload raises; nothing falls back to the eager body.

The cache keeps at most one graph of a kind (``"frame"``, ``"pyramid"``,
``"prealign"``) a device. A graph holds its private memory pool (at
64x512x512 the pyramid and a frame's warp take 1.55 GiB at ``OFOptions()``
defaults and 7.43 GiB at the direct API's options, PERF.md), so a repeated
configuration replays its graph, another replaces it, and ``clear`` frees
them all.
"""

import time

import torch

from flowreg3d_tpu_torch import _ext


class CapturedGraph:
    """``_body()`` (defined by a subclass over its static buffers, returning
    its outputs) captured as a CUDA graph on ``device``; ``outputs`` are the
    static output tensors that ``replay`` overwrites."""

    def __init__(self, device):
        self.device = device
        self.replays = 0
        t = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(device).wait_stream(side)
        counters = _ext.launch_counters()
        before = {k: fn.launches for k, fn in counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(device)):
            self.outputs = self._body()
        self.launches = {}
        for k, fn in counters.items():
            if fn.launches != before[k]:
                self.launches[k] = fn.launches - before[k]
            fn.launches = before[k]
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t

    def _body(self):
        raise NotImplementedError

    def replay(self):
        """Run the captured program on the current stream."""
        self.graph.replay()
        self.replays += 1


# (kind, device) -> (configuration key, graph)
_CACHE = {}


def cached(kind, key, device, make):
    """The graph of ``kind`` for configuration ``key`` on ``device``; on a
    miss that device's graph of the kind is dropped first, then ``make()``
    captures the new one."""
    entry = _CACHE.get((kind, device))
    if entry is None or entry[0] != key:
        _CACHE.pop((kind, device), None)
        entry = _CACHE[(kind, device)] = (key, make())
    return entry[1]


def graphs(kind):
    """The cached graphs of ``kind`` (at most one a device)."""
    return [g for (k, _), (_, g) in _CACHE.items() if k == kind]


def clear():
    """Drop every cached graph and its memory pool."""
    _CACHE.clear()
