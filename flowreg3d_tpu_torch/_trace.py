"""Named host spans of the port's pipeline, on the profiler's clock.

``span(name)`` opens a host range only while a ``torch.profiler`` is active
(an operator's own, ``RegistrationConfig.profile_dir``'s or a benchmark's),
so the range lies on the same timeline as the kernels and copies it queues;
otherwise it records nothing and costs under a microsecond. The range is of
the profiler's ``cpu_op`` kind (``_RecordFunctionFast``): unlike
``record_function``'s ``user_annotation``, the profiler does not mirror it
onto the card as a device range spanning its kernels, so no reading of
device time counts a span as device work. Where that class is missing, a
span does nothing. A span's parent is the range open around it.

The spans (``key_averages`` sums inclusive time by name, so no name opens
inside itself):

- ``flowreg3d.read``: a batch read from the reader and its channels chosen;
- ``flowreg3d.upload``: the raw batch's host-to-device copy and dtype cast;
- ``flowreg3d.enqueue``: the host queuing a batch's device work;
- ``flowreg3d.staging_pin``: a download buffer allocated (page-locked on a
  card) or grown;
- ``flowreg3d.staging_wait``: the host blocked on the card before a
  download completes;
- ``flowreg3d.staging_copy``: the downloaded buffers copied into fresh
  pageable arrays;
- ``flowreg3d.output``: ``compensate_arr``'s arrays assembled and cast;
- ``flowreg3d.graph_capture``: a CUDA graph captured (``_graph.cached``).
"""

import contextlib

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:
    _RecordFunctionFast = None

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name):
    """A context manager: a host range ``name`` while a profiler is
    active, else nothing."""
    if _RecordFunctionFast is None or not _profiling():
        return _OFF
    return _RecordFunctionFast(name)
