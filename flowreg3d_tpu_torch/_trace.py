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
- ``flowreg3d.prefault_wait``: frames a counted ``ArrayWriter3D`` is about
  to take claimed from its page toucher (``io.array.claim_frames``), the
  host waiting for the chunk it is touching; before the copy into them
  (``flowreg3d.staging_copy``, or ``write_frames``' inside
  ``flowreg3d.write``);
- ``flowreg3d.staging_copy``: the downloaded buffers copied into fresh
  pageable arrays;
- ``flowreg3d.write``: a batch's outputs handed to the run's writers (in
  memory, copied and cast into the arrays ``compensate_arr`` returns);
- ``flowreg3d.output``: ``compensate_arr``'s arrays taken from its writers;
- ``flowreg3d.graph_capture``: a CUDA graph captured (``_graph.cached``);
- ``flowreg3d.prealign``: under ``cc_initialization``, every frame of a
  batch prealigned (``BaseExecutor3D._prealign_frames``: one prealignment
  graph replay a frame on a card), inside ``flowreg3d.enqueue``;
- ``flowreg3d.cc_finalize``: under ``cc_initialization``, the rigid flow
  added to the residual flows and the raw frames warped again
  (``BaseExecutor3D._finalize_cc``), inside ``flowreg3d.enqueue``;
- ``flowreg3d.reference``: the run's reference set up
  (``BatchMotionCorrector._setup_reference``: read from the reader where
  given as frame indices, preprocessed and uploaded);
- ``flowreg3d.flush``: the end of a run: the metadata files written and
  the streams closed, where the call waits for the writer's thread to drain
  and a TIFF writer writes its IFDs;
- ``flowreg3d.decode``: a TIFF reader's volumes decoded
  (``TIFFFileReader3D._read_raw_frames``);
- ``flowreg3d.encode``: a TIFF writer's volumes encoded
  (``TIFFFileWriter3D.write_frames``).

A range opens only on the thread that started the profiler: under the
read-ahead reader and the async writer, ``flowreg3d.decode`` and
``flowreg3d.encode`` run on their threads and record nothing there, so
``io.tiff3d.tiff_totals()`` counts their volumes and seconds on any thread.
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
