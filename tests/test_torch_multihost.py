"""Port parity: the multi-host helpers (``flowreg3d_tpu_torch.parallel.
multihost``) on JAX's three cases (tests/parallel/test_multihost.py), plus
two processes joined by ``torch.distributed`` over gloo on localhost:
``initialize`` and ``local_frame_range`` from the process group, each
process with its own 60 s timeout.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from flowreg3d_tpu.parallel.multihost import \
    local_frame_range as jax_local_frame_range

from flowreg3d_tpu_torch.io.array import ArrayReader3D
from flowreg3d_tpu_torch.parallel.multihost import (initialize,
                                                    local_frame_range,
                                                    local_reader,
                                                    process_index_count)

REPO = Path(__file__).resolve().parents[1]


def test_local_frame_range_partition():
    ranges = [local_frame_range(10, pi, 4) for pi in range(4)]
    assert ranges == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert ranges == [jax_local_frame_range(10, pi, 4) for pi in range(4)]
    covered = [i for a, b in ranges for i in range(a, b)]
    assert covered == list(range(10))


def test_local_reader_subsets():
    video = np.arange(6 * 2 * 3 * 4).reshape(6, 2, 3, 4, 1).astype(np.float32)
    r = local_reader(ArrayReader3D(video), process_index=1, process_count=3)
    np.testing.assert_array_equal(r[:], video[2:4])


def test_single_process_is_identity():
    initialize()                      # no address: a no-op
    assert process_index_count() == (0, 1)
    video = np.zeros((5, 2, 3, 4, 1), np.float32)
    r = local_reader(ArrayReader3D(video))
    assert r.shape[0] == 5


_WORKER = """
import json, sys
from flowreg3d_tpu_torch.parallel.multihost import (initialize,
    local_frame_range, process_index_count)
from flowreg3d_tpu_torch.runtime import RuntimeContext
initialize(sys.argv[1], 2, int(sys.argv[2]), backend="gloo")
initialize(sys.argv[1], 2, int(sys.argv[2]))     # already initialised
dev = RuntimeContext.init(force=True)["devices"]
print(json.dumps([process_index_count(), local_frame_range(7),
                  [dev["process_index"], dev["n_processes"]]]))
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def test_two_processes_over_gloo():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER,
                               f"127.0.0.1:{port}", str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    assert outs == [[[0, 2], [0, 4], [0, 2]], [[1, 2], [4, 7], [1, 2]]]
