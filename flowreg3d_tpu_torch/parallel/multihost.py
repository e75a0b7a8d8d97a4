"""Multi-host scaling: one process per host, each on its own frame range.

Counterpart of ``flowreg3d_tpu/parallel/multihost.py``, on
``torch.distributed`` where JAX uses ``jax.distributed``: each process
streams its own contiguous slice of the recording through the standard
pipeline, with the host's cards as its mesh (``parallel/mesh.py``); the
only cross-host state, the w_init running mean, stays per process (each
seeds from its own first batch). Nothing tells a process of a cluster: the
launcher gives the coordinator's address, the number of processes and this
process's rank. A single process, or one that was never initialised, is
process 0 of 1, so the same code runs unchanged.
"""

import torch.distributed as dist

from flowreg3d_tpu_torch.io.multifile import SUBSETFileReader3D


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None):
    """``torch.distributed.init_process_group`` at ``coordinator_address``
    ('host:port' or a URL such as 'tcp://host:port'), with ``nccl`` when
    CUDA is available and ``gloo`` otherwise (or ``backend``). A no-op when
    the process group is already initialised or no address is given."""
    if dist.is_initialized() or coordinator_address is None:
        return
    import torch

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


def process_index_count():
    """(this process's rank, the number of processes): from the process
    group when it is initialised, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_frame_range(n_frames, process_index=None, process_count=None):
    """Contiguous [start, stop) frame range owned by this process."""
    pi, pc = process_index_count()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    per = -(-n_frames // pc)
    start = min(pi * per, n_frames)
    stop = min(start + per, n_frames)
    return start, stop


def local_reader(reader, process_index=None, process_count=None):
    """Wrap a reader so this process streams only its own frame range."""
    reader._ensure_initialized()
    start, stop = local_frame_range(reader.binned_count, process_index,
                                    process_count)
    return SUBSETFileReader3D(reader, list(range(start, stop)))
