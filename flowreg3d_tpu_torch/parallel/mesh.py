"""Devices for frame-level data parallelism, and the copies between them.

Counterpart of ``flowreg3d_tpu/parallel/mesh.py``. JAX builds a 1-D device
mesh and lets ``shard_map`` place the frames; the port keeps one controller
and a plain list of ``torch.device``s, one entry a shard. A list may name a
device more than once, and its entries are still distinct shards: ``[cpu] *
4`` runs four-shard logic in one CPU process, ``[cuda:0, cuda:0]`` runs
every line of the multi-card code on one card. The batch (T) axis is split
into contiguous per-shard chunks (``shard_batch``); the reference volumes
are copied once to each distinct device (``replicate``). Copies between
shards go through ``peer_copy`` (a device-to-device copy over NVLink between
cards, a plain copy on one device), which counts them.
"""

import numpy as np
import torch

from flowreg3d_tpu_torch import _graph
from flowreg3d_tpu_torch._device import resolve_device


def _indexed(dev):
    """A card named without its index ('cuda') as the current card: the
    device tensors made there report."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def batch_devices(devices=None, device=None):
    """The shards' devices: ``devices`` as given (each resolved, a card
    with its index; a device may repeat), else every visible card when
    ``device`` is CUDA (None means 'cuda', which raises without CUDA), else
    ``[device]``."""
    if devices is not None:
        devices = [_indexed(resolve_device(d)) for d in devices]
        if not devices:
            raise ValueError("batch_devices: an empty device list")
        return devices
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def batch_ranges(n_frames, n_shards):
    """Contiguous [start, stop) frame ranges, one a shard: ceil(T / n)
    frames each, the last ones shorter or empty (JAX pads T to a multiple
    of the mesh and drops the padded frames' results)."""
    per = -(-int(n_frames) // int(n_shards))
    return [(min(k * per, n_frames), min((k + 1) * per, n_frames))
            for k in range(n_shards)]


def shard_batch(arr, devices):
    """The (T, ...) array or tensor split along T into contiguous chunks,
    chunk k on ``devices[k]`` (``batch_ranges``; an empty chunk is None).
    A broadcast tensor (one frame for every t, stride 0) is copied one
    frame a device, not one a chunk's frame."""
    out = []
    for (a, b), dev in zip(batch_ranges(arr.shape[0], len(devices)),
                           devices):
        if b <= a:
            out.append(None)
        elif not isinstance(arr, torch.Tensor):
            out.append(torch.from_numpy(np.ascontiguousarray(arr[a:b]))
                       .to(dev))
        elif arr.stride(0) == 0:
            out.append(arr[0].to(dev, non_blocking=True).expand(
                (b - a,) + tuple(arr.shape[1:])))
        else:
            out.append(arr[a:b].to(dev, non_blocking=True))
    return out


def replicate(arr, devices):
    """One copy of the tensor ``arr`` on each distinct device of ``devices``
    (``peer_copy``): a dict device -> tensor, ``arr`` itself on its own
    device (read only)."""
    return {dev: arr if arr.device == dev
            else peer_copy(torch.empty_like(arr, device=dev), arr)
            for dev in dict.fromkeys(devices)}


def peer_copy(dst, src):
    """``dst.copy_(src)`` between two shards, counted in
    ``peer_copy.copies``. Between cards PyTorch makes the copy wait for the
    work already queued on both devices' current streams, and the
    destination's stream wait for the copy. ``dst`` is a preallocated
    buffer: ``.to()`` onto the same device would alias ``src``, which an
    in-place sweep then overwrites."""
    dst.copy_(src, non_blocking=True)
    peer_copy.copies += 1
    return dst


peer_copy.copies = 0
_graph.copy_counters.append(peer_copy)    # a capture takes its copies out


def pad_to_multiple(arr, multiple, axis=0):
    """Edge-pad ``arr`` along ``axis`` to a multiple of ``multiple``;
    returns (padded, original_len)."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, pad)
    return np.pad(arr, pad_width, mode="edge"), n
