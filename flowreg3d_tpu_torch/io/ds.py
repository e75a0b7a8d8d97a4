"""Dataset discovery heuristics and channel-name generation.

Parity target: reference util/io/_ds_io_3d.py — three-pass discovery
(channel-name regex groups with consistent shapes; common generic names;
largest 4D/5D array) and the ``ch*``-style writer naming convention.
Implemented as plain functions (the reference uses mixins).
"""

import re
from collections import defaultdict

import numpy as np

_CHANNEL_RE = re.compile(r"^(.*?)((?:ch|channel|chan))([_.\s]*)(\d+)", re.IGNORECASE)
_COMMON_NAMES = ("mov", "data", "dataset", "volume", "stack")


def find_datasets(datasets_with_info):
    """Pick the data-bearing dataset names from [(name, shape), ...].

    Pass 1: channel-numbered groups (``ch1``/``channel_2``/...) whose members
    share one shape — the largest such group wins, sorted by channel number.
    Pass 2: common generic names. Pass 3: the largest 4D/5D shape.
    """
    shape_by_name = {}
    for name, shape in datasets_with_info:
        shape_by_name.setdefault(name, tuple(shape))

    groups = defaultdict(list)
    for name in shape_by_name:
        m = _CHANNEL_RE.match(name)
        if m:
            groups[m.group(1)].append((int(m.group(4)), name))
    consistent = {
        prefix: members for prefix, members in groups.items()
        if len({shape_by_name[n] for _, n in members}) == 1
    }
    if consistent:
        best = max(consistent.values(), key=len)
        return [name for _, name in sorted(best)]

    for name in shape_by_name:
        if name.lower().lstrip("/") in _COMMON_NAMES:
            return [name]

    by_shape = defaultdict(list)
    for name, shape in shape_by_name.items():
        if len(shape) in (4, 5):
            by_shape[shape].append(name)
    if by_shape:
        best_shape = max(by_shape, key=lambda s: int(np.prod(s)))
        return by_shape[best_shape]
    return []


def sanitize_dataset_names(dataset_names):
    """Strip leading slashes from a name / list of names."""
    if dataset_names is None:
        return None
    if isinstance(dataset_names, str):
        return dataset_names.lstrip("/")
    return [n.lstrip("/") for n in dataset_names]


def dataset_name_for_channel(dataset_names, channel_id, n_channels):
    """Name for 1-based ``channel_id`` under the writer naming convention:
    explicit list, ``ch*``-style wildcard, bare prefix, or default ``chN``."""
    if dataset_names:
        if isinstance(dataset_names, (list, tuple)):
            if len(dataset_names) != n_channels:
                raise ValueError(
                    "Number of dataset names must match the number of channels.")
            return dataset_names[channel_id - 1]
        if "*" in dataset_names:
            return dataset_names.replace("*", str(channel_id))
        if n_channels == 1:
            return dataset_names
        return f"{dataset_names}{channel_id}"
    return f"ch{channel_id}"
