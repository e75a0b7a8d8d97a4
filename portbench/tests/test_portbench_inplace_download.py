"""The reader of the program's in-place download tally: 100 after an
in-memory ``compensate_arr_3D`` call whose downloads landed in its arrays,
the share where some batches were copied in, None where no frame was
written or the program keeps no tally (before it existed)."""

from types import SimpleNamespace

import numpy as np
import pytest

from flowreg3d_tpu_torch.io import array
from flowreg3d_tpu_torch.pipeline import OFOptions, compensate_arr_3D
from portbench.lib.spec import Spec

METRIC = "inplace_download_pct.arr"


def _read():
    return Spec().reader(METRIC)(SimpleNamespace(slice=None, items=30))


def test_reads_100_after_an_in_memory_call(monkeypatch):
    monkeypatch.setattr(array, "_TOTALS", {"landed": 0, "copied": 0})
    assert _read() is None
    rng = np.random.default_rng(0)
    frames = (rng.uniform(0, 1, (3, 6, 16, 16, 1)) * 1e4).astype(np.uint16)
    compensate_arr_3D(frames, frames[:2].mean(axis=0),
                      OFOptions(alpha=(1.5, 1.5, 1.5), iterations=2,
                                levels=2, min_level=1, buffer_size=2,
                                quality_setting="fast"), device="cpu")
    assert array.write_totals() == {"landed": 6, "copied": 0}
    assert _read() == pytest.approx(100.0)


def test_reads_the_share_landed(monkeypatch):
    monkeypatch.setattr(array, "_TOTALS", {"landed": 30, "copied": 10})
    assert _read() == pytest.approx(75.0)


def test_without_a_tally_reads_none(monkeypatch):
    monkeypatch.delattr(array, "write_totals")
    assert _read() is None
