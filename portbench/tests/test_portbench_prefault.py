"""The readers of the program's page toucher: ``prefaulted_pct.arr``, the
share of the in-memory writers' frames faulted whole before their copy (100
after a CPU ``compensate_arr_3D`` call whose toucher ran ahead of every
claim; the share of a tally; None where no frame was written or the program
keeps no such tally), and ``prefault_wait_ms_per_volume.arr``, ms a volume
from the span's host rows, device rows of the same name left out, None
where the span is absent (a program without it)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from flowreg3d_tpu_torch.io import array
from flowreg3d_tpu_torch.pipeline import OFOptions, compensate_arr_3D
from portbench.lib.spec import Spec
from portbench.lib.trace import Slice

SHARE = "prefaulted_pct.arr"
WAIT = "prefault_wait_ms_per_volume.arr"
SPAN = "flowreg3d.prefault_wait"


def _ctx(rows=(), items=30):
    sl = Slice(torch.device("cpu"))
    sl.rows = list(rows)
    return SimpleNamespace(slice=sl, items=items)


def _row(name, device, cpu_us, self_device_us=0.0, count=3):
    return dict(name=name, device=device, count=count,
                self_device_us=self_device_us, cpu_us=cpu_us)


def test_share_reads_100_after_an_in_memory_call(monkeypatch):
    """Chunks shrunk to the call's small arrays, and every claim made after
    the toucher faulted every frame of its writers."""
    monkeypatch.setattr(array, "_TOTALS",
                        {"landed": 0, "copied": 0, "prefaulted": 0})
    assert Spec().reader(SHARE)(_ctx()) is None
    monkeypatch.setattr(array, "_CHUNK", 4096)
    claim = array._Toucher.claim

    def after_the_toucher(self, claims):
        with self.cond:
            assert self.cond.wait_for(lambda: self.thread is None,
                                      timeout=30)
        claim(self, claims)

    monkeypatch.setattr(array._Toucher, "claim", after_the_toucher)
    rng = np.random.default_rng(0)
    frames = (rng.uniform(0, 1, (3, 6, 16, 16, 1)) * 1e4).astype(np.uint16)
    compensate_arr_3D(frames, frames[:2].mean(axis=0),
                      OFOptions(alpha=(1.5, 1.5, 1.5), iterations=2,
                                levels=2, min_level=1, buffer_size=2,
                                quality_setting="fast"), device="cpu")
    assert array.write_totals() == {"landed": 6, "copied": 0,
                                    "prefaulted": 6}
    assert Spec().reader(SHARE)(_ctx()) == pytest.approx(100.0)


@pytest.mark.parametrize("totals,share", [
    ({"landed": 30, "copied": 10, "prefaulted": 36}, 90.0),
    ({"landed": 30, "copied": 10, "prefaulted": 0}, 0.0),
    ({"landed": 0, "copied": 0, "prefaulted": 0}, None),
    ({"landed": 30, "copied": 10}, None),       # a tally before the toucher
], ids=["share", "none_prefaulted", "no_frames", "no_prefault_count"])
def test_share_of_a_tally(monkeypatch, totals, share):
    monkeypatch.setattr(array, "_TOTALS", totals)
    got = Spec().reader(SHARE)(_ctx())
    assert got == (None if share is None else pytest.approx(share))


def test_share_without_a_tally_reads_none(monkeypatch):
    monkeypatch.delattr(array, "write_totals")
    assert Spec().reader(SHARE)(_ctx()) is None


def test_wait_reads_ms_a_volume_from_host_rows():
    rows = [_row(SPAN, False, 6000.0),
            _row(SPAN, True, 7e6, self_device_us=7e6),
            _row("flowreg3d.staging_copy", False, 9e6)]
    assert Spec().reader(WAIT)(_ctx(rows)) == pytest.approx(0.2)


@pytest.mark.parametrize("rows", [
    [],
    [_row(SPAN, True, 7e6, self_device_us=7e6)],
    [_row("flowreg3d.staging_copy", False, 9e6),
     _row("flowreg3d.write", False, 9e6)],
], ids=["empty", "device_rows_only", "other_spans"])
def test_wait_without_the_span_reads_none(rows):
    assert Spec().reader(WAIT)(_ctx(rows)) is None
