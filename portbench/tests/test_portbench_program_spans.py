"""The readers of the program's spans and capture tally, on synthetic
slices: ms a volume from named host rows, device rows of the same name left
out, None where the row or the tally is absent."""

from types import SimpleNamespace

import pytest
import torch

from flowreg3d_tpu_torch import _graph
from portbench.lib.spec import Spec
from portbench.lib.trace import Slice

SPANS = {
    "read_ms_per_volume.arr": "flowreg3d.read",
    "upload_ms_per_volume.arr": "flowreg3d.upload",
    "enqueue_ms_per_volume.arr": "flowreg3d.enqueue",
    "staging_pin_ms_per_volume.arr": "flowreg3d.staging_pin",
    "staging_wait_ms_per_volume.arr": "flowreg3d.staging_wait",
    "staging_copy_ms_per_volume.arr": "flowreg3d.staging_copy",
    "output_ms_per_volume.arr": "flowreg3d.output",
}


def _row(name, device, cpu_us, self_device_us=0.0, count=3):
    return dict(name=name, device=device, count=count,
                self_device_us=self_device_us, cpu_us=cpu_us)


def _ctx(rows, items=30):
    sl = Slice(torch.device("cpu"))
    sl.rows = rows
    return SimpleNamespace(slice=sl, items=items)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reads_ms_a_volume_from_host_rows(metric):
    rows = [_row(SPANS[metric], False, 6000.0),
            _row("flowreg3d.other", False, 9e6),
            _row("BatchMotionCorrector.run", False, 9e6)]
    assert Spec().reader(metric)(_ctx(rows)) == pytest.approx(0.2)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_device_rows_of_the_name_left_out(metric):
    rows = [_row(SPANS[metric], False, 6000.0),
            _row(SPANS[metric], True, 7e6, self_device_us=7e6)]
    assert Spec().reader(metric)(_ctx(rows)) == pytest.approx(0.2)
    assert Spec().reader(metric)(_ctx(rows[1:])) is None


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_absent_span_reads_none(metric):
    rows = [_row("compensate_arr_3D", False, 9e6),
            _row("cudaGraphLaunch", False, 10.0)]
    assert Spec().reader(metric)(_ctx(rows)) is None


def test_graph_capture_s_reads_the_tally(monkeypatch):
    read = Spec().reader("graph_capture_s")
    monkeypatch.setattr(_graph, "_CAPTURES", {})
    assert read(_ctx([])) is None
    monkeypatch.setattr(_graph, "_CAPTURES",
                        {"frame": [1, 0.75], "pyramid": [2, 0.5]})
    assert read(_ctx([])) == pytest.approx(1.25)


def test_graph_capture_s_without_a_tally(monkeypatch):
    """A program that keeps no tally (before it existed) reads None."""
    monkeypatch.delattr(_graph, "capture_totals")
    assert Spec().reader("graph_capture_s")(_ctx([])) is None
