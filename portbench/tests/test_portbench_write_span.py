"""The reader of the program's ``flowreg3d.write`` span, on synthetic slices:
ms a volume from the named host rows, device rows of the same name left out,
None where the row is absent (a program without the span)."""

from types import SimpleNamespace

import pytest
import torch

from portbench.lib.spec import Spec
from portbench.lib.trace import Slice

METRIC = "write_ms_per_volume.arr"
SPAN = "flowreg3d.write"


def _row(name, device, cpu_us, self_device_us=0.0, count=3):
    return dict(name=name, device=device, count=count,
                self_device_us=self_device_us, cpu_us=cpu_us)


def _ctx(rows, items=30):
    sl = Slice(torch.device("cpu"))
    sl.rows = rows
    return SimpleNamespace(slice=sl, items=items)


def test_reads_ms_a_volume_from_host_rows():
    rows = [_row(SPAN, False, 6000.0),
            _row("flowreg3d.output", False, 9e6),
            _row("BatchMotionCorrector.run", False, 9e6)]
    assert Spec().reader(METRIC)(_ctx(rows)) == pytest.approx(0.2)


def test_device_rows_of_the_name_left_out():
    rows = [_row(SPAN, False, 6000.0),
            _row(SPAN, True, 7e6, self_device_us=7e6)]
    assert Spec().reader(METRIC)(_ctx(rows)) == pytest.approx(0.2)
    assert Spec().reader(METRIC)(_ctx(rows[1:])) is None


@pytest.mark.parametrize("rows", [
    [],
    [_row("compensate_arr_3D", False, 9e6), _row("cudaGraphLaunch", False, 10.0)],
    [_row("flowreg3d.output", False, 9e6), _row("flowreg3d.staging_copy", False, 9e6)],
], ids=["empty", "other_rows", "other_spans"])
def test_absent_span_reads_none(rows):
    assert Spec().reader(METRIC)(_ctx(rows)) is None
