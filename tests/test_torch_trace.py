"""The port's program spans and its graph-capture tally, on the CPU.

Held: under ``torch.profiler`` a two-batch ``compensate_arr_3D`` shows each
pipeline span as a host row once a batch (``flowreg3d.enqueue`` once more a
shard on the resident engine, ``flowreg3d.output`` once a call) on both
engines; every span is a ``cpu_op`` in the Chrome trace, never a
``user_annotation`` (which the profiler mirrors onto the card as device
time); without a profiler no span records and the outputs are bit-equal to
a profiled run's; without ``_RecordFunctionFast`` a span does nothing;
``_graph.cached`` tallies a capture and its seconds on a miss only, shows it
as a ``flowreg3d.graph_capture`` row, and ``clear`` keeps the tally; a span
costs under 2 µs with no profiler. The card-only checks are in
``tests/test_torch_cuda.py``.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flowreg3d_tpu_torch import _graph, _trace
from flowreg3d_tpu_torch.pipeline import (OFOptions, RegistrationConfig,
                                          compensate_arr_3D)

IN_RUN = ("flowreg3d.read", "flowreg3d.upload", "flowreg3d.enqueue",
          "flowreg3d.staging_copy")
ENGINES = {
    "resident": None,
    "host_staged": RegistrationConfig(parallelization="sequential",
                                      device_resident=False),
}


def _movie(T=4, shape=(6, 16, 16)):
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (shape[0], shape[1] + 4, shape[2] + 4))
    frames = np.stack([base[:, t % 3:t % 3 + shape[1], 2:2 + shape[2]]
                       for t in range(T)])
    return (frames * 10000).astype(np.uint16)


def _run(config=None):
    """A two-batch call (T=4, buffer 2) on the CPU."""
    movie = _movie()
    opts = OFOptions(alpha=(1.5, 1.5, 1.5), iterations=4, levels=3,
                     min_level=1, buffer_size=2, quality_setting="fast")
    return compensate_arr_3D(movie, movie[:2].mean(axis=0), opts,
                             config=config, device="cpu")


def _profiled(config=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(config)
    return out, prof


def _span_rows(prof):
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("flowreg3d.")}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_profiled_run_shows_each_span(engine):
    _, prof = _profiled(ENGINES[engine])
    rows = _span_rows(prof)
    for name in ("flowreg3d.read", "flowreg3d.upload",
                 "flowreg3d.staging_copy"):
        assert rows[name] == 2, (name, rows)
    # the resident engine queues its outputs apart from the batch (one shard
    # on the CPU); the host-staged path in one range
    assert rows["flowreg3d.enqueue"] == (4 if engine == "resident" else 2)
    assert rows["flowreg3d.output"] == 1
    # the CPU staging allocates its buffers in the first batch and never
    # waits on a card
    assert rows["flowreg3d.staging_pin"] >= 1
    assert "flowreg3d.staging_wait" not in rows


def test_spans_are_host_ops_in_the_chrome_trace(tmp_path):
    _, prof = _profiled()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if str(e.get("name", "")).startswith("flowreg3d.")]
    assert {e["name"] for e in events} >= set(IN_RUN)
    assert {e.get("cat") for e in events} == {"cpu_op"}


def test_unprofiled_run_records_nothing_and_matches(monkeypatch):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_trace, "_RecordFunctionFast", Counting)
    plain = _run()
    assert opened == []
    traced, _ = _profiled()
    assert set(opened) >= set(IN_RUN)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_span_does_nothing_without_record_function_fast(monkeypatch):
    monkeypatch.setattr(_trace, "_RecordFunctionFast", None)
    _, prof = _profiled()
    assert _span_rows(prof) == {}


def test_capture_tally_counts_misses_only():
    kind = "tally_test"
    made = []

    def make():
        time.sleep(0.002)
        made.append(object())
        return made[-1]

    assert kind not in _graph.capture_totals()
    first = _graph.cached(kind, "a", "cpu", make)
    n, s = _graph.capture_totals()[kind]
    assert n == 1 and s >= 0.002
    assert _graph.cached(kind, "a", "cpu", make) is first
    assert _graph.capture_totals()[kind] == (n, s)
    _graph.cached(kind, "b", "cpu", make)
    assert _graph.capture_totals()[kind][0] == 2 and len(made) == 2
    _graph.clear()
    assert _graph.capture_totals()[kind][0] == 2


def test_capture_shows_as_a_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _graph.cached("span_test", "a", "cpu", object)
        _graph.cached("span_test", "a", "cpu", object)
    assert _span_rows(prof) == {"flowreg3d.graph_capture": 1}
    _graph.clear()


def test_span_costs_under_two_microseconds():
    assert not torch.autograd._profiler_enabled()
    n = 20000
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with _trace.span("flowreg3d.read"):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    assert best < 2e-6, best
