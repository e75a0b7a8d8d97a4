"""The port's program spans and its graph-capture tally, on the CPU.

Held: under ``torch.profiler`` a two-batch ``compensate_arr_3D`` shows each
pipeline span as a host row once a batch (``flowreg3d.read``,
``flowreg3d.upload``, ``flowreg3d.staging_copy``, ``flowreg3d.write``,
``flowreg3d.prefault_wait``; ``flowreg3d.enqueue`` once more a shard;
``flowreg3d.output`` once a call)
with the flows from either source; every span is a ``cpu_op`` in the Chrome
trace, never a ``user_annotation`` (which the profiler mirrors onto the card
as device time); without a profiler no span records and the outputs are
bit-equal to a profiled run's; without ``_RecordFunctionFast`` a span does
nothing; ``_graph.cached`` tallies a capture and its seconds on a miss only,
shows it as a ``flowreg3d.graph_capture`` row, and ``clear`` keeps the tally;
a span costs under 2 µs with no profiler. Under ``cc_initialization`` each
batch opens ``flowreg3d.prealign`` and ``flowreg3d.cc_finalize`` once, each
inside one of the batch's ``flowreg3d.enqueue``; without cc neither opens,
and without a profiler neither records. With the writers' page toucher
on, a batch's ``flowreg3d.prefault_wait`` closes before its
``flowreg3d.staging_copy`` opens. A profiled ``compensate_recording`` over
a TIFF opens ``flowreg3d.reference`` and ``flowreg3d.flush`` once a call,
``flowreg3d.decode`` once a reference frame and, with the reader's and the
writer's threads off, ``flowreg3d.decode`` and ``flowreg3d.encode`` once a
batch; with them on, the threads' decodes and encodes record no range and
``tiff_totals()`` counts them; unprofiled, none records. The card-only
checks are in ``tests/test_torch_cuda.py``.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flowreg3d_tpu_torch import _graph, _trace
from flowreg3d_tpu_torch.io.tiff3d import TIFFFileWriter3D, tiff_totals
from flowreg3d_tpu_torch.pipeline import (OFOptions, RegistrationConfig,
                                          compensate_arr_3D,
                                          compensate_recording)

IN_RUN = ("flowreg3d.read", "flowreg3d.upload", "flowreg3d.enqueue",
          "flowreg3d.staging_copy", "flowreg3d.write",
          "flowreg3d.prefault_wait")
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


CC_SPANS = ("flowreg3d.prealign", "flowreg3d.cc_finalize")


def _run(config=None, **cc):
    """A two-batch call (T=4, buffer 2) on the CPU; ``cc`` the prealignment's
    options."""
    movie = _movie()
    opts = OFOptions(alpha=(1.5, 1.5, 1.5), iterations=4, levels=3,
                     min_level=1, buffer_size=2, quality_setting="fast", **cc)
    return compensate_arr_3D(movie, movie[:2].mean(axis=0), opts,
                             config=config, device="cpu")


def _profiled(config=None, **cc):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(config, **cc)
    return out, prof


def _span_rows(prof):
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("flowreg3d.")}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_profiled_run_shows_each_span(engine):
    _, prof = _profiled(ENGINES[engine])
    rows = _span_rows(prof)
    for name in ("flowreg3d.read", "flowreg3d.upload",
                 "flowreg3d.staging_copy", "flowreg3d.write",
                 "flowreg3d.prefault_wait"):
        assert rows[name] == 2, (name, rows)
    # the batch step queues each shard's outputs apart from the batch (one
    # shard on the CPU, from either flow source)
    assert rows["flowreg3d.enqueue"] == 4
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


def _count_spans(monkeypatch):
    """The names of the spans opened from here on, each range replaced by
    one that only counts."""
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_trace, "_RecordFunctionFast", Counting)
    return opened


def test_unprofiled_run_records_nothing_and_matches(monkeypatch):
    opened = _count_spans(monkeypatch)
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


CC = dict(cc_initialization=True, cc_hw=8, cc_up=4)


def _intervals(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name]


def test_cc_batch_opens_its_spans_inside_enqueue():
    _, prof = _profiled(**CC)
    rows = _span_rows(prof)
    # under cc the flows come from process_batch, one shard: two enqueues,
    # one prealignment and one re-warp a batch
    assert rows["flowreg3d.enqueue"] == 4, rows
    enqueues = _intervals(prof, "flowreg3d.enqueue")
    for name in CC_SPANS:
        assert rows[name] == 2, (name, rows)
        spans = _intervals(prof, name)
        assert all(any(a <= s and t <= b for a, b in enqueues)
                   for s, t in spans), (name, spans, enqueues)
        # no span of a name opens inside another of the same name
        assert all(t1 <= s2 for (_, t1), (s2, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_prefault_wait_opens_before_the_staging_copy(monkeypatch, engine):
    """With the writers' page toucher on (chunks shrunk to the test's
    arrays), each batch claims its landed frames once, in a
    ``flowreg3d.prefault_wait`` that closes before the batch's
    ``flowreg3d.staging_copy`` opens, never inside it."""
    from flowreg3d_tpu_torch.io import array

    monkeypatch.setattr(array, "_CHUNK", 4096)
    _, prof = _profiled(ENGINES[engine])
    waits = _intervals(prof, "flowreg3d.prefault_wait")
    copies = _intervals(prof, "flowreg3d.staging_copy")
    assert len(waits) == len(copies) == 2
    for (s, t), (a, b) in zip(waits, copies):
        assert t <= a
    assert not any(a <= s and t <= b for s, t in waits for a, b in copies)


def test_cc_spans_absent_without_cc():
    _, prof = _profiled()
    assert not set(_span_rows(prof)) & set(CC_SPANS)


def test_cc_spans_record_nothing_unprofiled(monkeypatch):
    opened = _count_spans(monkeypatch)
    _run(**CC)
    assert opened == []
    _profiled(**CC)
    assert set(opened) >= set(CC_SPANS)


FILE_SPANS = ("flowreg3d.reference", "flowreg3d.flush", "flowreg3d.decode",
              "flowreg3d.encode")


def _source(tmp_path):
    """A u16 TIFF of ``_movie()``'s four volumes."""
    src = tmp_path / "rec.tif"
    w = TIFFFileWriter3D(str(src))
    w.write_frames(_movie()[..., None])
    w.close()
    return src


def _recording(src, out, threads):
    """A two-batch ``compensate_recording`` (buffer 2, reference the mean
    of frames 0 and 1) of ``src`` to a TIFF in ``out`` on the CPU;
    ``threads``: the read-ahead reader and the async writer (the default
    config's) or neither."""
    opts = OFOptions(input_file=str(src), output_path=out,
                     output_format="TIFF", reference_frames=[0, 1],
                     alpha=(1.5, 1.5, 1.5), iterations=4, levels=3,
                     min_level=1, buffer_size=2, quality_setting="fast")
    config = RegistrationConfig(prefetch=2 if threads else 0,
                                async_write=threads)
    return compensate_recording(opts, config=config, device="cpu")


@pytest.mark.parametrize("threads", [False, True])
def test_file_run_opens_the_io_spans(tmp_path, threads):
    src = _source(tmp_path)
    before = tiff_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _recording(src, tmp_path / "out", threads)
    rows = _span_rows(prof)
    assert rows["flowreg3d.reference"] == rows["flowreg3d.flush"] == 1
    # the two reference frames are read by index on the calling thread
    if threads:
        assert rows["flowreg3d.decode"] == 2, rows
        assert "flowreg3d.encode" not in rows
    else:
        assert rows["flowreg3d.decode"] == 2 + 2, rows
        assert rows["flowreg3d.encode"] == 2, rows
    after = tiff_totals()
    assert after["decoded_frames"] - before["decoded_frames"] == 2 + 4
    assert after["encoded_frames"] - before["encoded_frames"] == 4
    reference = _intervals(prof, "flowreg3d.reference")[0]
    flush = _intervals(prof, "flowreg3d.flush")[0]
    assert reference[1] <= min(s for s, _ in _intervals(
        prof, "flowreg3d.read")) and flush[0] >= max(
        t for _, t in _intervals(prof, "flowreg3d.write"))
    assert all(reference[0] <= s and t <= reference[1]
               for s, t in _intervals(prof, "flowreg3d.decode")[:2])


def test_file_run_unprofiled_records_nothing(tmp_path, monkeypatch):
    src = _source(tmp_path)
    opened = _count_spans(monkeypatch)
    _recording(src, tmp_path / "plain", threads=False)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        _recording(src, tmp_path / "traced", threads=False)
    assert set(opened) >= set(FILE_SPANS)
