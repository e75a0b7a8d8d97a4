"""BENCHMARK.json and the harness's lookup by name: characters, units, the
metrics' cells, the files a cell needs, a dummy cell added as new files, and
what the benchmark's modules import."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench.lib.spec import Spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"]
    assert len(SPEC["command"]) <= 32
    assert all(LINE.match(w) for w in SPEC["command"])


def _names():
    for c in SPEC["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in SPEC["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


def test_units_and_lines():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert LINE.match(m["layer"]), m
    for item in SPEC["configs"] + SPEC["workloads"]:
        assert LINE.match(item["why"]), item
    for c in SPEC["configs"]:
        assert LINE.match(c["source"]), c


def test_keys_of_entries():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_unique_names():
    for part in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[part]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_enough():
    spec = Spec()
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in spec.metrics(w["name"], 0)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.metrics(w["name"], 1), w["name"]


def test_per_layer_cells_report_what_they_move():
    spec = Spec()
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in spec.metrics(cell, 0)}
            assert m["moves"] in e2e, (m["name"], cell)


def test_layer_names_consistent():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_part_found_by_name():
    spec = Spec()
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        spec.traffic(w["traffic"])
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    for m in SPEC["per_layer"]:
        assert callable(spec.reader(m["name"]))


DUMMY_ENTRY = '''"""A sum over a seeded volume, back to back: an entry added as a
file."""

import time

import torch

from portbench.lib import stats
from portbench.lib.entry import Entry as Base
from portbench.lib.trace import Slice


class Entry(Base):
    item = "sums"

    def setup(self):
        g = torch.Generator().manual_seed(self.seed % 2 ** 63)
        self.x = torch.rand(self.shape, generator=g).to(self.device)

    def window(self, seconds, traced=False):
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self.attempted += 1
            self.out = self.x.sum()
            n += 1
        return n, time.perf_counter() - t0, []

    def e2e(self, done, seconds, times):
        return {"sums_per_s": stats.rate(done, seconds)}

    def traced_slice(self):
        sl = Slice(self.device)
        return sl, sl.run(lambda: int(self.x.sum() > -1))

    def release(self):
        pass

    def check(self, mm=None):
        return {"abs_err": abs(float(self.out) - float(self.x.double().sum()))}


def readings(entry, control, items):
    entry.window(0.01)
    return {"program": entry.check()}, {}
'''


def test_dummy_cell_added_as_files_only(tmp_path):
    """A later change adds a configuration, a mix, the entry it drives,
    limits, an end-to-end and a per-layer metric as new files and entries;
    the lookup finds them, a run of the new cell goes through on the CPU, and
    no file changes."""
    from portbench import run as harness

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    spec_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "direct_defaults.json").read_text())
    cfg.update(name="dummy_config", shape=[4, 6, 8])
    (root / "portbench/configs/dummy_config.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/dummy_mix.json").write_text(
        json.dumps({"entry": "dummy_entry", "pool": 2}))
    (root / "portbench/entries/dummy_entry.py").write_text(DUMMY_ENTRY)
    (root / "portbench/limits/dummy.cell.json").write_text(
        json.dumps({"abs_err": 1e-3}))
    (root / "portbench/metrics/dummy_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec_json["configs"].append({
        "name": "dummy_config", "source": "https://example.org/dummy",
        "file": "portbench/configs/dummy_config.json", "reduced": [],
        "why": "a test"})
    spec_json["workloads"].append({
        "name": "dummy.cell", "config": "dummy_config",
        "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    spec_json["end_to_end"].append({
        "name": "sums_per_s.dummy", "unit": "sums/s", "better": "higher",
        "bound": 0.05, "source": "host_clock", "workloads": ["dummy.cell"]})
    spec_json["per_layer"] += [
        {"name": "dummy_metric", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "Kernels",
         "moves": "sums_per_s.dummy", "workloads": ["dummy.cell"]},
        {"name": "idle_pct.dummy", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "Device",
         "moves": "sums_per_s.dummy", "workloads": ["dummy.cell"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))

    spec = Spec(root, root / "portbench")
    assert spec.config("dummy_config")["name"] == "dummy_config"
    assert spec.traffic("dummy_mix")["pool"] == 2
    assert [m["name"] for m in spec.metrics("dummy.cell", 1)] == [
        "dummy_metric", "idle_pct.dummy"]
    assert spec.reader("dummy_metric")(None) == 42.0
    cpu = torch.device("cpu")
    mod = spec.entry("dummy_entry")
    entry = mod.Entry(spec.config("dummy_config"), {}, 5, cpu)
    entry.setup()
    assert mod.readings(entry, False, 1)[0]["program"]["abs_err"] < 1e-3
    result, _ = harness.run_cell("dummy.cell", 2 ** 31 + 7, 0.05, 0, cpu,
                                 spec=spec, log=lambda msg: None)
    assert result["correct"] and set(result["metrics"]) == {
        "sums_per_s.dummy", "setup_s"}, result
    assert result["metrics"]["sums_per_s.dummy"]["unit"] == "sums/s"
    traced, _ = harness.run_cell("dummy.cell", 2 ** 31 + 7, 0.05, 1, cpu,
                                 spec=spec, log=lambda msg: None)
    # the CPU runs no device operation: the idle share reads nothing
    assert traced["correct"] and traced["metrics"] == {
        "dummy_metric": {"value": 42.0, "unit": "%"}}, traced
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_traffic_base_and_shared_readers():
    """A mix that names a ``base`` starts from that mix's keys; a tagged
    metric without a file of its own is read by its quantity's reader."""
    spec = Spec()
    arr = spec.traffic("arr")
    four = spec.traffic("arr_4cards")
    assert {k: v for k, v in four.items() if k != "why"} == {
        k: v for k, v in arr.items() if k != "why"}
    assert spec.reader("idle_pct.arr") is not None
    assert (spec.reader("idle_pct.direct_pair").__module__
            == spec.reader("idle_pct.arr").__module__)


def test_registration_from_config_then_mix():
    """No ``"registration"`` anywhere means the default config (None); the
    mix's keys override the configuration's."""
    from portbench.lib.entry import Entry

    cfg = json.loads((BENCH / "configs" / "ofoptions_defaults.json")
                     .read_text())
    cpu = torch.device("cpu")
    assert Entry(cfg, {}, 1, cpu).registration() is None
    cfg["registration"] = {"parallelization": "batched", "use_kernels": True}
    mix = {"registration": {"use_kernels": False}}
    assert Entry(cfg, mix, 1, cpu).registration() == {
        "parallelization": "batched", "use_kernels": False}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax",
                                      "flowreg3d_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "flowreg3d_tpu_torch" not in set(_imports(path))
