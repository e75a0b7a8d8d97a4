"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root names
the cells, configurations and metrics; a configuration is the JSON file its entry
names, a traffic mix is ``portbench/traffic/<traffic>.json`` (``"base"`` names a
mix whose keys it starts from), the code a mix drives is
``portbench/entries/<entry>.py`` (the mix's ``"entry"``), and a per-layer
metric's reader is ``portbench/metrics/<metric>.py``, or for ``<q>.<tag>``
without a file of its own ``portbench/metrics/<q>.py``. An end-to-end metric
``<q>`` or ``<q>.<tag>`` reports the entry's quantity ``<q>``. Adding a cell,
a configuration, a mix, an entry or a metric adds files and entries; no file of
the harness changes."""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


class Spec:
    def __init__(self, root=ROOT, bench_dir=HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        mix = json.loads((self.dir / "traffic" / f"{name}.json").read_text())
        base = mix.pop("base", None)
        return mix if base is None else dict(self.traffic(base), **mix)

    def metrics(self, workload, trace):
        """The metric entries a run of ``workload`` reports: the end-to-end
        ones with ``trace`` 0, the per-layer ones with 1. A metric without a
        ``workloads`` key is reported in every cell that reports what it
        ``moves`` (or, end to end, in every cell)."""
        e2e = [m for m in self.bench["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", [workload])
                and m["moves"] in names]

    def reader(self, metric):
        """The ``read(ctx)`` function of a per-layer metric's file."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{quantity(metric)}.py"
        return _load(path, "portbench_metric_").read

    def entry(self, name):
        """The module of ``portbench/entries/<name>.py``: its ``Entry`` class
        and its ``readings`` function."""
        return _load(self.dir / "entries" / f"{name}.py", "portbench_entry_")


def quantity(metric):
    """The quantity a metric's name reports: the part before the first dot."""
    return metric.split(".")[0]


def _load(path, prefix):
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
