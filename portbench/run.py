"""Run one cell of the benchmark of flowreg3d_tpu_torch once.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix, the entry the
mix drives, limits and per-layer readers are found by name
(``portbench/lib/spec.py``). The run makes its
inputs on the card from the seed, warms up the cell's shapes (all of that is
``setup_s``), drives the cell's entry back to back for ``--seconds``, with
``--trace 1`` then profiles a bounded slice, frees the program's state and
compares what the timed path produced with the plain reference. Its last line
on standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines on standard error. Without CUDA, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded, it prints no
result and exits with 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "flowreg3d_tpu")


class Refused(Exception):
    """The run cannot give a result."""


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


class Context:
    """What a per-layer reader reads: the traced slice (``slice``) and the
    items in it (``items``), the window's host-clock spans (``spans``), the
    cell's configuration and traffic, the level plan and solver parameters."""

    def __init__(self, entry, slice_, items):
        self.slice = slice_
        self.items = items
        self.spans = entry.spans
        self.config = entry.config
        self.traffic = entry.traffic
        self.params = entry.params
        self.plan = entry.plan()


def run_cell(workload, seed, seconds, trace, device, spec=None,
             overrides=None, t0=T0, log=None):
    """One run of ``workload`` on ``device``. ``overrides`` updates the
    configuration and the traffic (dicts merged key by key; the tests' small
    sizes). Returns the result object and the compared rows."""
    import torch

    from portbench.lib import compare
    from portbench.lib.spec import Spec, quantity
    from portbench.lib.trace import sync

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = spec or Spec()
    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    tr = spec.traffic(wl["traffic"])
    limits = json.loads((spec.dir / "limits" / f"{workload}.json").read_text())
    for part, extra in ((cfg, (overrides or {}).get("config")),
                        (tr, (overrides or {}).get("traffic"))):
        part.update(extra or {})
    chips = int(wl["chips"])
    entry = spec.entry(tr["entry"]).Entry(cfg, tr, seed, device)
    entry.setup()
    sync(device)
    setup_s = time.perf_counter() - t0
    cards = range(chips) if device.type == "cuda" else ()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    log(f"setup {setup_s:.3f} s, " + _program_info())
    if entry.notes():
        log(entry.notes())

    n_done, secs, lat = entry.window(seconds, traced=bool(trace))
    found = forbidden_modules()
    if found:
        raise Refused(f"loaded after the window: {', '.join(found)}")
    log(f"window {n_done} {entry.item} in {secs:.3f} s; host peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
    wanted = spec.metrics(workload, trace)
    metrics, dev_info = {}, {}
    if not trace:
        values = dict(entry.e2e(n_done, secs, lat), setup_s=setup_s)
        for m in wanted:
            metrics[m["name"]] = {"value": values[quantity(m["name"])],
                                  "unit": m["unit"]}
    else:
        sl, n_slice = entry.traced_slice()
        ctx = Context(entry, sl, n_slice)
        for m in wanted:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info = {"busy_s": sl.busy_s, "window_s": sl.window_s}
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=0)
    entry.release()
    numbers = entry.check()
    ok, rows = compare.verdict(numbers, limits)
    ok = ok and entry.failed == 0 and n_done > 0
    result = {
        "correct": bool(ok),
        "attempted": entry.attempted,
        "failed": entry.failed,
        "metrics": metrics,
        "device": dict(
            platform="gpu" if device.type == "cuda" else device.type,
            kind=(torch.cuda.get_device_name(0) if device.type == "cuda"
                  else "cpu"),
            count=chips, memory_peak_bytes=int(peak), **dev_info),
    }
    if trace:
        result["breakdown"] = sl.breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def _program_info():
    """The kernel library's build: 0 s where the checkout had it built, the
    nvcc build's seconds (part of ``setup_s``) in its first run."""
    try:
        from flowreg3d_tpu_torch import _ext
    except ImportError:
        return "kernel library build unknown"
    info = _ext.build_info
    return (f"of which the kernel library's build {info['seconds']} s "
            f"({info['path']})")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.lib.spec import Spec

    spec = Spec()
    chips = int(spec.workload(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result, rows = run_cell(args.workload, args.seed, args.seconds,
                                args.trace, torch.device("cuda", 0),
                                spec=spec)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded: {', '.join(found)}", file=sys.stderr)
        return 2
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
