"""A run of each cell on the CPU at a tiny size, past the harness's look for a
card, with the timed path broken underneath: ``correct`` has to come out false
for each fault a cell can have, and true with nothing broken. And the control,
the plain reference in the program's place with its matrix products in TF32, at
the cell's own size on the card (marked ``cuda``; it skips without one)."""

import json
from pathlib import Path

import pytest
import torch

import flowreg3d_tpu_torch.core.pyramid as pyramid_mod
import flowreg3d_tpu_torch.ops.warp as warp_mod
import flowreg3d_tpu_torch.parallel.executors as executors
from portbench import run as harness

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


def _small(workload):
    over = {"config": {"shape": [10, 36, 40]}}
    if ".arr" in workload:
        cfg = json.loads((BENCH / "configs/ofoptions_defaults.json")
                         .read_text())
        over["config"]["flow"] = dict(cfg["flow"], buffer_size=3)
        over["traffic"] = {"frames": 7, "reference_frames": 4,
                           "warm_frames": 3}
    else:
        over["traffic"] = {"pool": 2, "profile_pairs": 1}
    return over


def _run(workload, trace=0):
    result, rows = harness.run_cell(workload, SEED, 0.05, trace, CPU,
                                    overrides=_small(workload),
                                    log=lambda msg: None)
    return result


PAIRS = ("direct.pair", "defaults.pair")
CELLS = PAIRS + ("defaults.arr", "defaults.arr.mesh4")
MESH = "defaults.arr.mesh4"


@pytest.fixture(autouse=True)
def four_shards(request, monkeypatch):
    """The four-card cell's default executor, the mesh over every card,
    stood in by four CPU shards in the CPU runs."""
    if MESH not in request.node.name or request.node.get_closest_marker(
            "cuda"):
        return
    orig = executors.get_executor

    def mesh(name=None, **kwargs):
        if name is None:
            return executors.MeshExecutor3D(devices=[CPU] * 4, **kwargs)
        return orig(name, **kwargs)
    monkeypatch.setattr(executors, "get_executor", mesh)
    import flowreg3d_tpu_torch.pipeline.corrector as corrector
    monkeypatch.setattr(corrector, "get_executor", mesh)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


def _unchanged_state(monkeypatch):
    """Every pyramid returns the flow it was given."""
    def build(*args, **kwargs):
        return lambda fixed, moving, uvw, weight: uvw.clone()
    monkeypatch.setattr(pyramid_mod, "build_pyramid", build)
    monkeypatch.setattr(executors, "build_pyramid", build)


def _altered_answer(monkeypatch):
    """The registered volume altered where the warp produces it: one z-plane
    raised by 5% of the volume's range."""
    for mod in (warp_mod, executors):
        orig = mod.warp

        def altered(*args, _orig=orig, **kwargs):
            out = _orig(*args, **kwargs).clone()
            out[out.shape[0] // 2] += 0.05 * float(out.max() - out.min())
            return out
        monkeypatch.setattr(mod, "warp", altered)


def _half_batch_left_out(monkeypatch):
    """The executor registers the first half of each batch; the rest come
    back as they went in, with a zero flow."""
    orig = executors.BatchedExecutor3D.run_shards

    def half(self, batch, *args, **kwargs):
        shards = orig(self, batch, *args, **kwargs)
        keep = (batch.shape[0] + 1) // 2
        for a, b, regs, flows in shards:
            for t in range(max(a, keep), b):
                regs[t - a] = batch[t].to(regs.device, regs.dtype)
                flows[t - a] = 0
        return shards
    monkeypatch.setattr(executors.BatchedExecutor3D, "run_shards", half)


def _chain_left_out(monkeypatch):
    """Every batch after the first starts from a zero flow instead of the
    mean of the batch before's flows."""
    import flowreg3d_tpu_torch.pipeline.corrector as corrector

    cls = corrector.BatchMotionCorrector
    orig = cls._process_batch_resident

    def unchained(self, batch):
        out = orig(self, batch)
        self.w_init = torch.zeros_like(self.w_init)
        return out
    monkeypatch.setattr(cls, "_process_batch_resident", unchained)


def _exchange_left_out(monkeypatch):
    """The shards after the first never come back from their cards: their
    frames' registered volumes and flows stay zero."""
    orig = executors.BatchedExecutor3D.run_shards

    def first_only(self, *args, **kwargs):
        shards = orig(self, *args, **kwargs)
        for _, _, regs, flows in shards[1:]:
            regs.zero_()
            flows.zero_()
        return shards
    monkeypatch.setattr(executors.BatchedExecutor3D, "run_shards",
                        first_only)


FAULTS = {"unchanged_state": _unchanged_state,
          "altered_answer": _altered_answer,
          "half_batch_left_out": _half_batch_left_out,
          "chain_left_out": _chain_left_out,
          "exchange_left_out": _exchange_left_out}
APPLIES = {"half_batch_left_out": ("defaults.arr", MESH),
           "chain_left_out": ("defaults.arr", MESH),
           "exchange_left_out": (MESH,)}


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in CELLS for f in FAULTS if w in APPLIES.get(f, CELLS)])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    result = _run(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS[:3])
def test_control_fails_a_limit(workload):
    """On the card at the cell's own size: the program within every limit,
    and the TF32 control against the float32 reference past at least one.
    The four-card cell's control is ``defaults.arr``'s: the same inputs and
    the same reference, on one card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's size")
    from portbench.lib.spec import Spec

    spec = Spec()
    wl = spec.workload(workload)
    cfg, tr = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    mod = spec.entry(tr["entry"])
    entry = mod.Entry(cfg, tr, SEED, torch.device("cuda", 0))
    entry.setup()
    readings, _ = mod.readings(entry, True, 2)
    program, control = readings["program"], readings["control"]
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert any(control[k] > lim for k, lim in limits.items()
               if k in control), control
