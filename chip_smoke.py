#!/usr/bin/env python3
"""Drive flowreg3d_tpu_torch on one CUDA card and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --profile    # also torch.profiler breakdowns of
                                       # one warm canonical and one warm
                                       # direct-API step and of the
                                       # pipelines, written under
                                       # chiprun_out/
    python3 chip_smoke.py --ab PARENT  # only: time this checkout against
                                       # an unpacked parent commit's

Phases:
  1. build the CUDA kernels of flowreg3d_tpu_torch/csrc (one nvcc call);
  2. each kernel against its plain version on the card, at the shapes of
     the canonical step: the SOR tick block (one cooperative launch of
     sor_iterations_f32) at every canonical level for a full block and a
     remainder, in its streamed mode at the full 514^2 plane, on a ragged
     shape and on both sides of its on-chip mode's budget, timed per level;
     the warp for orders 3 and 1 on a smooth flow, sparse far jumps,
     random coordinates, a ragged shape and flat coordinates, and against
     scipy on a crop; the median also at the full-size direct-path
     shape, a ragged shape and a tied input, and timed at every level of a
     direct-API step; 2b. the flow-driven-diffusivity kernels (psi field,
     psi and constant-weight half-sweeps) at a mid level and at the full
     514^2 plane, the psi field also on a ragged grid in both forms; the
     tick block sor_iterations_psi_f32 (one cooperative launch, in both of
     its modes) at four shapes for 1, 2, 9 and 10 iterations, eagerly and
     replayed in a CUDA graph, and timed at every level of a direct-API
     step against the three-kernel loop it replaced;
  3. the canonical motion-correction step (64x512x512, bench.py's pair and
     flow parameters) through get_displacement + imregister_wrapper, with
     the kernels' launch counts (on the first call, the warm eager run of
     get_displacement's CUDA graph, then one replay), against the same step
     on the plain path; 3b. the direct API, get_displacement(fixed, moving)
     with its own defaults (a_smooth 0.5, min_level 0: 10 levels up to
     64x512x512), the same way, and bit-identical to the plain path;
  4. the convergent regime (alpha=1.5, min_level=0) on a shifted 32x128x128
     pair, kernel path against plain path, on the accuracy gate;
  5. timings: per kernel launch, plain version, library call; the full
     step with get_displacement's graph against the eager pyramid it
     captures, at C = 1 and C = 2: flows bit-equal, warm wall medians in
     turns, the first call's and the capture's seconds, the graph's memory,
     no host launch by a kernel wrapper on a warm call, and the runtime's
     launch and copy calls of one; 5b. the same for the direct-API step;
  6. the in-memory pipeline, compensate_arr_3D over a drifting T=4
     recording with the direct API's flow defaults, at the default config
     (the batched executor replaying one CUDA graph a frame, the
     device-resident engine), kernels against the plain pipeline
     (use_kernels=False, bit-identical), with launch counts, the kernels the
     graph replays counted by the profiler, and the card memory the call
     leaves held; then the host-staged sequential path
     (device_resident=False) on the same recording at the quality bounds,
     both warm volumes/s, and the download of the results through the
     pipeline's staging (pinned, then copied to pageable memory) against
     plain pageable copies; 6b. the same at OFOptions' own defaults
     (a_smooth 1, min_level 5: the SOR tick blocks); 6d. get_displacement's
     graph and the pipeline's frame graph cached together at the direct
     options (a direct call, the pipeline, a direct call at C = 2), with
     the card memory after each;
  7. the executors: T=4 canonical frames at OFOptions() defaults and at
     the direct API's options through BatchedExecutor3D (CUDA graph)
     against SequentialExecutor3D (eager), flows and registered volumes
     compared; capture time, warm ms a frame, host launches a frame (the
     profiler's runtime calls: kernel launches and graph launches) and the
     graph's memory;
  6c. a T=24 u16 recording at OFOptions() defaults (buffer 10: three
     batches) at the default config, kernels only: warm volumes/s (and,
     with --profile, the device's busy share);
  8. the cross-correlation prealignment pipeline (cc_initialization=True,
     T=4, OFOptions() defaults): the batched executor replays one
     prealignment graph and one frame graph a frame; bit-equal to the same
     pipeline with the prealignment eager, at both use_kernels, and one
     frame's replay to the eager prealign; kernels against plain, at the
     pipeline's bounds, with its launches (the order-1 warps of the
     prealignment counted apart); warm volumes/s replayed against eager;
  9. the file pipeline: phase 6c's recording written to a TIFF in a
     temporary directory and read back bit for bit (with and without the
     read-ahead reader), compensate_recording at OFOptions() defaults and
     the default config (prefetch 2, the async writer) with TIFF output,
     equal bit for bit to phase 6c's frames and statistics, its warm
     volumes/s with and without prefetch and the async writer, a T=8 run
     interrupted after its first batch and resumed (equal to the
     uninterrupted run), and the CLI's tiff-reshape --scale against the
     port's resize on the card;
 10. multi-GPU execution, on the cards present (one card: the mesh
     executor over [cuda:0], the Z-sharded paths over [cuda:0, cuda:0], two
     shards of one card; more cards: then both over every card): (a) the
     slab mode of the psi field and both half-sweeps against their plain
     versions (the full-size level in 2 slabs, a ragged level in 3 with a
     padded last slab; the whole-volume call unchanged), timed at the slab
     shape; (b) the sharded level solve, bit-identical to plain and to one
     slab; its CUDA graph, and compute_flow_level's, against the eager
     bodies they capture; (c) get_displacement_sharded on the canonical
     pair at the direct API's defaults and at OFOptions() defaults (the
     constant half-sweep's path) and on the convergent pair, kernels
     against plain, against the single-device step (at the 40 dB gate, or
     where the single-device step on input scaled by one ulp itself moves
     further, within that spread), with launches, exchange copies, warm ms
     and its CUDA graph (one a configuration and device list) against the
     eager sharded body: bit-equal (also at C = 2 at the direct defaults),
     first call, capture, the eager body's peak and the graph's memory a
     card, runtime calls of a warm call, warm steps in turns; (d) the mesh
     pipeline (resident and host-staged) bit-identical to batched, and the
     spatial pipeline (one frame-graph replay a frame) against batched; (f)
     on more than one card, one CUDA graph across two cards on a toy
     program (graph_probe; phase_across_cards runs the probe and (b), (c),
     (d)'s spatial pipeline over every card alone);
 11. synthetic motion and flow backends at 64x512x512, the port's own
     modules: (a) the reference's example harness
     (examples/motion_correct_3d_test.py): fix_seed(1), the low_disp
     ground-truth flow (host numpy), the forward splat on the card (held to
     the CPU splat on a crop at 1e-6), a 10-voxel crop, get_displacement at
     the harness's FLOW_PARAMS with kernels and plain, the cubic warp, EPE
     and the improvement ratio (kernel against plain: bit-identical or
     within 0.5 dB / 2%; the ratio above 1); (b) compensate_arr_3D over T=2
     frames of phase 6's recording with flow_backend='volraft-mock' and
     with a VolRAFTBackend on a scripted Conv3d checkpoint (seeded weights,
     a temporary directory, load_volraft), kernels against plain
     bit-identical, volumes/s, the warp launches; each backend card vs CPU
     on a 16x64x64 crop (1e-5 rigid, 1e-4 conv); (c) warp_volume_backward
     kernel against plain, resize_batch of T=4 to half size against the CPU
     (1e-5), compute_flow on a 512x512 plane at a_smooth 1 and 0.5 (a
     0.4-voxel shift recovered to 0.15 over 80 iterations; its CUDA graph
     against the eager body, bit-equal and timed; float64 against the CPU
     at 1e-9 over 20).
Launch counts: every kernel wrapper counts its launches from the host (a
capture is taken back out); a CUDA-graph replay launches its kernels
without the wrappers, so each graph counts its replays, and the kernels
the replays ran (the graph's launches times its replays) are held, in one
warm run of each pipeline path, against the kernel executions the
profiler saw on the card. Then one JSON line of kernels (``launches``:
host launches; ``replayed_by_path``: the launches graph replays ran), the
card's name and power limit,
and the last line {"ok": true, "device": {...}}. Any failed check raises,
so the script exits non-zero; it also exits non-zero without CUDA or
without the package beside it.
"""

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent

CANONICAL = dict(alpha=(0.25, 0.25, 0.25), update_lag=5, iterations=100,
                 min_level=5, levels=50, eta=0.8, a_smooth=1.0, a_data=0.45,
                 const_assumption="gc")
CONVERGENT = dict(CANONICAL, alpha=(1.5, 1.5, 1.5), iterations=50,
                  min_level=0)
# get_displacement's own defaults: the direct API of the reference
DIRECT_DEFAULTS = dict(alpha=(2.0, 2.0, 2.0), update_lag=10, iterations=20,
                       min_level=0, levels=50, eta=0.8, a_smooth=0.5,
                       a_data=0.45, const_assumption="gc")
SHAPE = (64, 512, 512)
PIPELINE_T = 4
CONV_SHAPE = (32, 128, 128)
CONV_SHIFT = (1, 2, -2)            # (z, y, x) roll; flow [dx,dy,dz] = (-2, 2, 1)
# phase 10: ringed (P, M, N) volumes split into n slabs (the full-size
# level in 2; 23 interior rows in 3, the last slab padded), and the
# canonical level of the sharded level solve
SLAB_CASES = ((66, 514, 514, 2), (25, 172, 172, 3))
LEVEL_SHAPE = (23, 170, 170)

# H100 SXM published peaks (dense): HBM bytes/s and fp32 (non-tensor) ops/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the __global__ functions of csrc/*.cu, by kernel wrapper, as the
# profiler names them
KERNEL_SYMBOLS = {
    "sor_iterations_f32": r"\bsor_iterations_kernel\b",
    "map_coords_f32": r"\bmap_coords_kernel\b",
    "median5_f32": r"\bmedian5_kernel\b",
    "psi_field_f32": r"\bpsi_field_kernel\b",
    "sor_halfsweep_psi_f32": r"\bhalfsweep_kernel<true>",
    "sor_halfsweep_const_f32": r"\bhalfsweep_kernel<false>",
    "sor_iterations_psi_f32": r"\bpsi_tick_(block|phases)_kernel\b",
}

KERNEL_TOL = 2e-5                  # tests/core/test_solver_pallas.py:62,157
SCIPY_TOL = 2e-4                   # tests/ops/test_warp_pallas.py:58


def log(msg):
    line = f"[chip_smoke {time.perf_counter() - T0:8.2f}s] {msg}"
    print(line, flush=True)
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "chip_smoke.log", "a") as f:
        f.write(line + "\n")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, n=20, warm=3):
    """Mean device ms per call of ``fn`` over ``n`` calls, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n=20):
    """Device ms per call of ``fn``: ``n`` calls captured in one CUDA graph
    and replayed, so the host's launch cost is out of the number."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, 5) / n


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def make_pair(shape, n_blobs=4000, seed=0, shift=(1, 5, -4)):
    """bench.py's pair: Gaussian blobs; moving = fixed rolled by ``shift``."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    blobs = np.zeros(shape, np.float32)
    idx = tuple(rng.integers(2, s - 2, n_blobs) for s in shape)
    blobs[idx] = rng.random(n_blobs).astype(np.float32) + 0.5
    fixed = gaussian_filter(blobs, (1.0, 2.0, 2.0)).astype(np.float32)
    fixed /= fixed.max()
    moving = np.roll(fixed, shift, axis=(0, 1, 2))
    return fixed, moving


def psnr(ref, test, data_range=1.0):
    mse = float(np.mean((np.asarray(ref, np.float64)
                         - np.asarray(test, np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(data_range ** 2 / mse)


def mse(a, b):
    return float(np.mean((np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)) ** 2))


def phase_build(card):
    import torch

    from flowreg3d_tpu_torch import _ext

    log(f"phase 1: build; torch {torch.__version__} cuda {torch.version.cuda}"
        f"; card {card}")
    t = time.perf_counter()
    _ext.lib()
    log(f"built {_ext.build_info['path']} in "
        f"{time.perf_counter() - t:.2f} s (nvcc {_ext.build_info['seconds']}"
        " s)")
    build_log = _ext.build_info["log"]
    if build_log:
        out = HERE / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "nvcc_build.log").write_text(build_log)
    kernel = None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  nvcc [{kernel}]: {line.strip()}")


def phase_kernels(card, dev):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.ops import median_kernel as mk

    log("phase 2: kernels against their plain versions on the card")
    rng = np.random.default_rng(1)
    plan, _, _ = level_schedule(SHAPE, CANONICAL["eta"], CANONICAL["levels"],
                                CANONICAL["min_level"])
    size5 = plan[-1][1]

    rows = phase_sor(card, dev)

    rows.append(phase_warp(card, dev, rng))

    # --- 5^3 median at the finest level's increments, batched and single
    B = 3
    x = torch.from_numpy(rng.standard_normal((B,) + size5).astype(
        np.float32)).to(dev)
    xp = mk.mirror_pad2(x)
    got = mk.median5(xp)
    want = mk.median5_plain(xp)
    single = mk.median_filter_5x5x5_single(x[1])
    same = bool(torch.equal(got, want) and torch.equal(single, want[1]))
    log(f"  median5 {(B,) + size5} and B=1: bit-equal to plain: {same}")
    check(same, "median5 is not bit-exact against its plain version")

    def library_median():
        return (xp.unfold(1, 5, 1).unfold(2, 5, 1).unfold(3, 5, 1)
                .reshape(x.shape + (125,)).median(dim=-1).values)

    check(torch.equal(library_median(), want), "library median disagrees")
    xp1 = xp[:1].contiguous()
    bnd, by = bound_ms((xp1.numel() + x[0].numel()) * 4, 250 * x[0].numel())
    median_b1 = dict(
        name="median5_f32", route="cuda", path=None,
        source="flowreg3d_tpu_torch/csrc/median5.cu",
        replaces="flowreg3d_tpu/ops/median_pallas.py:97",
        max_abs_err=float((single - want[1]).abs().max()),
        ms=cuda_ms(lambda: mk.median5(xp1)),
        plain_ms=cuda_ms(lambda: mk.median5_plain(xp1), 10),
        bound_ms=bnd, bound_by=by,
        library_ms=cuda_ms(lambda: xp1.unfold(1, 5, 1).unfold(2, 5, 1)
                           .unfold(3, 5, 1).reshape((1,) + size5 + (125,))
                           .median(dim=-1).values, 10),
        shape=f"xp {tuple(xp1.shape)} (B=1)")
    n = x.numel()
    bnd, by = bound_ms((xp.numel() + n) * 4, 250 * n)
    rows.append(dict(
        name="median5_f32", route="cuda", path="direct",
        source="flowreg3d_tpu_torch/csrc/median5.cu",
        replaces="flowreg3d_tpu/ops/median_pallas.py:110",
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: mk.median5(xp)),
        plain_ms=cuda_ms(lambda: mk.median5_plain(xp), 10),
        bound_ms=bnd, bound_by=by, library_ms=cuda_ms(library_median, 10),
        shape=f"xp {tuple(xp.shape)}"))
    rows.append(median_b1)
    phase_median_shapes(card, dev)
    for r in rows:
        log(f"  {r['name']} [{r['shape']}]: {r['ms']:.4f} ms/launch, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']} ms; card {card}")
    return rows


def sor_inputs(rng, shape, dev):
    """duvw (3,P,M,N) increments and SJ (9,P,M,N) data terms whose 3x3
    blocks are positive definite."""
    import torch

    P, M, N = shape
    duvw = (0.1 * rng.standard_normal((3, P, M, N))).astype(np.float32)
    sj = rng.random((9, P, M, N)).astype(np.float32) * 0.1
    sj[:3] += 0.5
    return torch.from_numpy(duvw).to(dev), torch.from_numpy(sj).to(dev)


def sor_bounds(shape, n_iters):
    """(ms, by) per tick block: SJ 36 B and duvw 12 B read, duvw 12 B
    written per interior cell; 60 flops per cell and iteration. And the
    bound of one half-sweep as earlier slices counted it (9 x 4 B per
    interior cell), for comparison with one launch per half-sweep."""
    cells = (shape[0] - 2) * (shape[1] - 2) * (shape[2] - 2)
    return (bound_ms(60 * cells, 60 * n_iters * cells),
            bound_ms(36 * cells, 30 * cells)[0])


def phase_sor(card, dev):
    """sor_iterations_f32, one cooperative launch per tick block, against
    the loop of plain half-sweeps: at every canonical level for a full
    block and a remainder, in the streamed mode at the full 514^2 plane, on
    a ragged shape and on both sides of the on-chip mode's budget; bit-
    equal, ring untouched; timed per canonical level (device only, CUDA
    graph) and at the rows' shapes."""
    import torch

    from flowreg3d_tpu_torch.core import solver_kernel as sk
    from flowreg3d_tpu_torch.core.pyramid import level_schedule

    rng = np.random.default_rng(1)
    plan, _, _ = level_schedule(SHAPE, CANONICAL["eta"], CANONICAL["levels"],
                                CANONICAL["min_level"])
    _, _, (hz, hy, hx) = plan[-1]
    ax, ay, az = (float(np.float32(0.25) / (np.float32(h) * np.float32(h)))
                  for h in (hx, hy, hz))
    lag = CANONICAL["update_lag"]
    levels = [tuple(n + 2 for n in size) for _, size, _ in plan]
    full = tuple(n + 2 for n in SHAPE)
    # the on-chip mode's edge: the first depth of the finest level's plane
    # whose SJ no longer fits the resident blocks' shared memory
    P = levels[-1][0]
    while sk.sor_plan((P,) + levels[-1][1:])["mode"] == sk.SOR_MODES[1]:
        P += 1
    edge = [(P - 1,) + levels[-1][1:], (P,) + levels[-1][1:]]
    want_mode = {**{s: sk.SOR_MODES[1] for s in levels + [(13, 73, 77),
                                                         edge[0]]},
                 edge[1]: sk.SOR_MODES[2], full: sk.SOR_MODES[2]}
    err = {}
    for shape in levels + [(13, 73, 77)] + edge + [full]:
        duvw, sj = sor_inputs(rng, shape, dev)
        pl = sk.sor_plan(shape)
        for n in (lag, 3):
            a, b = duvw.clone(), duvw.clone()
            sk.sor_iterations(a, sj, ax, ay, az, n)
            sk.sor_iterations_plain(b, sj, ax, ay, az, n)
            e = float((a - b).abs().max())
            ring = bool(torch.equal(a[:, 0], duvw[:, 0])
                        and torch.equal(a[:, :, :, -1], duvw[:, :, :, -1]))
            log(f"  sor_iterations {shape} x{n}: max|kernel-plain| = {e:.3e},"
                f" ring untouched {ring}; {pl}")
            check(e == 0.0 and ring,
                  f"sor_iterations is not bit-equal at {shape} x{n}: {e}")
            err[shape] = max(err.get(shape, 0.0), e)
        check(pl["mode"] == want_mode[shape],
              f"sor_iterations at {shape}: mode {pl['mode']}, expected "
              f"{want_mode[shape]}")
        del duvw, sj, a, b

    per_level = {}
    for shape in levels:
        duvw, sj = sor_inputs(rng, shape, dev)
        per_level[str(shape)] = graph_ms(
            lambda: sk.sor_iterations(duvw, sj, ax, ay, az, lag))
    log(f"  sor_iterations_f32 tick block ({lag} iterations) per canonical "
        f"level (device ms, CUDA graph): {per_level}, summed x "
        f"{CANONICAL['iterations'] // lag} blocks "
        f"{CANONICAL['iterations'] // lag * sum(per_level.values()):.3f} ms;"
        f" card {card}")
    rows = []
    for shape, path, replaces in ((levels[-1], "canonical", 952),
                                  (full, None, 844)):
        duvw, sj = sor_inputs(rng, shape, dev)
        (bnd, by), half_bnd = sor_bounds(shape, lag)
        row = dict(
            name="sor_iterations_f32", route="cuda", path=path,
            source="flowreg3d_tpu_torch/csrc/sor_halfsweep.cu",
            replaces=f"flowreg3d_tpu/core/solver_pallas.py:{replaces}",
            max_abs_err=max(err.values()),
            ms=cuda_ms(lambda: sk.sor_iterations(duvw, sj, ax, ay, az, lag),
                       50 if path else 10),
            graph_ms=graph_ms(
                lambda: sk.sor_iterations(duvw, sj, ax, ay, az, lag),
                20 if path else 5),
            plain_ms=cuda_ms(
                lambda: sk.sor_iterations_plain(duvw, sj, ax, ay, az, lag),
                3, 1),
            bound_ms=bnd, bound_by=by, library_ms=None,
            halfsweep_bound_ms=half_bnd, mode=sk.sor_plan(shape)["mode"],
            shape=f"duvw (3,{shape[0]},{shape[1]},{shape[2]}), one tick "
                  f"block of {lag} iterations")
        if path:
            row["graph_ms_by_level"] = per_level
        log(f"  sor_iterations_f32 at {shape}: {row['ms']:.4f} ms a tick "
            f"block (device only {row['graph_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by}; one "
            f"half-sweep {half_bnd:.4f}), {row['mode']}; card {card}")
        rows.append(row)
        del duvw, sj
    return rows


def smooth_flow_coords(shape, rng):
    """Coordinates of a smooth random flow of 1-4 voxels, clipped to the
    volume: (cz, cy, cx) float32 numpy arrays."""
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 2 * np.pi, n, dtype=np.float32)
                               for n in shape), indexing="ij")
    amp, ph = rng.uniform(2.0, 4.0, 3), rng.uniform(0.0, 2 * np.pi, 3)
    flow = (amp[0] * np.sin(xx + 0.5 * yy + ph[0]),
            amp[1] * np.cos(yy - zz + ph[1]),
            0.5 * amp[2] * np.sin(zz + xx + ph[2]))
    grids = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in shape),
                        indexing="ij")
    return [np.clip(g + f, 0, n - 1).astype(np.float32) for g, f, n in
            zip(grids, (flow[2], flow[1], flow[0]), shape)]


def check_warp(tag, vol_t, coords_t, order):
    """map_coords_f32 bit-equal to its plain version."""
    from flowreg3d_tpu_torch.ops import warp as tw
    from flowreg3d_tpu_torch.ops import warp_kernel as wk

    coeff = (tw.bspline_prefilter(vol_t) if order == 3
             else tw._pad_far_edge(vol_t).contiguous())
    got = wk.map_coords(coeff, *coords_t, order)
    e = float((got - wk.map_coords_plain(coeff, *coords_t, order))
              .abs().max())
    log(f"  map_coords order {order} {tag} {tuple(coords_t[0].shape)}: "
        f"max|kernel-plain| = {e:.3e}")
    check(e == 0.0, f"map_coords order {order} {tag} is not bit-equal: {e}")
    return got, e


def phase_warp(card, dev, rng):
    """map_coords_f32 for orders 3 and 1: a smooth flow at the full-size
    output warp (and against scipy on a crop), a flow with sparse far jumps,
    random coordinates, a ragged shape and coordinates that are not 3-D;
    its times, the library call for order 1 (grid_sample) and the plain
    coordinate build of ops/warp.py."""
    import torch
    import torch.nn.functional as F
    from scipy.ndimage import map_coordinates

    from flowreg3d_tpu_torch.ops import warp as tw
    from flowreg3d_tpu_torch.ops import warp_kernel as wk

    vol, _ = make_pair(SHAPE)
    coords = smooth_flow_coords(SHAPE, rng)
    vol_t = torch.from_numpy(vol).to(dev)
    coords_t = [torch.from_numpy(c).to(dev) for c in coords]
    crop = tuple(slice(n // 2 - c // 2, n // 2 + c // 2)
                 for n, c in zip(SHAPE, (8, 64, 64)))
    err = 0.0
    for order in (3, 1):
        got, e = check_warp("smooth", vol_t, coords_t, order)
        ref = map_coordinates(vol.astype(np.float64),
                              [c[crop] for c in coords], order=order,
                              mode="nearest")
        e_scipy = float(np.abs(got[crop].cpu().numpy() - ref).max())
        log(f"  map_coords order {order}: max|kernel-scipy| on a "
            f"{ref.shape} crop = {e_scipy:.3e}")
        check(e_scipy <= SCIPY_TOL,
              f"map_coords order {order} vs scipy: {e_scipy}")
        err = max(err, e)
    for tag, shape, jumps in (("far jumps", (16, 128, 128), 0.002),
                              ("random", (16, 64, 64), None),
                              ("ragged", (13, 73, 77), 0.0)):
        grids = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in shape),
                            indexing="ij")
        if jumps is None:
            cs = [rng.uniform(0, n - 1, shape) for n in shape]
        else:
            cs = [np.clip(g + 1.5 * np.sin(g / 7.0)
                          + 40.0 * (rng.random(shape) < jumps), 0, n - 1)
                  for g, n in zip(grids, shape)]
        v = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        cs_t = [torch.from_numpy(c.astype(np.float32)).to(dev) for c in cs]
        for order in (3, 1):
            err = max(err, check_warp(tag, v, cs_t, order)[1])
            if tag == "ragged":      # the same coordinates as one flat row
                err = max(err, check_warp("flat", v, [c.reshape(-1)
                                                      for c in cs_t],
                                          order)[1])

    Z, Y, X = SHAPE
    n = Z * Y * X
    out = {}
    for order in (3, 1):
        coeff = (tw.bspline_prefilter(vol_t) if order == 3
                 else tw._pad_far_edge(vol_t).contiguous())
        bnd, by = bound_ms(coeff.numel() * 4 + 4 * n * 4,
                           (210 if order == 3 else 40) * n)
        out[order] = dict(
            ms=cuda_ms(lambda: wk.map_coords(coeff, *coords_t, order)),
            graph_ms=graph_ms(lambda: wk.map_coords(coeff, *coords_t, order),
                              10),
            plain_ms=cuda_ms(lambda: wk.map_coords_plain(coeff, *coords_t,
                                                         order), 3, 1),
            bound_ms=bnd, bound_by=by)
    cz, cy, cx = coords_t
    grid = torch.stack([2 * cx / (X - 1) - 1, 2 * cy / (Y - 1) - 1,
                        2 * cz / (Z - 1) - 1], -1)[None]

    def library():
        return F.grid_sample(vol_t[None, None], grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    coeff1 = tw._pad_far_edge(vol_t).contiguous()
    e_lib = float((library()[0, 0] - wk.map_coords(coeff1, *coords_t, 1))
                  .abs().max())
    out[1]["library_ms"] = cuda_ms(library)
    out[1]["library_max_abs_diff"] = e_lib
    del grid, coeff1
    u, v, w = (torch.from_numpy(f).to(dev) for f in
               (coords[2] - np.arange(X, dtype=np.float32),
                coords[1] - np.arange(Y, dtype=np.float32)[:, None],
                coords[0] - np.arange(Z, dtype=np.float32)[:, None, None]))
    coords_ms = cuda_ms(lambda: tw.sample_coords(u, v, w), 10)
    log(f"  map_coords_f32 at {SHAPE}: order 3 {out[3]}; order 1 {out[1]} "
        f"(library: grid_sample trilinear, border, align_corners; max|diff| "
        f"{e_lib:.3e}); plain coordinate build (ops/warp.py sample_coords) "
        f"{coords_ms:.4f} ms; card {card}")
    coeff = tw.bspline_prefilter(vol_t)
    return dict(
        name="map_coords_f32", route="cuda", path="direct",
        source="flowreg3d_tpu_torch/csrc/map_coords.cu",
        replaces="flowreg3d_tpu/ops/warp_pallas.py:131", max_abs_err=err,
        ms=out[3]["ms"], graph_ms=out[3]["graph_ms"],
        plain_ms=out[3]["plain_ms"], bound_ms=out[3]["bound_ms"],
        bound_by=out[3]["bound_by"], library_ms=None, order1=out[1],
        coords_ms=coords_ms,
        shape=f"order 3, coeff {tuple(coeff.shape)}, out {SHAPE}")


def phase_median_shapes(card, dev):
    """median5_f32 bit-equal to its plain version at the full-size direct-
    path shape, a ragged shape and a tied input; its time at every level
    of one direct-API step."""
    import torch

    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.ops import median_kernel as mk

    gen = torch.Generator(device=dev).manual_seed(5)
    full = (3,) + tuple(n + 4 for n in SHAPE)
    for tag, xp in (
            ("full size", torch.randn(full, generator=gen, device=dev)),
            ("ragged", torch.randn((3, 13, 73, 77), generator=gen,
                                   device=dev)),
            ("tied 0..3", torch.randint(0, 4, (3, 25, 172, 172),
                                        generator=gen, device=dev).float())):
        same = bool(torch.equal(mk.median5(xp), mk.median5_plain(xp)))
        log(f"  median5 {tag} xp {tuple(xp.shape)}: bit-equal to plain: "
            f"{same}")
        check(same, f"median5 is not bit-exact at {tag} {tuple(xp.shape)}")
    xp = torch.randn(full, generator=gen, device=dev)
    full_ms = cuda_ms(lambda: mk.median5(xp), 10)
    log(f"  median5_f32 at xp {full}: {full_ms:.4f} ms/launch; card {card}")
    del xp
    plan, _, _ = level_schedule(SHAPE, DIRECT_DEFAULTS["eta"],
                                DIRECT_DEFAULTS["levels"],
                                DIRECT_DEFAULTS["min_level"])
    per_level = {}
    for _, size, _ in plan:
        if min(size) > 5:
            xp = mk.mirror_pad2(torch.randn((3,) + size, generator=gen,
                                            device=dev))
            per_level[size] = graph_ms(lambda: mk.median5(xp))
    log(f"  median5_f32 per level of a direct-API step (device ms, CUDA "
        f"graph): "
        f"{ {str(k): round(v, 4) for k, v in per_level.items()} }, summed "
        f"{sum(per_level.values()):.3f} ms; card {card}")


def counters():
    from flowreg3d_tpu_torch import _ext

    return _ext.launch_counters()


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def run_step(fixed, moving, params, use_kernels):
    """One motion-correction step: pyramid flow, then cubic output warp."""
    import torch

    import flowreg3d_tpu_torch as ft

    flow = ft.get_displacement(fixed, moving, device=fixed.device,
                               use_kernels=use_kernels, **params)
    reg = ft.imregister_wrapper(moving, flow[..., 0], flow[..., 1],
                                flow[..., 2], fixed, "cubic",
                                device=fixed.device, use_kernels=use_kernels)
    torch.cuda.synchronize()
    return flow, reg


def eager_displacement(fixed, moving, params, use_kernels=True):
    """The flow as get_displacement computed it before it replayed a graph:
    the pyramid of its configuration built and run eagerly, uvw zeros and
    the weight 1/C."""
    import torch

    from flowreg3d_tpu_torch.core import pyramid as tpyr

    f, m = ((x[..., None] if x.dim() == 3 else x) for x in (fixed, moving))
    p = DIRECT_DEFAULTS if not params else params
    key = tpyr.pyramid_config_key(tuple(f.shape[:3]), f.shape[3],
                                  use_kernels=use_kernels, **p)
    uvw = torch.zeros(f.shape[:3] + (3,), device=f.device)
    weight = torch.full(f.shape, 1.0 / f.shape[3], device=f.device)
    return tpyr.build_pyramid(*key, device=f.device)(f, m, uvw, weight)


def eager_step(fixed, moving, params):
    """run_step with the eager pyramid (eager_displacement)."""
    import torch

    import flowreg3d_tpu_torch as ft

    flow = eager_displacement(fixed, moving, params)
    reg = ft.imregister_wrapper(moving, flow[..., 0], flow[..., 1],
                                flow[..., 2], fixed, "cubic",
                                device=fixed.device)
    torch.cuda.synchronize()
    return flow, reg


def runtime_calls(work):
    """The CUDA runtime's launch and copy calls of one run of ``work``,
    by name, as the profiler sees them on the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type != DeviceType.CUDA
            and e.key.startswith(("cuda", "cu"))
            and re.search("Launch|Memcpy|Memset", e.key)}


def sync(devices):
    import torch

    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def graph_against_eager(tag, card, call, eager, kind, devices,
                        finish=None, n=5, calls=True):
    """A compiled program's CUDA graph against the eager body it captures.
    ``call()`` (the entry point, which replays the one cached graph of
    ``kind``) and ``eager()`` each return a tuple of tensors; ``finish(out)``
    is the rest of a timed step (the raw frame's warp), if any. From an
    empty cache: the first call's seconds (warm eager run, capture, replay)
    and the capture's; the card memory the graph holds on each device of
    ``devices`` (reserved beyond the start, the allocator's cache emptied);
    the outputs bit-equal; no kernel wrapper's host launch on a warm call;
    the runtime's launch and copy calls of one warm call both ways (with
    ``calls``: the profiler's cost grows with the eager launches); warm
    wall medians of ``n`` steps in turns. Returns the numbers and the
    kernel launches the graph's replays ran."""
    import torch

    from flowreg3d_tpu_torch.parallel import executors as tex

    devs = list(dict.fromkeys(devices))
    tex.clear_frame_graphs()
    sync(devs)
    torch.cuda.empty_cache()
    base = {d: torch.cuda.memory_reserved(d) for d in devs}
    t = time.perf_counter()
    got = call()
    sync(devs)
    first_s = time.perf_counter() - t
    (graph,) = tex.graphs(kind)
    del got
    torch.cuda.empty_cache()
    held = {str(d): round((torch.cuda.memory_reserved(d) - base[d]) / 2**30,
                          3) for d in devs}
    want, got = eager(), call()
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    del got, want
    reset_counts()
    call()
    host = read_counts()
    calls = ({"graph": runtime_calls(call), "eager": runtime_calls(eager)}
             if calls else {"graph": "not read", "eager": "not read"})
    ms = {"graph": [], "eager": []}
    for _ in range(n):
        for way, fn in (("graph", call), ("eager", eager)):
            sync(devs)
            t = time.perf_counter()
            out = fn()
            if finish is not None:
                finish(out)
            sync(devs)
            ms[way].append(1e3 * (time.perf_counter() - t))
            del out
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"  {tag}: graph against eager bit-equal {same} (max|diff| {diff}); "
        f"first call {first_s:.3f} s (capture {graph.capture_s:.3f} s); the "
        f"graph holds {held} GiB reserved; {graph.launches} kernel launches "
        f"and {graph.copies} copies between shards a replay; warm call's "
        f"host launches {host}; runtime calls of a warm call: graph "
        f"{calls['graph']}, eager {calls['eager']}")
    log(f"  {tag}: graph {med['graph']:.2f} ms, eager {med['eager']:.2f} ms "
        f"median of {n} warm {'steps' if finish else 'calls'} in turns "
        f"(graph {[round(x, 2) for x in ms['graph']]}, eager "
        f"{[round(x, 2) for x in ms['eager']]}); card {card}")
    check(same, f"{tag}: the graph's outputs are {diff} from the eager body's")
    check(not any(host.values()), f"{tag}: a warm call launched {host} from "
          f"the host")
    return dict(graph_ms=med["graph"], eager_ms=med["eager"],
                first_s=first_s, capture_s=graph.capture_s, held_gib=held,
                replayed=replayed(graph))


def two_channels(x):
    """(Z,Y,X) -> (Z,Y,X,2): the volume and its square."""
    import torch

    return torch.stack([x, x * x], dim=-1)


def pyramid_graph(tag, n_replays, expected):
    """The one cached get_displacement graph: ``n_replays`` replays, and
    one replay launches ``expected`` (the step's launches less its output
    warp)."""
    from flowreg3d_tpu_torch.core.pyramid import pyramid_graphs

    graphs = pyramid_graphs()
    check(len(graphs) == 1, f"{tag}: {len(graphs)} get_displacement graphs")
    graph = graphs[0]
    want = {k: v - (k == "map_coords_f32") for k, v in expected.items()}
    want = {k: v for k, v in want.items() if v}
    check(graph.replays == n_replays and graph.launches == want,
          f"{tag}: the graph holds {graph.launches} and ran {graph.replays}"
          f" replays; want {want}, {n_replays}")
    return graph


def phase_canonical(card, dev):
    import torch

    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.core.solver import _blocks

    log(f"phase 3: canonical step {SHAPE} through get_displacement + "
        "imregister_wrapper")
    fixed, moving = make_pair(SHAPE)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev) for a in (fixed, moving))

    plan, _, _ = level_schedule(SHAPE, CANONICAL["eta"], CANONICAL["levels"],
                                CANONICAL["min_level"])
    expected = {
        "sor_iterations_f32": len(plan) * len(_blocks(
            CANONICAL["iterations"], CANONICAL["update_lag"])),
        "map_coords_f32": len(plan) + 1,
        "median5_f32": sum(min(size) > 5 for _, size, _ in plan),
    }
    reset_counts()
    t = time.perf_counter()
    flow_k, reg_k = run_step(fixed_t, moving_t, CANONICAL, True)
    first_s = time.perf_counter() - t
    launches = read_counts()
    log(f"  kernel path (first call, {first_s:.2f} s): launches {launches}, "
        f"expected {expected}; levels "
        f"{[size for _, size, _ in plan]}")
    for k in expected:
        check(launches[k] > 0, f"{k} was not launched on the main path")
        check(launches[k] == expected[k],
              f"{k}: {launches[k]} launches, expected {expected[k]}")
    # the host launches are the capture's warm eager run; the flow came
    # from one replay of get_displacement's graph
    reps = replayed(pyramid_graph("phase 3", 1, expected))

    t = time.perf_counter()
    flow_p, reg_p = run_step(fixed_t, moving_t, CANONICAL, False)
    plain_s = time.perf_counter() - t
    results = {}
    for tag, flow, reg in (("kernel", flow_k, reg_k), ("plain", flow_p, reg_p)):
        check(tuple(flow.shape) == SHAPE + (3,) and tuple(reg.shape) == SHAPE,
              f"{tag}: shapes {tuple(flow.shape)} {tuple(reg.shape)}")
        check(bool(torch.isfinite(flow).all() and torch.isfinite(reg).all()),
              f"{tag}: non-finite output")
        r = reg.cpu().numpy()
        results[tag] = dict(psnr=psnr(fixed, r),
                            improvement=mse(moving, fixed) / mse(r, fixed),
                            mean_flow=[float(flow[..., k].mean())
                                       for k in range(3)])
    epe = float(torch.linalg.vector_norm(flow_k - flow_p, dim=-1).mean())
    log(f"  plain path {plain_s:.2f} s; kernel {results['kernel']}; plain "
        f"{results['plain']}; kernel vs plain: flow EPE {epe:.3e}, max|flow| "
        f"{float((flow_k - flow_p).abs().max()):.3e}, max|registered| "
        f"{float((reg_k - reg_p).abs().max()):.3e}, bit-identical "
        f"{bool(torch.equal(flow_k, flow_p) and torch.equal(reg_k, reg_p))}")
    k, p = results["kernel"], results["plain"]
    check(abs(k["psnr"] - p["psnr"]) <= 0.5,
          f"PSNR kernel {k['psnr']} vs plain {p['psnr']} differ > 0.5 dB")
    check(abs(k["improvement"] - p["improvement"]) <= 0.02 * p["improvement"],
          f"improvement {k['improvement']} vs {p['improvement']} differ > 2%")
    check(k["improvement"] > 1 and p["improvement"] > 1,
          f"no improvement: {k['improvement']}, {p['improvement']}")
    return launches, reps, fixed_t, moving_t, plain_s


def phase_convergent(card, dev):
    import torch

    log(f"phase 4: convergent regime {CONV_SHAPE}, shift {CONV_SHIFT}")
    fixed, moving = make_pair(CONV_SHAPE, n_blobs=3000, seed=2,
                              shift=CONV_SHIFT)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev) for a in (fixed, moving))
    out = {tag: run_step(fixed_t, moving_t, CONVERGENT, uk)
           for tag, uk in (("kernel", True), ("plain", False))}
    b = CONV_SHAPE[0] // 4
    crop = (slice(b, -b),) * 3
    fk, fp = (out[t][0].cpu().numpy() for t in ("kernel", "plain"))
    rk, rp = (out[t][1].cpu().numpy() for t in ("kernel", "plain"))
    check(np.isfinite(fk).all() and np.isfinite(rk).all(), "non-finite")
    epe = float(np.mean(np.linalg.norm(fk[crop] - fp[crop], axis=-1)))
    agree = psnr(rk[crop], rp[crop])
    truth = np.array(CONV_SHIFT[::-1], np.float32)      # [dx, dy, dz]
    epe_gt = float(np.mean(np.linalg.norm(fk[crop] - truth, axis=-1)))
    imp = mse(moving[crop], fixed[crop]) / mse(rk[crop], fixed[crop])
    log(f"  kernel vs plain: flow EPE {epe:.4f} (<= 0.25), corrected volumes "
        f"agree at {agree:.2f} dB (>= 40); kernel EPE to the known shift "
        f"{epe_gt:.4f}, improvement {imp:.2f}x")
    check(epe <= 0.25, f"convergent flow EPE {epe} > 0.25")
    check(agree >= 40.0, f"convergent corrected volumes agree at {agree} dB")


def direct_defaults():
    """get_displacement's own flow defaults (the reference's direct API)."""
    import inspect

    import flowreg3d_tpu_torch as ft

    sig = inspect.signature(ft.get_displacement)
    got = {k: sig.parameters[k].default for k in DIRECT_DEFAULTS}
    check(got == DIRECT_DEFAULTS,
          f"get_displacement defaults {got} != {DIRECT_DEFAULTS}")
    return got


def phase_psi_kernels(card, dev):
    """The flow-driven-diffusivity kernels against their plain versions at a
    mid level and at the full 514^2 plane, and their timings; then the tick
    block sor_iterations_psi_f32 (phase_psi_tick)."""
    import torch

    from flowreg3d_tpu_torch.core import solver_psi_kernel as spk
    from flowreg3d_tpu_torch.core.pyramid import level_schedule

    log("phase 2b: psi kernels against their plain versions on the card")
    d = direct_defaults()
    plan, _, _ = level_schedule(SHAPE, d["eta"], d["levels"], d["min_level"])
    rng = np.random.default_rng(3)
    src = "flowreg3d_tpu_torch/csrc/sor_psi.cu"
    out = {}
    mid = min(5, plan[0][0])              # (21,168,168) at 64x512x512
    for level, n_sweeps in ((mid, 10), (0, 10)):
        _, size, (hz, hy, hx) = next(p for p in plan if p[0] == level)
        P, M, N = (n + 2 for n in size)
        t = np.float32
        ax, ay, az = (float(t(a) / (t(h) * t(h)))
                      for a, h in zip(d["alpha"], (hx, hy, hz)))
        params = spk.psi_params(d["a_smooth"], hx, hy, hz)
        duvw = torch.from_numpy((0.1 * rng.standard_normal((3, P, M, N)))
                                .astype(np.float32)).to(dev)
        base = torch.from_numpy((2.0 * rng.random((3, P, M, N)))
                                .astype(np.float32)).to(dev)
        sj = (0.1 * rng.random((9, P, M, N))).astype(np.float32)
        sj[:3] += 0.5
        sj = torch.from_numpy(sj).to(dev)

        psi_k = spk.psi_field(duvw, base, *params)
        psi_p = spk.psi_field_plain(duvw, base, *params)
        e_psi = float((psi_k - psi_p).abs().max())
        psi75 = spk.psi_params(0.75, hx, hy, hz)           # the powf form
        e_psi75 = float((spk.psi_field(duvw, base, *psi75)
                         - spk.psi_field_plain(duvw, base, *psi75))
                        .abs().max())
        a, b = duvw.clone(), duvw.clone()
        for k in range(n_sweeps):
            spk.halfsweep_psi(a, base, sj, psi_k, ax, ay, az, k % 2)
            spk.halfsweep_psi_plain(b, base, sj, psi_p, ax, ay, az, k % 2)
        e_sweep = float((a - b).abs().max())
        ring_same = bool(torch.equal(a[:, 0], duvw[:, 0])
                         and torch.equal(a[:, :, :, -1], duvw[:, :, :, -1]))
        a, b = duvw.clone(), duvw.clone()
        spk.halfsweep(a, base, sj, ax, ay, az, 1)
        spk.halfsweep_plain(b, base, sj, ax, ay, az, 1)
        e_const = float((a - b).abs().max())
        torch.cuda.synchronize()
        log(f"  ({P},{M},{N}): max|kernel-plain| psi_field {e_psi:.3e} "
            f"(a=0.75: {e_psi75:.3e}), sor_halfsweep_psi x{n_sweeps} "
            f"{e_sweep:.3e}, sor_halfsweep_const {e_const:.3e}; ring "
            f"untouched {ring_same}; bit-equal "
            f"{max(e_psi, e_psi75, e_sweep, e_const) == 0.0}")
        check(max(e_psi, e_psi75) == 0.0,
              f"psi_field is not bit-equal at {(P, M, N)}: {e_psi}, {e_psi75}")
        for name, e in (("sor_halfsweep_psi", e_sweep),
                        ("sor_halfsweep_const", e_const)):
            check(e <= KERNEL_TOL, f"{name} disagrees at {(P, M, N)}: {e}")
        check(ring_same, "sor_halfsweep_psi wrote the ring")

        cells = P * M * N
        timed = {
            "psi_field_f32": (
                lambda: spk.psi_field(duvw, base, *params, out=psi_k),
                lambda: spk.psi_field_plain(duvw, base, *params, out=psi_p),
                7 * 4 * cells, 70 * cells, e_psi),
            "sor_halfsweep_psi_f32": (
                lambda: spk.halfsweep_psi(duvw, base, sj, psi_k, ax, ay, az,
                                          0),
                lambda: spk.halfsweep_psi_plain(duvw, base, sj, psi_k, ax,
                                                ay, az, 0),
                17.5 * 4 * cells, 120 * cells / 2, e_sweep),
            "sor_halfsweep_const_f32": (
                lambda: spk.halfsweep(duvw, base, sj, ax, ay, az, 0),
                lambda: spk.halfsweep_plain(duvw, base, sj, ax, ay, az, 0),
                16.5 * 4 * cells, 100 * cells / 2, e_const),
        }
        for name, (kern, plain, n_bytes, n_ops, e) in timed.items():
            bnd, by = bound_ms(n_bytes, n_ops)
            row = dict(name=name, route="cuda", source=src, max_abs_err=e,
                       ms=cuda_ms(kern, 50), plain_ms=cuda_ms(plain, 5, 1),
                       bound_ms=bnd, bound_by=by, library_ms=None,
                       shape=f"({P},{M},{N})")
            out[(name, level)] = row
            log(f"  {name} at ({P},{M},{N}): {row['ms']:.4f} ms/launch "
                f"(device only, CUDA graph: {graph_ms(kern):.4f}), plain "
                f"{row['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by}); card "
                f"{card}")
        del duvw, base, sj, psi_k, psi_p, a, b

    phase_psi_field_ragged(dev)
    tick = phase_psi_tick(card, dev, plan, d)
    # The whole-volume psi path is one sor_iterations_psi_f32 launch a tick
    # block (rows 6, 7); psi_field_f32 and sor_halfsweep_psi_f32 run on the
    # Z-sharded path only.
    rows = tick + [
        dict(out[("psi_field_f32", 0)], path="spatial",
             replaces="flowreg3d_tpu/core/solver_pallas.py:247"),
        dict(out[("sor_halfsweep_const_f32", 0)], path="spatial_defaults",
             replaces="flowreg3d_tpu/core/solver_pallas.py:33"),
        dict(out[("sor_halfsweep_psi_f32", 0)], path="spatial",
             replaces="flowreg3d_tpu/core/solver_pallas.py:148"),
    ]
    return rows


def phase_psi_field_ragged(dev):
    """psi_field_f32 bit-equal to its plain version on a ragged grid in both
    forms (rsqrt at a = 0.5, powf at a = 0.75)."""
    import torch

    from flowreg3d_tpu_torch.core import solver_psi_kernel as spk

    gen = torch.Generator(device=dev).manual_seed(6)
    duvw = 0.1 * torch.randn((3, 13, 73, 77), generator=gen, device=dev)
    base = 2.0 * torch.rand((3, 13, 73, 77), generator=gen, device=dev)
    for a_smooth in (0.5, 0.75):
        params = spk.psi_params(a_smooth, 1.25, 1.5, 1.75)
        e = float((spk.psi_field(duvw, base, *params)
                   - spk.psi_field_plain(duvw, base, *params)).abs().max())
        log(f"  psi_field ragged (13,73,77) a={a_smooth}: max|kernel-plain| "
            f"= {e:.3e}")
        check(e == 0.0, f"psi_field is not bit-equal on (13,73,77) at "
              f"a={a_smooth}: {e}")


# phase 2b: the tick block's shapes (ringed), counts and its bound's terms
TICK_SHAPES = ((11, 71, 71), (23, 170, 170), (19, 133, 157), (66, 514, 514))
TICK_COUNTS = (1, 2, 9, 10)
TICK_BYTES = 72      # a cell: increments, base, SJ read, increments written
TICK_OPS = 190       # a cell and iteration: ~70 psi, ~120 a half-sweep cell


def tick_bounds(shape, n_iters):
    """(ms, by) of one tick block with each input read once and the output
    written once (the contract's bound), and the ms of TICK_BYTES a cell
    streamed every iteration (the one-pass-an-iteration bound)."""
    cells = shape[0] * shape[1] * shape[2]
    return (bound_ms(TICK_BYTES * cells, TICK_OPS * cells * n_iters),
            n_iters * bound_ms(TICK_BYTES * cells, 0)[0])


def phase_psi_tick(card, dev, plan, d):
    """sor_iterations_psi_f32 against its plain version, the loop
    sor_iterations_psi_plain, max |diff| = 0: at TICK_SHAPES
    for TICK_COUNTS iterations, in the mode its plan takes and in the other
    one, eagerly and replayed in a CUDA graph (an odd and an even count), the
    ring untouched; then a tick block of update_lag iterations at every
    level of a direct-API step, device only: the plan's mode, the other
    mode and the three-kernel loop it replaced (psi_field_f32 + 2 x
    sor_halfsweep_psi_f32 an iteration), in one call. Returns rows 6, 7."""
    import torch

    from flowreg3d_tpu_torch.core import solver_psi_kernel as spk

    gen = torch.Generator(device=dev).manual_seed(13)
    lag = d["update_lag"]
    modes = list(spk.PSI_MODES.values())

    def fields(shape):
        duvw = 0.1 * torch.randn((3,) + shape, generator=gen, device=dev)
        base = 2.0 * torch.rand((3,) + shape, generator=gen, device=dev)
        sj = 0.1 * torch.rand((9,) + shape, generator=gen, device=dev)
        sj[:3] += 0.5
        return duvw, base, sj

    def tick_params(a_smooth, h):
        t = np.float32
        return spk.psi_params(a_smooth, *h) + tuple(
            float(t(a) / (t(x) * t(x))) for a, x in zip(d["alpha"], h))

    err = 0.0
    for shape in TICK_SHAPES:
        duvw, base, sj = fields(shape)
        scratch = torch.empty_like(duvw)
        chosen = spk.psi_tick_plan(shape)
        params = {a: tick_params(a, (1.0, 1.25, 1.5)) for a in (0.5, 0.75)}
        errs = {}
        for n in TICK_COUNTS:
            for a_smooth in (0.5, 0.75) if n < 3 else (0.5,):
                want = spk.sor_iterations_psi_plain(
                    duvw.clone(), base, sj, params[a_smooth], n)
                for mode in modes:
                    got = spk.sor_iterations_psi(
                        duvw.clone(), base, sj, params[a_smooth], n, scratch,
                        mode)
                    ring = bool(torch.equal(got[:, 0], duvw[:, 0]) and
                                torch.equal(got[:, :, :, -1],
                                            duvw[:, :, :, -1]))
                    e = float((got - want).abs().max())
                    errs[(n, a_smooth, mode)] = e
                    check(ring, f"sor_iterations_psi wrote the ring at "
                          f"{shape} x{n} ({mode})")
        graphed = {}
        for n in (9, 10):
            a = duvw.clone()
            spk.sor_iterations_psi(a, base, sj, params[0.5], n, scratch)
            a.copy_(duvw)
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                spk.sor_iterations_psi(a, base, sj, params[0.5], n, scratch)
            for _ in range(2):
                a.copy_(duvw)
                g.replay()
            want = spk.sor_iterations_psi_plain(duvw.clone(), base, sj,
                                                params[0.5], n)
            torch.cuda.synchronize()
            graphed[n] = float((a - want).abs().max())
            del g
        worst = max(max(errs.values()), max(graphed.values()))
        err = max(err, worst)
        log(f"  sor_iterations_psi {shape} x{list(TICK_COUNTS)} (a=0.75 at "
            f"1, 2), both modes: max|kernel-plain| {worst:.3e} (eager "
            f"{max(errs.values()):.3e}, CUDA graph x9/x10 {graphed}); plan "
            f"{chosen}")
        check(worst == 0.0, f"sor_iterations_psi is not bit-equal at "
              f"{shape}: {errs}, graph {graphed}")
        del duvw, base, sj, scratch

    # a tick block at every level of one direct-API step, device only
    per_level, three_total, total = {}, 0.0, 0.0
    for _, size, (hz, hy, hx) in plan:
        shape = tuple(n + 2 for n in size)
        duvw, base, sj = fields(shape)
        scratch = torch.empty_like(duvw)
        psi = torch.empty_like(duvw[0])
        params = tick_params(d["a_smooth"], (hx, hy, hz))
        chosen = spk.psi_tick_plan(shape)["mode"]

        def three():
            for _ in range(lag):
                spk.psi_field(duvw, base, *params[:5], out=psi)
                spk.halfsweep_psi(duvw, base, sj, psi, *params[5:], 0)
                spk.halfsweep_psi(duvw, base, sj, psi, *params[5:], 1)

        fns = {"three kernels": three}
        for mode in [chosen] + [m for m in modes if m != chosen]:
            fns[mode] = (lambda m=mode: spk.sor_iterations_psi(
                duvw, base, sj, params, lag, scratch, m))
        n = 3 if shape[0] > 40 else 10
        t = {k: graph_ms(f, n) for k, f in fns.items()}
        t_back = {k: graph_ms(fns[k], n) for k in reversed(fns)}
        ms = {k: round(min(t[k], t_back[k]), 4) for k in fns}
        per_level[str(shape)] = dict(ms, mode=chosen,
                                     bound_per_iteration=round(
                                         tick_bounds(shape, lag)[1], 4))
        total += ms[chosen]
        three_total += ms["three kernels"]
        del duvw, base, sj, scratch, psi
    blocks = d["iterations"] // lag
    log(f"  sor_iterations_psi_f32 tick block of {lag} per level of a "
        f"direct-API step (device ms, CUDA graph, min of two turns; the "
        f"plan's mode, the other mode, the three-kernel loop it replaced): "
        f"{per_level}; x{blocks} blocks a level: {blocks * total:.3f} ms "
        f"against {blocks * three_total:.3f} ms; card {card}")

    rows = []
    for shape, replaces in ((TICK_SHAPES[1], 247), (TICK_SHAPES[3], 435)):
        duvw, base, sj = fields(shape)
        scratch = torch.empty_like(duvw)
        psi = torch.empty_like(duvw[0])
        params = tick_params(d["a_smooth"], (1.0, 1.25, 1.5))
        (bnd, by), per_iter = tick_bounds(shape, lag)
        big = shape[0] > 40

        def kern():
            spk.sor_iterations_psi(duvw, base, sj, params, lag, scratch)

        def three():
            for _ in range(lag):
                spk.psi_field(duvw, base, *params[:5], out=psi)
                spk.halfsweep_psi(duvw, base, sj, psi, *params[5:], 0)
                spk.halfsweep_psi(duvw, base, sj, psi, *params[5:], 1)

        row = dict(
            name="sor_iterations_psi_f32", route="cuda", path="direct",
            source="flowreg3d_tpu_torch/csrc/sor_psi_iterations.cu",
            replaces=f"flowreg3d_tpu/core/solver_pallas.py:{replaces}",
            max_abs_err=err, ms=cuda_ms(kern, 5 if big else 50),
            graph_ms=graph_ms(kern, 3 if big else 20),
            three_kernel_graph_ms=graph_ms(three, 3 if big else 20),
            plain_ms=cuda_ms(lambda: spk.sor_iterations_psi_plain(
                duvw, base, sj, params, lag, psi), 2, 1),
            bound_ms=bnd, bound_by=by, library_ms=None,
            bound_per_iteration_ms=per_iter,
            mode=spk.psi_tick_plan(shape)["mode"],
            shape=f"duvw (3,{shape[0]},{shape[1]},{shape[2]}), a tick block "
                  f"of {lag} iterations")
        log(f"  sor_iterations_psi_f32 at {shape}: {row['ms']:.4f} ms a tick"
            f" block of {lag} (device only {row['graph_ms']:.4f}; the three-"
            f"kernel loop {row['three_kernel_graph_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by}, inputs "
            f"read once), {per_iter:.4f} ms at {TICK_BYTES} B a cell an "
            f"iteration; {row['mode']}; card {card}")
        rows.append(row)
        del duvw, base, sj, scratch, psi
    return rows


def step_bounds(plan, d):
    """ms: each kernel's bound summed over one direct-API step's launches at
    every level's shape; the psi tick block's also at TICK_BYTES a cell an
    iteration."""
    from flowreg3d_tpu_torch.core.solver import _blocks

    tick = per_iter = med = 0.0
    for _, (z, y, x), _ in plan:
        shape = (z + 2, y + 2, x + 2)
        for n in _blocks(d["iterations"], d["update_lag"]):
            (b, _), p = tick_bounds(shape, n)
            tick += b
            per_iter += p
        n = 3 * z * y * x
        med += bound_ms((3 * (z + 4) * (y + 4) * (x + 4) + n) * 4, 250 * n)[0]
    return {"sor_iterations_psi_f32": round(tick, 4),
            "sor_iterations_psi_f32 per iteration": round(per_iter, 4),
            "median5_f32": round(med, 4)}


def phase_direct(card, dev):
    """The direct API with its own defaults (a_smooth 0.5, min_level 0) on
    bench.py's pair, kernels against the plain path."""
    import torch

    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.core.solver import _blocks

    d = direct_defaults()
    plan, _, _ = level_schedule(SHAPE, d["eta"], d["levels"], d["min_level"])
    log(f"phase 3b: direct API get_displacement(fixed, moving) with its "
        f"defaults {d} on {SHAPE}, {len(plan)} levels "
        f"{[size for _, size, _ in plan]}")
    fixed, moving = make_pair(SHAPE)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev) for a in (fixed, moving))
    expected = {
        "sor_iterations_psi_f32": len(plan) * len(_blocks(d["iterations"],
                                                          d["update_lag"])),
        "psi_field_f32": 0,
        "sor_halfsweep_psi_f32": 0,
        "map_coords_f32": len(plan) + 1,
        "median5_f32": sum(min(size) > 5 for _, size, _ in plan),
        "sor_iterations_f32": 0,
        "sor_halfsweep_const_f32": 0,
    }
    log(f"  bounds summed over one step's launches: {step_bounds(plan, d)}")
    reset_counts()
    t = time.perf_counter()
    flow_k, reg_k = run_step(fixed_t, moving_t, {}, True)
    first_s = time.perf_counter() - t
    launches = read_counts()
    log(f"  kernel path (first call, {first_s:.2f} s): launches {launches}, "
        f"expected {expected}")
    check(launches == expected, f"direct-API launches {launches} != "
          f"{expected}")
    reps = replayed(pyramid_graph("phase 3b", 1, expected))
    t = time.perf_counter()
    flow_p, reg_p = run_step(fixed_t, moving_t, {}, False)
    plain_s = time.perf_counter() - t

    results = {}
    for tag, flow, reg in (("kernel", flow_k, reg_k), ("plain", flow_p, reg_p)):
        check(tuple(flow.shape) == SHAPE + (3,) and tuple(reg.shape) == SHAPE,
              f"{tag}: shapes {tuple(flow.shape)} {tuple(reg.shape)}")
        check(bool(torch.isfinite(flow).all() and torch.isfinite(reg).all()),
              f"{tag}: non-finite output")
        r = reg.cpu().numpy()
        results[tag] = dict(psnr=psnr(fixed, r),
                            improvement=mse(moving, fixed) / mse(r, fixed),
                            mean_flow=[float(flow[..., k].mean())
                                       for k in range(3)])
    b = SHAPE[0] // 4
    crop = (slice(b, -b),) * 3
    epe = float(torch.linalg.vector_norm(flow_k[crop] - flow_p[crop],
                                         dim=-1).mean())
    log(f"  plain path {plain_s:.2f} s; kernel {results['kernel']}; plain "
        f"{results['plain']}; kernel vs plain: flow EPE {epe:.3e} (<= 0.25), "
        f"max|flow| {float((flow_k - flow_p).abs().max()):.3e}, "
        f"max|registered| {float((reg_k - reg_p).abs().max()):.3e}, "
        f"bit-identical "
        f"{bool(torch.equal(flow_k, flow_p) and torch.equal(reg_k, reg_p))}")
    k, p = results["kernel"], results["plain"]
    check(abs(k["psnr"] - p["psnr"]) <= 0.5,
          f"PSNR kernel {k['psnr']} vs plain {p['psnr']} differ > 0.5 dB")
    check(abs(k["improvement"] - p["improvement"]) <= 0.02 * p["improvement"],
          f"improvement {k['improvement']} vs {p['improvement']} differ > 2%")
    check(k["improvement"] > 1 and p["improvement"] > 1,
          f"no improvement: {k['improvement']}, {p['improvement']}")
    check(epe <= 0.25, f"direct-API flow EPE {epe} > 0.25")
    check(bool(torch.equal(flow_k, flow_p) and torch.equal(reg_k, reg_p)),
          "direct-API step: kernel and plain paths are not bit-identical")
    return launches, reps, fixed_t, moving_t, plain_s


def recording(fixed, n_frames, seed=4, period=None):
    """T frames of the fixed volume under an integer drift (frame t rolled
    by ((s+1) % 2, 2(s+1), -(s+1)) with s = t, or t % period: a jitter that
    repeats, so every frame moved) plus Gaussian noise of sigma 0.01;
    (T, Z, Y, X) float32."""
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n_frames):
        s = t if period is None else t % period
        frames.append(np.roll(fixed, ((s + 1) % 2, 2 * (s + 1), -(s + 1)),
                              axis=(0, 1, 2))
                      + rng.normal(0.0, 0.01, fixed.shape).astype(np.float32))
    return np.stack(frames).astype(np.float32)


def pipeline_options(defaults):
    """OFOptions' own defaults (a_smooth 1, min_level 5: the canonical flow
    options), or the direct API's flow options with all else default."""
    from flowreg3d_tpu_torch.pipeline import OFOptions

    if defaults:
        return OFOptions()
    return OFOptions(alpha=2.0, iterations=20, update_lag=10, levels=50,
                     eta=0.8, min_level=0, a_smooth=0.5, a_data=0.45)


def run_pipeline(frames, reference, use_kernels, dev, defaults=False,
                 options=None, stats=None, **config):
    """compensate_arr_3D over the recording; returns (registered, flows,
    seconds, what ran: the engine and the executor). ``config``: fields of
    RegistrationConfig beside use_kernels (none: the default config).
    ``stats``: a dict that receives the run's per-frame mean_disp and
    max_disp, and its executor's get_info()."""
    from flowreg3d_tpu_torch.pipeline import (RegistrationConfig,
                                              compensate_arr_3D)
    from flowreg3d_tpu_torch.pipeline.corrector import BatchMotionCorrector

    opts = pipeline_options(defaults) if options is None else options
    ran = []
    run = BatchMotionCorrector.run

    def recorded(self, *args, **kwargs):
        ran.append(self)
        return run(self, *args, **kwargs)

    BatchMotionCorrector.run = recorded
    try:
        t = time.perf_counter()
        reg, flows = compensate_arr_3D(
            frames, reference, opts,
            config=RegistrationConfig(use_kernels=use_kernels, **config),
            device=dev)
        seconds = time.perf_counter() - t
    finally:
        BatchMotionCorrector.run = run
    info = dict(resident=getattr(ran[0], "used_device_resident", False),
                executor=ran[0].executor.name)
    if stats is not None:
        stats.update(mean_disp=ran[0].mean_disp, max_disp=ran[0].max_disp,
                     executor_info=ran[0].executor.get_info())
    return reg, flows, seconds, info


def per_solve_launches(o, plan, channels=1):
    """Kernel launches of one flow solve and the raw frame's warp."""
    from flowreg3d_tpu_torch.core.solver import _blocks

    psi = o.a_smooth != 1.0
    blocks = len(plan) * len(_blocks(o.iterations, o.update_lag))
    return {
        "sor_iterations_psi_f32": blocks * psi,
        "psi_field_f32": 0,
        "sor_halfsweep_psi_f32": 0,
        "sor_iterations_f32": blocks * (not psi),
        "map_coords_f32": (len(plan) + 1) * channels,
        "median5_f32": sum(min(size) > 5 for _, size, _ in plan),
        "sor_halfsweep_const_f32": 0,
    }


def frame_quality(frames, reference, reg, flows):
    """Per frame: PSNR of the registered volume against the reference,
    improvement ratio, mean displacement."""
    from flowreg3d_tpu_torch.pipeline import flow_statistics

    check(reg.shape == frames.shape and flows.shape == frames.shape + (3,)
          and np.isfinite(reg).all() and np.isfinite(flows).all(),
          f"pipeline output {reg.shape} {flows.shape} or non-finite")
    return dict(
        psnr=[psnr(reference, r) for r in reg],
        improvement=[mse(f, reference) / mse(r, reference)
                     for f, r in zip(frames, reg)],
        mean_disp=flow_statistics(flows)["mean_disp"])


def check_quality(k, p, tag):
    """Kernel run ``k`` against reference run ``p`` (frame_quality dicts):
    PSNR within 0.5 dB, improvement within 2% and > 1, mean_disp within
    2%."""
    for t in range(len(p["psnr"])):
        check(abs(k["psnr"][t] - p["psnr"][t]) <= 0.5,
              f"{tag} frame {t}: PSNR {k['psnr'][t]} vs {p['psnr'][t]}")
        check(abs(k["improvement"][t] - p["improvement"][t])
              <= 0.02 * p["improvement"][t],
              f"{tag} frame {t}: improvement {k['improvement'][t]} vs "
              f"{p['improvement'][t]}")
        check(k["improvement"][t] > 1 and p["improvement"][t] > 1,
              f"{tag} frame {t}: no improvement")
        check(abs(k["mean_disp"][t] - p["mean_disp"][t])
              <= 0.02 * abs(p["mean_disp"][t]),
              f"{tag} frame {t}: mean_disp {k['mean_disp'][t]} vs "
              f"{p['mean_disp'][t]}")


def download_times(dev, arrays, n=2):
    """Host seconds to bring ``arrays`` (uploaded here) down: pageable
    ``.cpu()`` copies, and the pipeline's ``HostStaging`` (page-locked
    buffers reused, non_blocking copies, one sync, then a copy into
    pageable memory); best of n after a warm pass each."""
    import torch

    from flowreg3d_tpu_torch.pipeline.device_pipeline import HostStaging

    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    staging = HostStaging(pinned=True)
    ways = {"pageable": lambda: [x.cpu().numpy() for x in tensors],
            "staged": lambda: staging.download(tensors)}
    out = {}
    for tag, way in ways.items():
        times = []
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            way()
            times.append(time.perf_counter() - t)
        out[tag] = min(times[1:])
    check(all(b.is_pinned() for b in staging.buffers),
          "download staging buffers are not page-locked")
    return out


def replayed(graph):
    """Kernel launches the graph's replays ran, by wrapper."""
    return {k: graph.launches.get(k, 0) * graph.replays
            for k in KERNEL_SYMBOLS}


def check_device_counts(tag, work, *graphs):
    """One run of ``work`` (which reuses ``graphs``) under the profiler: the
    kernel executions the card ran, by wrapper, must equal the wrappers'
    host launches plus the launches the graphs' replays ran."""
    replays = [g.replays for g in graphs]
    reset_counts()
    _, device, _ = profiled(work)
    host = read_counts()
    n = [g.replays - r for g, r in zip(graphs, replays)]
    want = {k: host[k] + sum(g.launches.get(k, 0) * d
                             for g, d in zip(graphs, n))
            for k in KERNEL_SYMBOLS}
    log(f"  {tag}: profiled warm run: {n} replays, host launches {host}, "
        f"kernel executions on the card {device}")
    check(all(n) and device == want, f"{tag}: the card ran {device}, the "
          f"host launches and {n} replays account for {want}")


def pinned_host_stats():
    """PyTorch's page-locked host allocator: bytes it holds allocated and
    the cudaHostAlloc calls it has made, where this PyTorch reports them."""
    import torch

    stats = (torch.cuda.host_memory_stats()
             if hasattr(torch.cuda, "host_memory_stats") else {})
    return {k: v for k, v in stats.items()
            if k in ("allocated_bytes.current", "num_host_alloc")}


def card_memory(tag):
    """Log the card memory a finished pipeline call leaves held (then with
    the allocator's cache emptied: what the cached graph's pool and live
    tensors hold), and the page-locked host memory PyTorch holds."""
    import torch

    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    log(f"  {tag}: after the call {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated, {reserved / 2**30:.2f} GiB reserved on the card, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB with the "
        f"allocator's cache emptied; pinned host memory "
        f"{pinned_host_stats() or 'not reported'}")


def phase_pipeline(card, dev, fixed, defaults=False):
    """The in-memory pipeline over a drifting recording at the default
    config, kernels against the plain path; the host-staged sequential path
    beside it; warm throughput of both and the download pinned against
    pageable: phase 6 at the direct API's flow options, 6b at OFOptions'
    own defaults."""
    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.parallel import executors as tex

    tag = "6b" if defaults else "6"
    o = pipeline_options(defaults)
    plan, _, _ = level_schedule(SHAPE, o.eta, o.levels,
                                o.effective_min_level)
    frames = recording(fixed, PIPELINE_T)
    solves = 2 * PIPELINE_T
    log(f"phase {tag}: pipeline compensate_arr_3D over T={PIPELINE_T} frames"
        f" of {SHAPE} (initial w pass + batch: {solves} flow solves), alpha "
        f"{o.alpha}, a_smooth {o.a_smooth}, min_level {o.min_level}, "
        f"{o.iterations} iterations, update_lag {o.update_lag}: {len(plan)} "
        "levels; default config")
    per_solve = per_solve_launches(o, plan)
    tex.clear_frame_graphs()
    reset_counts()
    reg_k, flows_k, first_s, info = run_pipeline(frames, fixed, True, dev,
                                                 defaults)
    launches = read_counts()
    graphs = tex.frame_graphs()
    check(info == dict(resident=True, executor="batched"),
          f"phase {tag}: the default config ran {info}")
    check(len(graphs) == 1 and graphs[0].replays == solves,
          f"phase {tag}: {len(graphs)} graphs, replays "
          f"{[g.replays for g in graphs]}; want 1 graph, {solves} replays")
    graph = graphs[0]
    reps = replayed(graph)
    # from the host, only the capture's warm eager frame launches
    log(f"  kernel run ({first_s:.2f} s, graph captured in "
        f"{graph.capture_s:.2f} s, {graph.replays} replays): host launches "
        f"{launches}, expected {per_solve}; replays ran {reps}")
    check(launches == per_solve, f"pipeline host launches {launches} != "
          f"{per_solve}")
    check(graph.launches == {k: v for k, v in per_solve.items() if v},
          f"graph holds {graph.launches}, one solve launches {per_solve}")
    card_memory(f"phase {tag} default config (one graph cached)")
    check_device_counts(f"phase {tag}", lambda: run_pipeline(
        frames, fixed, True, dev, defaults), graph)
    _, _, warm_s, _ = run_pipeline(frames, fixed, True, dev, defaults)
    check(tex.frame_graphs() == [graph], "the warm run captured again")
    reg_p, flows_p, plain_s, info_p = run_pipeline(frames, fixed, False, dev,
                                                   defaults)
    check(info_p == info, f"plain run ran {info_p}")
    k = frame_quality(frames, fixed, reg_k, flows_k)
    p = frame_quality(frames, fixed, reg_p, flows_p)
    log(f"  plain run {plain_s:.2f} s; kernel {k}; plain {p}; max|registered"
        f" diff| {float(np.abs(reg_k - reg_p).max()):.3e}, max|flow diff| "
        f"{float(np.abs(flows_k - flows_p).max()):.3e}")
    check_quality(k, p, f"phase {tag} kernel vs plain")
    check(np.array_equal(reg_k, reg_p) and np.array_equal(flows_k, flows_p),
          "pipeline: kernel and plain paths are not bit-identical")

    staged_cfg = dict(parallelization="sequential", device_resident=False)
    reg_s, flows_s, staged_s, info_s = run_pipeline(frames, fixed, True, dev,
                                                    defaults, **staged_cfg)
    check(info_s == dict(resident=False, executor="sequential"),
          f"host-staged run ran {info_s}")
    s_q = frame_quality(frames, fixed, reg_s, flows_s)
    same = bool(np.array_equal(reg_k, reg_s)
                and np.array_equal(flows_k, flows_s))
    log(f"  host-staged sequential run {staged_s:.2f} s; {s_q}; default "
        f"config against it: max|registered diff| "
        f"{float(np.abs(reg_k - reg_s).max()):.3e}, max|flow diff| "
        f"{float(np.abs(flows_k - flows_s).max()):.3e}, bit-identical {same}")
    check_quality(k, s_q, f"phase {tag} default config vs host-staged")

    _, _, staged_warm_s, _ = run_pipeline(frames, fixed, True, dev, defaults,
                                          **staged_cfg)
    dl = download_times(dev, [reg_k, flows_k])
    log(f"  pipeline warm run: {warm_s:.3f} s for {PIPELINE_T} volumes, "
        f"{PIPELINE_T / warm_s:.4f} volumes/s at the default config; "
        f"host-staged sequential {staged_warm_s:.3f} s, "
        f"{PIPELINE_T / staged_warm_s:.4f} volumes/s ({solves} flow solves);"
        f" downloading the registered frames and flows "
        f"({(reg_k.nbytes + flows_k.nbytes) / 1e6:.0f} MB): pageable "
        f"{dl['pageable'] * 1e3:.1f} ms, staged (pinned, then pageable) "
        f"{dl['staged'] * 1e3:.1f} ms; card {card}")
    tex.clear_frame_graphs()
    return launches, reps, PIPELINE_T / warm_s


def phase_graphs_together(card, dev, fixed):
    """get_displacement's graph and the pipeline's frame graph cached on the
    card together, at the direct API's options: a direct call, then the
    pipeline (its frame graph captured beside the pyramid's), then a direct
    call at C = 2 (its graph captured beside the frame graph); the card
    memory reserved after each."""
    import torch

    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch.core.pyramid import pyramid_graphs
    from flowreg3d_tpu_torch.parallel import executors as tex

    log("phase 6d: get_displacement's graph and the pipeline's frame graph "
        "on the card together, at the direct API's options")
    frames = recording(fixed, PIPELINE_T)
    f, m = (torch.from_numpy(a).to(dev) for a in (fixed, frames[0]))
    tex.clear_frame_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    mem = {}

    def cached(tag, n_pyramid, n_frame):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem[tag] = round((torch.cuda.memory_reserved() - base) / 2**30, 2)
        check(len(pyramid_graphs()) == n_pyramid
              and len(tex.frame_graphs()) == n_frame,
              f"phase 6d, {tag}: {len(pyramid_graphs())} pyramid and "
              f"{len(tex.frame_graphs())} frame graphs cached")

    flow1 = ft.get_displacement(f, m, device=dev)
    cached("a direct call", 1, 0)
    _, flows, _, info = run_pipeline(frames, fixed, True, dev)
    cached("then the pipeline", 1, 1)
    flow2 = ft.get_displacement(two_channels(f), two_channels(m), device=dev)
    cached("then a direct call at C = 2", 1, 1)
    check(info == dict(resident=True, executor="batched")
          and np.isfinite(flows).all() and bool(torch.isfinite(flow1).all())
          and bool(torch.isfinite(flow2).all()),
          f"phase 6d: ran {info}, or non-finite flows")
    log(f"  GiB reserved beyond the start with both kinds of graph cached: "
        f"{mem}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"allocated; card {card}")
    tex.clear_frame_graphs()


def profiled(work):
    """One run of ``work`` under the profiler: (its result, the port's
    kernel executions on the card by wrapper, the runtime's launch calls by
    name: kernel launches, plain and cooperative, and graph launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = work()
        torch.cuda.synchronize()
    device = dict.fromkeys(KERNEL_SYMBOLS, 0)
    host = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for k, pattern in KERNEL_SYMBOLS.items():
                if re.search(pattern, e.key):
                    device[k] += e.count
        elif "Launch" in e.key and e.key.startswith(("cuda", "cu")):
            host[e.key] = e.count
    return out, device, host



def phase_executors(card, dev, fixed):
    """T=4 canonical frames through the batched executor (one CUDA graph a
    frame) and the sequential one (eager), at OFOptions() defaults and at
    the direct API's options."""
    import torch

    from flowreg3d_tpu_torch.parallel import executors as tex
    from flowreg3d_tpu_torch.pipeline.device_pipeline import preprocess

    log(f"phase 7: executors, T={PIPELINE_T} frames of {SHAPE}: batched "
        "(CUDA-graph replay) against sequential (eager)")
    frames = recording(fixed, PIPELINE_T)
    raw = torch.from_numpy(frames[..., None]).to(dev)
    ref_raw = torch.from_numpy(fixed[..., None]).to(dev)
    out = {}
    for tag, defaults in (("defaults", True), ("direct options", False)):
        o = pipeline_options(defaults)
        proc = preprocess(raw, o, ref_raw)
        ref_proc = preprocess(ref_raw, o)
        fp = o.to_dict()
        w_init = torch.zeros(SHAPE + (3,), device=dev)
        seq = tex.SequentialExecutor3D(device=dev)
        bat = tex.BatchedExecutor3D(device=dev)

        def run(ex):
            r = ex.process_batch(raw, proc, ref_raw, ref_proc, w_init,
                                 interpolation_method="cubic", flow_params=fp)
            torch.cuda.synchronize()
            return r

        tex.clear_frame_graphs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_alloc = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        reg_b, flow_b = run(bat)
        first_b = time.perf_counter() - t
        graph = tex.frame_graphs()[-1]
        peak = torch.cuda.max_memory_allocated() - base_alloc
        del reg_b, flow_b
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() - base_alloc
        reserved = torch.cuda.memory_reserved() - base_reserved
        reg_b, flow_b = run(bat)
        reg_s, flow_s = run(seq)
        d_flow = float((flow_b - flow_s).abs().max())
        d_reg = float((reg_b - reg_s).abs().max())
        same = bool(torch.equal(flow_b, flow_s) and torch.equal(reg_b, reg_s))
        fixed_np = fixed
        q = {name: dict(
            psnr=[psnr(fixed_np, r[..., 0].cpu().numpy()) for r in reg],
            improvement=[mse(f, fixed_np) / mse(r[..., 0].cpu().numpy(),
                                                fixed_np)
                         for f, r in zip(frames, reg)])
             for name, reg in (("batched", reg_b), ("sequential", reg_s))}
        for t_ in range(PIPELINE_T):
            kq, sq = q["batched"], q["sequential"]
            check(abs(kq["psnr"][t_] - sq["psnr"][t_]) <= 0.5,
                  f"phase 7 {tag} frame {t_}: PSNR {kq['psnr'][t_]} vs "
                  f"{sq['psnr'][t_]}")
            check(abs(kq["improvement"][t_] - sq["improvement"][t_])
                  <= 0.02 * sq["improvement"][t_],
                  f"phase 7 {tag} frame {t_}: improvement")
        ms = {}
        for name, ex in (("batched", bat), ("sequential", seq)):
            t = time.perf_counter()
            run(ex)
            ms[name] = 1e3 * (time.perf_counter() - t) / PIPELINE_T
        calls = {name: profiled(lambda: run(ex))[2]
                 for name, ex in (("batched", bat), ("sequential", seq))}
        per_frame = {name: {k: v / PIPELINE_T for k, v in c.items()}
                     for name, c in calls.items()}
        log(f"  {tag}: batched vs sequential max|flow diff| {d_flow:.3e}, "
            f"max|registered diff| {d_reg:.3e}, bit-identical {same}; "
            f"quality {q}")
        log(f"  {tag}: capture {graph.capture_s:.3f} s (first batched run "
            f"{first_b:.2f} s), graph holds {graph.launches} kernel "
            f"launches, {graph.replays} replays; memory: peak "
            f"{peak / 2**30:.2f} GiB allocated in the first batched run "
            f"(capture included), held by the graph after it "
            f"{held / 2**30:.2f} GiB allocated (static buffers and "
            f"outputs), {reserved / 2**30:.2f} GiB reserved (with its "
            f"private pool)")
        log(f"  {tag}: warm ms a frame batched {ms['batched']:.2f}, "
            f"sequential {ms['sequential']:.2f}; host launch calls a frame "
            f"batched {per_frame['batched']}, sequential "
            f"{per_frame['sequential']}; card {card}")
        out[tag] = dict(same=same, ms=ms, calls=per_frame)
        del reg_b, flow_b, reg_s, flow_s, proc, ref_proc
        tex.clear_frame_graphs()
    return out


def phase_pipeline_long(card, dev, fixed, profile=False, n_frames=24):
    """A T=24 u16 recording (the T=4 drift repeated) at OFOptions()
    defaults (buffer 10: three batches; the initial w from the first batch;
    output_typename 'double') at the default config, kernels only: warm
    volumes/s. Returns (launches, replays, the recording for phase 9: its
    frames, reference, registered frames cast back to u16, statistics and
    volumes/s)."""
    from flowreg3d_tpu_torch.parallel import executors as tex
    from flowreg3d_tpu_torch.pipeline import OFOptions

    o = OFOptions()
    frames = np.clip(np.rint(recording(fixed, n_frames, period=PIPELINE_T)
                             * 10000), 0, 65535).astype(np.uint16)
    reference = fixed * 10000.0
    log(f"phase 6c: pipeline over a T={n_frames} u16 recording of {SHAPE} at"
        f" OFOptions() defaults (buffer {o.buffer_size}), default config")
    reset_counts()
    stats = {}
    reg, flows, first_s, info = run_pipeline(frames, reference, True, dev,
                                             options=o, stats=stats)
    launches = read_counts()
    check(info == dict(resident=True, executor="batched"),
          f"phase 6c ran {info}")
    # cast to u16 on the card, then to 'double' on the host
    check(reg.dtype == np.float64 and np.array_equal(reg, np.rint(reg))
          and reg.shape == frames.shape and reg.max() <= 65535
          and flows.shape == frames.shape + (3,)
          and np.isfinite(flows).all(), f"phase 6c output {reg.dtype} "
          f"{reg.shape} {flows.shape}: not u16 values, or non-finite flows")
    improvement = [mse(f, reference) / mse(r, reference)
                   for f, r in zip(frames, reg)]
    check(min(improvement) > 1, f"phase 6c: no improvement {improvement}")
    t24 = dict(frames=frames, reference=reference,
               registered=reg.astype(np.uint16), **stats)
    graph = tex.frame_graphs()[0]
    reps = replayed(graph)
    for name in ("sor_iterations_f32", "map_coords_f32", "median5_f32"):
        check(launches[name] > 0 and reps[name] > 0,
              f"phase 6c: {name} not launched ({launches}, replays {reps})")
    del reg, flows
    pinned = pinned_host_stats()
    _, _, warm_s, _ = run_pipeline(frames, reference, True, dev, options=o)
    pinned_after = pinned_host_stats()
    log(f"  pinned host memory around the warm run (three batches): before "
        f"{pinned}, after {pinned_after}")
    # the read-ahead thread is on by default: the same warm run without it,
    # for comparison in this call
    _, _, warm0_s, _ = run_pipeline(frames, reference, True, dev, options=o,
                                    prefetch=0)
    log(f"  warm run without the read-ahead thread (prefetch=0): "
        f"{warm0_s:.3f} s, {n_frames / warm0_s:.4f} volumes/s")
    if "num_host_alloc" in pinned:
        # one staging buffer per output: frames, stats, valid flags, flows
        check(pinned_after["num_host_alloc"] - pinned["num_host_alloc"] <= 4,
              f"phase 6c: the warm run pinned {pinned} -> {pinned_after}")
    log(f"  first run {first_s:.2f} s, host launches {launches}, replays "
        f"ran {reps}; improvement "
        f"{[round(x, 3) for x in improvement]}; warm run {warm_s:.3f} s, "
        f"{n_frames / warm_s:.4f} volumes/s; card {card}")
    if profile:
        phase_profile(lambda: run_pipeline(frames, reference, True, dev,
                                           options=o), "pipeline_T24")
    t24["volumes_per_s"] = n_frames / warm_s
    return launches, reps, t24


def phase_cc(card, dev, fixed):
    """The cc prealignment pipeline at OFOptions() defaults: the batched
    executor replays a prealignment graph and a frame graph a frame; held
    bit for bit to the same pipeline with the prealignment eager, at both
    use_kernels, and kernels against plain; the order-1 (prealignment)
    warps counted apart; warm volumes/s with the prealignment replayed and
    eager, in turns."""
    import torch

    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.ops import warp as tw
    from flowreg3d_tpu_torch.parallel import executors as tex
    from flowreg3d_tpu_torch.pipeline import OFOptions

    o = OFOptions(cc_initialization=True)
    plan, _, _ = level_schedule(SHAPE, o.eta, o.levels,
                                o.effective_min_level)
    frames = recording(fixed, PIPELINE_T)
    T = PIPELINE_T
    log(f"phase 8: cc prealignment pipeline, T={T} frames of {SHAPE}, "
        f"OFOptions(cc_initialization=True) (cc_hw {o.cc_hw}, cc_up "
        f"{o.cc_up}): the host-staged path, the batched executor")
    order1 = [0]
    sample = tw.map_coords

    def counted(coeff, cz, cy, cx, order):
        order1[0] += order == 1
        return sample(coeff, cz, cy, cx, order)

    per_solve = per_solve_launches(o, plan)
    # from the host: no initial-w pass under cc; the warm frames of the
    # two captures (the prealignment's 2 order-1 warps, a solve and its
    # warp) and one final warp a frame
    expected = dict(per_solve)
    expected["map_coords_f32"] += 2 + T
    tex.clear_frame_graphs()
    reset_counts()
    tw.map_coords = counted
    try:
        reg_k, flows_k, first_s, info = run_pipeline(frames, fixed, True,
                                                     dev, options=o)
    finally:
        tw.map_coords = sample
    launches = read_counts()
    check(info == dict(resident=False, executor="batched"),
          f"phase 8 ran {info}")
    graph = tex.frame_graphs()[0]
    (pre,) = tex.prealign_graphs()
    reps = {k: v + pre.launches.get(k, 0) * pre.replays
            for k, v in replayed(graph).items()}
    log(f"  kernel run ({first_s:.2f} s): host launches {launches} (order-1 "
        f"prealignment warps called {order1[0]} times: warm run and "
        f"capture), expected {expected}; {graph.replays} frame replays, "
        f"{pre.replays} prealignment replays (captured in "
        f"{pre.capture_s:.3f} s, {pre.launches} a replay) ran {reps}")
    check(launches == expected and order1[0] == 4 and graph.replays == T
          and pre.replays == T and pre.launches == {"map_coords_f32": 2},
          f"cc launches {launches}, order 1 {order1[0]}, replays "
          f"{graph.replays} / {pre.replays}, prealignment graph "
          f"{pre.launches}; want {expected}, 4, {T}, {T}, 2 warps")
    check_device_counts("phase 8", lambda: run_pipeline(
        frames, fixed, True, dev, options=o), graph, pre)
    check(tex.frame_graphs() == [graph] and tex.prealign_graphs() == [pre],
          "the warm run captured again")

    # one frame's prealignment replayed against eager prealign, bit for bit
    ref_t = torch.from_numpy(fixed[..., None]).to(dev)
    frame_t = torch.from_numpy(frames[1][..., None]).to(dev)
    w0 = torch.zeros(SHAPE + (3,), device=dev)
    align = tex.BatchedExecutor3D(device=dev)._prealigner(
        ref_t, w0, o.to_dict())
    got = align(frame_t)
    want = tex.BaseExecutor3D(device=dev)._prealigner(
        ref_t, w0, o.to_dict())(frame_t)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "the prealignment graph differs from the eager prealign")
    del align, got, want, ref_t, frame_t, w0

    # the same pipeline with the prealignment eager: the executor's own
    # eager body in place of its graph, for this comparison only
    graph_align = tex.BatchedExecutor3D._align_fn

    def eager_prealign(use_kernels):
        tex.BatchedExecutor3D._align_fn = tex.BaseExecutor3D._align_fn
        try:
            return run_pipeline(frames, fixed, use_kernels, dev, options=o)
        finally:
            tex.BatchedExecutor3D._align_fn = graph_align

    reg_e, flows_e, _, _ = eager_prealign(True)
    reg_p, flows_p, plain_s, _ = run_pipeline(frames, fixed, False, dev,
                                              options=o)
    reg_pe, flows_pe, _, _ = eager_prealign(False)
    same = {}
    for tag, a, b in (("kernels", (reg_k, flows_k), (reg_e, flows_e)),
                      ("plain", (reg_p, flows_p), (reg_pe, flows_pe))):
        same[tag] = (float(np.abs(a[0] - b[0]).max()),
                     float(np.abs(a[1] - b[1]).max()))
        check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
              f"cc pipeline ({tag}): the replayed prealignment differs from"
              f" the eager one, max|diff| registered, flows {same[tag]}")
    log(f"  replayed prealignment against eager, max|diff| (registered, "
        f"flows): {same}")
    k = frame_quality(frames, fixed, reg_k, flows_k)
    p = frame_quality(frames, fixed, reg_p, flows_p)
    log(f"  plain run {plain_s:.2f} s; kernel {k}; plain {p}; max|registered"
        f" diff| {float(np.abs(reg_k - reg_p).max()):.3e}, max|flow diff| "
        f"{float(np.abs(flows_k - flows_p).max()):.3e}")
    check_quality(k, p, "phase 8 kernel vs plain")
    check(np.array_equal(reg_k, reg_p) and np.array_equal(flows_k, flows_p),
          "cc pipeline: kernel and plain paths are not bit-identical")
    del reg_e, flows_e, reg_p, flows_p, reg_pe, flows_pe
    warm = {"graph": [], "eager": []}
    for _ in range(3):
        warm["graph"].append(run_pipeline(frames, fixed, True, dev,
                                          options=o)[2])
        warm["eager"].append(eager_prealign(True)[2])
    med = {k: float(np.median(v)) for k, v in warm.items()}
    log(f"  cc pipeline warm runs in turns, prealignment replayed "
        f"{[round(x, 3) for x in warm['graph']]} s, eager "
        f"{[round(x, 3) for x in warm['eager']]} s: medians "
        f"{T / med['graph']:.4f} against {T / med['eager']:.4f} volumes/s; "
        f"card {card}")
    tex.clear_frame_graphs()
    return launches, reps, T / med["graph"]


class Interrupted(Exception):
    """Raised by phase 9 to interrupt a run after its first checkpoint."""


def read_tiff(path, prefetch=0, buffer_size=10):
    """All frames of a TIFF through the port's streaming reader (wrapped in
    the read-ahead reader when ``prefetch``), batch by batch; returns
    (frames, seconds)."""
    from flowreg3d_tpu_torch.io.prefetch import PrefetchReader3D
    from flowreg3d_tpu_torch.io.tiff3d import TIFFFileReader3D

    t = time.perf_counter()
    reader = TIFFFileReader3D(str(path), buffer_size=buffer_size)
    if prefetch:
        reader = PrefetchReader3D(reader, prefetch_depth=prefetch)
    batches = []
    while reader.has_batch():
        batches.append(reader.read_batch())
    reader.close()
    return np.concatenate(batches), time.perf_counter() - t


def write_tiff(path, frames):
    """The frames through the port's TIFF writer; returns seconds."""
    from flowreg3d_tpu_torch.io.tiff3d import TIFFFileWriter3D

    t = time.perf_counter()
    w = TIFFFileWriter3D(str(path))
    w.write_frames(frames)
    w.close()
    return time.perf_counter() - t


def phase_file_pipeline(card, dev, t24, profile=False):
    """Phase 9: the file-based pipeline over phase 6c's T=24 u16 recording,
    written to a TIFF in a temporary directory: (a) the reader returns it
    bit for bit, with and without the read-ahead wrapper; (b)
    compensate_recording at OFOptions() defaults and the default config
    (batched, resident, prefetch 2, the async writer), TIFF out, equals
    phase 6c's registered frames and statistics bit for bit, with its
    launches and (warm, profiled) the card's kernel executions; (c) warm
    volumes/s with and without prefetch and the async writer; (d) a T=8
    run interrupted after its first batch and resumed equals the
    uninterrupted run; (e) the CLI's tiff-reshape --scale equals the
    port's resize on the card."""
    import tempfile

    import torch

    from flowreg3d_tpu_torch.cli.main import main as cli_main
    from flowreg3d_tpu_torch.io._tiff_format import TiffWriter
    from flowreg3d_tpu_torch.ops.resize import imresize_fused_gauss_cubic3D
    from flowreg3d_tpu_torch.parallel import executors as tex
    from flowreg3d_tpu_torch.pipeline import (OFOptions, RegistrationConfig,
                                              compensate_recording)
    from flowreg3d_tpu_torch.pipeline.corrector import BatchMotionCorrector

    # (T, Z, Y, X, 1): the TIFF writer reads a 4-D array as one (Z,Y,X,C)
    # volume
    frames, reference = t24["frames"][..., None], t24["reference"]
    T = len(frames)
    log(f"phase 9: the file pipeline, compensate_recording over phase 6c's "
        f"T={T} u16 recording of {SHAPE} as a TIFF, OFOptions() defaults, "
        f"the default config {RegistrationConfig()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        src = tmp / "rec.tif"
        write_s = write_tiff(src, frames)
        size = src.stat().st_size
        with open(src, "rb") as f:
            magic = f.read(4)
        # (a) reading back
        reads = {}
        for prefetch in (0, 2):
            got, reads[prefetch] = read_tiff(src, prefetch)
            check(got.dtype == np.uint16 and np.array_equal(got, frames),
                  f"phase 9: the TIFF read back (prefetch {prefetch}) is not "
                  "the recording")
            del got
        kind = "BigTIFF" if magic[2] == 43 else "classic TIFF"
        log(f"  (a) wrote {size / 1e6:.1f} MB ({kind}) in {write_s:.3f} s "
            f"({size / 1e6 / write_s:.0f} MB/s); read back bit for bit in "
            f"{reads[0]:.3f} s, with prefetch 2 {reads[2]:.3f} s")

        def run(out, config=None, path=src, **kw):
            t = time.perf_counter()
            corr = BatchMotionCorrector(OFOptions(
                input_file=str(path), output_path=tmp / out,
                output_format="TIFF", reference_frames=reference, **kw),
                config, dev)
            corr.run()
            return corr, time.perf_counter() - t

        def registered(out):
            got, _ = read_tiff(tmp / out / "compensated.TIFF")
            return got

        def check_run(out, tag):
            got = registered(out)
            check(got.dtype == np.uint16
                  and np.array_equal(got[..., 0], t24["registered"]),
                  f"phase 9 {tag}: the registered TIFF is not phase 6c's "
                  "registered frames")
            stats = np.load(tmp / out / "statistics.npz")
            for key in ("mean_disp", "max_disp"):
                check(np.array_equal(stats[key], np.asarray(t24[key])),
                      f"phase 9 {tag}: statistics.npz {key} is not phase "
                      "6c's")

        # (b) the whole run, cold: the capture's warm frame launches every
        # kernel from the host, the replays the rest
        tex.clear_frame_graphs()
        reset_counts()
        corr, first_s = run("out")
        launches = read_counts()
        check(corr.used_device_resident and corr.executor.name == "batched",
              f"phase 9 ran resident {corr.used_device_resident}, executor "
              f"{corr.executor.name}")
        graph = tex.frame_graphs()[0]
        reps = replayed(graph)
        for name in ("sor_iterations_f32", "map_coords_f32", "median5_f32"):
            check(launches[name] > 0 and reps[name] > 0,
                  f"phase 9: {name} not launched ({launches}, replays "
                  f"{reps})")
        check_run("out", "(b) first run")
        log(f"  (b) first run {first_s:.2f} s (capture included): host "
            f"launches {launches}, {graph.replays} replays ran {reps}; the "
            "registered TIFF and statistics.npz equal phase 6c's bit for "
            "bit")
        # (c) warm volumes/s, with and without prefetch and the async writer
        plain_cfg = RegistrationConfig(prefetch=0, async_write=False)
        secs = {"default": [], "plain": []}
        for tag in ("default", "plain", "default", "plain"):
            _, s = run(f"out_{tag}",
                       plain_cfg if tag == "plain" else None)
            secs[tag].append(s)
            if len(secs[tag]) == 1:
                check_run(f"out_{tag}", f"(c) {tag}")
            (tmp / f"out_{tag}" / "compensated.TIFF").unlink()
        vols = {k: T / min(v) for k, v in secs.items()}
        log(f"  (c) warm runs (host clock around compensate_recording, the "
            f"TIFF read and write included): default config "
            f"{[round(x, 3) for x in secs['default']]} s, best "
            f"{vols['default']:.4f} volumes/s; prefetch 0 and no async "
            f"writer {[round(x, 3) for x in secs['plain']]} s, best "
            f"{vols['plain']:.4f} volumes/s; phase 6c in memory "
            f"{t24['volumes_per_s']:.4f} volumes/s; card {card}")
        if profile:
            phase_profile(lambda: run("out"), "pipeline_file_T24")
            check_run("out", "(b) profiled run")
        (tmp / "out" / "compensated.TIFF").unlink()
        # the card's kernel executions, on the first 8 frames (16 replays:
        # the profiler's cost grows with the ~8800 kernels a replay runs)
        src8 = tmp / "rec8.tif"
        write_tiff(src8, frames[:8])
        check_device_counts("phase 9", lambda: run("out8", path=src8),
                            graph)

        # (d) checkpoint: T=8 in two batches, interrupted after the first
        cfg = RegistrationConfig(checkpoint=True)

        def run8(out):
            run(out, cfg, path=src8, buffer_size=4)

        run8("full8")
        save = BatchMotionCorrector._save_checkpoint

        def interrupt(self, frames_done):
            save(self, frames_done)
            raise Interrupted(frames_done)

        BatchMotionCorrector._save_checkpoint = interrupt
        try:
            run8("resumed8")
            check(False, "phase 9 (d): the run was not interrupted")
        except Interrupted as e:
            check(e.args == (4,), f"phase 9 (d): interrupted at {e.args}")
        finally:
            BatchMotionCorrector._save_checkpoint = save
        ckpt = tmp / "resumed8" / "checkpoint.npz"
        check(ckpt.exists(), "phase 9 (d): no checkpoint after the interrupt")
        run8("resumed8")
        full = registered("full8")
        resumed = registered("resumed8")
        check(not ckpt.exists(), "phase 9 (d): the checkpoint is still there")
        check(full.shape[0] == 8 and np.array_equal(resumed, full[4:]),
              "phase 9 (d): the resumed run's frames are not the "
              "uninterrupted run's")
        s_full = np.load(tmp / "full8" / "statistics.npz")
        s_res = np.load(tmp / "resumed8" / "statistics.npz")
        for key in s_full:
            check(np.array_equal(s_full[key], s_res[key]),
                  f"phase 9 (d): statistics {key} differ after the resume")
        log("  (d) a T=8 run (buffer 4) interrupted after its first batch "
            "and resumed: frames 4-7 and the statistics of all 8 equal the "
            "uninterrupted run's bit for bit; the checkpoint is gone")

        # (e) the CLI: a flat TIFF, 64 pages a volume, reshaped and scaled
        flat = tmp / "flat.tif"
        n_vol, scale = 3, (0.5, 0.5, 0.5)
        with TiffWriter(str(flat)) as tw:
            for page in frames[:n_vol, ..., 0].reshape(-1, *SHAPE[1:]):
                tw.write_page(page)
        t = time.perf_counter()
        rc = cli_main(["tiff-reshape", str(flat), str(tmp / "vol.tif"),
                       "--slices-per-volume", str(SHAPE[0]), "--scale",
                       *map(str, scale)])
        cli_s = time.perf_counter() - t
        check(rc == 0, f"phase 9 (e): tiff-reshape returned {rc}")
        got, _ = read_tiff(tmp / "vol.tif")
        size = tuple(max(1, round(n * f)) for n, f in zip(SHAPE, scale[::-1]))
        want = np.stack([imresize_fused_gauss_cubic3D(
            torch.from_numpy(v).to(dev), size).cpu().numpy()
            for v in frames[:n_vol]])
        check(got.shape == (n_vol,) + size + (1,) and got.dtype == np.uint16
              and np.array_equal(got, want), f"phase 9 (e): tiff-reshape "
              f"{got.shape} {got.dtype} is not the port's resize on the card")
        log(f"  (e) tiff-reshape --scale {scale} of {n_vol} volumes "
            f"({n_vol * SHAPE[0]} flat pages) on the card in {cli_s:.2f} s: "
            f"equal to imresize_fused_gauss_cubic3D on the card, {size}")
    tex.clear_frame_graphs()
    return launches, reps, vols


# -- phase 10: multi-GPU execution -------------------------------------------

def slab_split(P, n):
    """Slab rows pz and each slab's (z_off, z_lo, z_hi) for n slabs of a
    ringed P-row volume (parallel/spatial.compute_flow_level_sharded's
    split: ceil((P-2)/n) interior rows a slab, the last padded)."""
    p_int = P - 2
    pz = -(-p_int // n)
    return pz, [(k * pz, 1 if k == 0 else 0, p_int - k * pz)
                for k in range(n)]


def slab_blocks(f, pz, n):
    """Slab k of a (..., P, M, N) tensor: rows [k*pz, k*pz + pz + 2), the
    rows past the bottom ring edge copies of it."""
    import torch

    pad = pz * n + 2 - f.shape[-3]
    if pad > 0:
        f = torch.cat([f, f[..., -1:, :, :].expand(
            tuple(f.shape[:-3]) + (pad,) + tuple(f.shape[-2:]))], dim=-3)
    return [f[..., k * pz:k * pz + pz + 2, :, :].contiguous()
            for k in range(n)]


def phase_slab_kernels(card, dev):
    """10a: the slab mode of psi_field_f32, sor_halfsweep_psi_f32 and
    sor_halfsweep_const_f32 against their plain versions, max |diff| = 0:
    the (66,514,514) level in 2 slabs, (25,172,172) (23 interior rows) in 3
    with a padded last slab; the whole-volume call with the explicit slab
    (0, 1, P-2) equal to the default; each kernel timed at the 2-slab
    shape. Returns {kernel: timing row at the slab shape}."""
    import torch

    from flowreg3d_tpu_torch.core import solver_psi_kernel as spk

    log("phase 10a: slab kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(10)
    ax, ay, az = 0.7, 0.9, 1.3
    params = spk.psi_params(0.5, 1.0, 1.25, 1.5)
    timed = {}
    for P, M, N, n in SLAB_CASES:
        duvw = 0.1 * torch.randn((3, P, M, N), generator=gen, device=dev)
        base = 2.0 * torch.rand((3, P, M, N), generator=gen, device=dev)
        sj = 0.1 * torch.rand((9, P, M, N), generator=gen, device=dev)
        sj[:3] += 0.5
        psi = 0.5 + torch.rand((P, M, N), generator=gen, device=dev)
        pz, slabs = slab_split(P, n)
        blocks = [slab_blocks(f, pz, n) for f in (duvw, base, sj, psi)]
        errs = dict(psi_field=0.0, sor_halfsweep_psi=0.0,
                    sor_halfsweep_const=0.0)
        for k, slab in enumerate(slabs):
            d, b, s_, p = (x[k] for x in blocks)
            e = (spk.psi_field(d, b, *params, slab=slab)
                 - spk.psi_field_plain(d, b, *params, slab=slab))
            errs["psi_field"] = max(errs["psi_field"],
                                    float(e.abs().max()))
            for parity in (0, 1):
                for name, kern, plain, extra in (
                        ("sor_halfsweep_psi", spk.halfsweep_psi,
                         spk.halfsweep_psi_plain, (p,)),
                        ("sor_halfsweep_const", spk.halfsweep,
                         spk.halfsweep_plain, ())):
                    a, c = d.clone(), d.clone()
                    kern(a, b, s_, *extra, ax, ay, az, parity, slab)
                    plain(c, b, s_, *extra, ax, ay, az, parity, slab)
                    errs[name] = max(errs[name], float((a - c).abs().max()))
        whole = {}
        for slab in (None, (0, 1, P - 2)):
            a = duvw.clone()
            spk.halfsweep_psi(a, base, sj, psi, ax, ay, az, 1, slab)
            spk.halfsweep(a, base, sj, ax, ay, az, 0, slab)
            whole[slab] = (a, spk.psi_field(duvw, base, *params, slab=slab))
        a = duvw.clone()
        spk.halfsweep_psi_plain(a, base, sj, psi, ax, ay, az, 1)
        spk.halfsweep_plain(a, base, sj, ax, ay, az, 0)
        same = (torch.equal(whole[None][0], whole[(0, 1, P - 2)][0])
                and torch.equal(whole[None][1], whole[(0, 1, P - 2)][1])
                and torch.equal(whole[None][0], a)
                and torch.equal(whole[None][1],
                                spk.psi_field_plain(duvw, base, *params)))
        torch.cuda.synchronize()
        log(f"  ({P},{M},{N}) in {n} slabs of {pz + 2} rows {slabs}: "
            f"max|kernel-plain| {errs}; whole volume with the explicit slab "
            f"(0, 1, {P - 2}) equal to the default and to plain: {same}")
        check(max(errs.values()) == 0.0,
              f"slab kernels are not bit-equal at {(P, M, N)}: {errs}")
        check(same, f"whole-volume kernels changed at {(P, M, N)}")
        if n == 2:
            d, b, s_, p = (x[0] for x in blocks)
            slab = slabs[0]
            cells = d[0].numel()
            for name, kern, plain, n_bytes, n_ops in (
                    ("psi_field_f32",
                     lambda: spk.psi_field(d, b, *params, out=p, slab=slab),
                     lambda: spk.psi_field_plain(d, b, *params, out=p,
                                                 slab=slab),
                     28 * cells, 70 * cells),
                    ("sor_halfsweep_psi_f32",
                     lambda: spk.halfsweep_psi(d, b, s_, p, ax, ay, az, 0,
                                               slab),
                     lambda: spk.halfsweep_psi_plain(d, b, s_, p, ax, ay, az,
                                                     0, slab),
                     70 * cells, 60 * cells),
                    ("sor_halfsweep_const_f32",
                     lambda: spk.halfsweep(d, b, s_, ax, ay, az, 0, slab),
                     lambda: spk.halfsweep_plain(d, b, s_, ax, ay, az, 0,
                                                 slab),
                     66 * cells, 50 * cells)):
                bnd, by = bound_ms(n_bytes, n_ops)
                timed[name] = dict(ms=cuda_ms(kern, 50),
                                   plain_ms=cuda_ms(plain, 5, 1),
                                   bound_ms=bnd, bound_by=by,
                                   shape=tuple(d.shape[1:]))
                log(f"  {name} slab {tuple(d.shape[1:])} {slab}: "
                    f"{timed[name]['ms']:.4f} ms/launch, plain "
                    f"{timed[name]['plain_ms']:.4f} ms, bound {bnd:.4f} ms "
                    f"({by}); card {card}")
        del duvw, base, sj, psi, blocks
    return timed


def level_problem(shape, dev, seed=0):
    """tests/parallel/test_spatial.py's random level problem on the card:
    (J entries (p,m,n,1), weight, u, v, w)."""
    import torch

    rng = np.random.default_rng(seed)
    g = [rng.standard_normal(shape + (1,)).astype(np.float32) * s
         for s in (0.3, 0.3, 0.3, 0.1)]
    gx, gy, gz, gt = g
    J = (gx * gx, gy * gy, gz * gz, gt * gt, gx * gy, gx * gz, gy * gz,
         gx * gt, gy * gt, gz * gt)
    up = [torch.from_numpy(a).to(dev) for a in J]
    weight = torch.ones(shape + (1,), device=dev)
    uvw = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * 0.1).to(dev) for _ in range(3)]
    return up, weight, uvw


def unfolded_level(J, weight, u, v, w, alpha, iterations, update_lag,
                   a_data, **_):
    """The single-device a_smooth 1 level solve on the unfolded stencil
    (weights a_dir, as the sharded solve sweeps it; hx = hy = hz = 1) from
    the plain whole-volume half-sweeps: the function
    compute_flow_level_sharded computes, without its slabs, exchanges or
    kernels."""
    import torch

    from flowreg3d_tpu_torch.core.solver import (_blocks, data_exponents,
                                                 tick_update)
    from flowreg3d_tpu_torch.core.solver_psi_kernel import (halfsweep_plain,
                                                            set_boundary_3d)

    Jc = torch.stack([j.movedim(-1, 0) for j in J])
    wt = weight.movedim(-1, 0)
    a_vec = data_exponents(a_data, Jc.shape[1], u.dtype, u.device)
    ax, ay, az = (float(np.float32(a)) for a in alpha)
    base = torch.stack([u, v, w])
    duvw = torch.zeros_like(base)
    for k_iters in _blocks(iterations, update_lag):
        SJ = torch.stack(tick_update(Jc, wt, a_vec, *duvw))
        for _ in range(k_iters):
            for parity in (0, 1):
                halfsweep_plain(duvw, base, SJ, ax, ay, az, parity)
    return tuple(set_boundary_3d(duvw[k].clone()) for k in range(3))


# the largest |difference| allowed between the a_smooth 1 level solve on
# the unfolded stencil (sharded) and on the folded one (single device) after
# LEVEL_ITERATIONS: the same function, but the re-linearisation of the data
# term after the first tick block amplifies their rounding apart (10b logs
# the values' largest magnitude beside it); a wrong exchange or parity
# moves it by the values' own size
FOLD_GAP = 0.05
LEVEL_ITERATIONS = 8


def excess(a, b):
    """max over the three components of |a - b| - 5e-4 |b|: at most 5e-4
    within JAX's bound (tests/parallel/test_spatial.py:52)."""
    return max(float(((x - y).abs() - 5e-4 * y.abs()).max())
               for x, y in zip(a, b))


def phase_level_sharded(card, dev, devices):
    """10b: compute_flow_level_sharded at the canonical level LEVEL_SHAPE
    over ``devices``, both a_smooth values: kernels against plain
    bit-identical, and bit-identical to the one-slab solve (the whole
    volume through the same slab kernels: the exchange only moves values).
    Against single-device solves, within JAX's bound (``excess``): at
    a_smooth 0.5 the single-device compute_flow_level, which sweeps the
    same stencil; at a_smooth 1 the plain single-device solve on the same
    unfolded stencil (``unfolded_level``), and compute_flow_level, which
    folds the base Laplacian into the data terms, over one tick block
    (iterations = update_lag: before the data term's re-linearisation), and
    over LEVEL_ITERATIONS within ``FOLD_GAP``. Then, at both a_smooth, the
    sharded level's graph and compute_flow_level's graph against their
    eager bodies (``graph_against_eager``)."""
    import torch

    from flowreg3d_tpu_torch.core.solver import (compute_flow_level,
                                                 solve_level_cl)
    from flowreg3d_tpu_torch.parallel import spatial as tsp
    from flowreg3d_tpu_torch.parallel.spatial import (
        compute_flow_level_sharded)

    shape = LEVEL_SHAPE
    J, weight, (u, v, w) = level_problem(shape, dev)
    kw = dict(alpha=(1.2, 1.0, 0.8), iterations=LEVEL_ITERATIONS,
              update_lag=3, a_data=np.array([0.45]), hx=1.0, hy=1.0, hz=1.0)

    def single(a_smooth, **over):
        k = dict(kw, **over)
        return compute_flow_level(J, weight, u, v, w, k["alpha"],
                                  k["iterations"], k["update_lag"],
                                  k["a_data"], a_smooth, 1.0, 1.0, 1.0)

    for a_smooth in (1.0, 0.5):
        out = {tag: compute_flow_level_sharded(J, weight, u, v, w,
                                               devices=devs,
                                               a_smooth=a_smooth,
                                               use_kernels=uk, **kw)
               for tag, devs, uk in (("kernel", devices, True),
                                     ("plain", devices, False),
                                     ("one slab", devices[:1], True))}
        same = {tag: all(torch.equal(a, b)
                         for a, b in zip(out["kernel"], out[tag]))
                for tag in ("plain", "one slab")}
        check(all(same.values()), f"sharded level solve (a_smooth "
              f"{a_smooth}): bit-identical to plain / one slab {same}")
        layout = f"10b level {shape} over {[str(d) for d in devices]}"
        if a_smooth != 1.0:
            err = excess(out["kernel"], single(a_smooth))
            log(f"  {layout}, a_smooth {a_smooth}: bit-identical to plain "
                f"and to one slab {same}; against the single-device solve "
                f"max(|sharded - single| - 5e-4 |single|) {err:.3e}")
            check(err <= 5e-4, f"sharded level solve {err} beyond 5e-4 of "
                  f"the single-device solve (a_smooth {a_smooth})")
            continue
        err_u = excess(out["kernel"], unfolded_level(J, weight, u, v, w,
                                                     **kw))
        one = dict(iterations=kw["update_lag"])
        err_1 = excess(compute_flow_level_sharded(
            J, weight, u, v, w, devices=devices, a_smooth=1.0,
            **dict(kw, **one)), single(1.0, **one))
        folded = single(1.0)
        gap = max(float((a - b).abs().max())
                  for a, b in zip(out["kernel"], folded))
        top = max(float(b.abs().max()) for b in folded)
        log(f"  {layout}, a_smooth 1.0: bit-identical to plain and to one "
            f"slab {same}; max(|sharded - single| - 5e-4 |single|): "
            f"{err_u:.3e} against the plain single-device unfolded solve, "
            f"{err_1:.3e} against compute_flow_level (folded) over one "
            f"tick block ({kw['update_lag']} iterations); folded vs "
            f"unfolded after {kw['iterations']} iterations max |diff| "
            f"{gap:.3e} (<= {FOLD_GAP}; max |single| {top:.3f})")
        check(err_u <= 5e-4 and err_1 <= 5e-4,
              f"sharded level solve (a_smooth 1) beyond 5e-4 of the "
              f"single-device solves: unfolded {err_u}, folded over one "
              f"tick block {err_1}")
        check(gap <= FOLD_GAP, f"sharded level solve (a_smooth 1): folded "
              f"vs unfolded gap {gap} beyond {FOLD_GAP}")
    for a_smooth in (1.0, 0.5):
        key = tsp.level_config_key(shape, 1, kw["alpha"], kw["iterations"],
                                   kw["update_lag"], kw["a_data"], a_smooth,
                                   1.0, 1.0, 1.0, torch.float32, True)
        body = tsp.build_level_sharded(key, devices)
        graph_against_eager(
            f"10b sharded level graph {shape} a_smooth {a_smooth} over "
            f"{[str(d) for d in devices]}", card,
            lambda: tsp.compute_flow_level_sharded(
                J, weight, u, v, w, devices=devices, a_smooth=a_smooth,
                **kw),
            lambda: body(J, weight, u, v, w), "sharded_level", devices)
        Jc, wc = [j.movedim(-1, 0) for j in J], weight.movedim(-1, 0)
        graph_against_eager(
            f"10b compute_flow_level graph {shape} a_smooth {a_smooth}", card,
            lambda: single(a_smooth),
            lambda: solve_level_cl(Jc, wc, u, v, w, kw["alpha"],
                                   kw["iterations"], kw["update_lag"],
                                   kw["a_data"], a_smooth, 1.0, 1.0, 1.0),
            "level", [dev])


def spatial_expected(params, n, shape):
    """Host launches of one sharded step over n shards (with the raw
    frame's warp): sharded levels launch a kernel a shard, the replicated
    ones as the single-device pyramid."""
    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.core.solver import _blocks

    plan, _, _ = level_schedule(shape, params["eta"], params["levels"],
                                params["min_level"])
    e = dict.fromkeys(KERNEL_SYMBOLS, 0)
    it = params["iterations"]
    for _, size, _ in plan:
        sharded = size[0] >= 4 * n
        mult = n if sharded else 1
        if params["a_smooth"] != 1.0 and sharded:
            e["psi_field_f32"] += n * it
            e["sor_halfsweep_psi_f32"] += 2 * n * it
        elif params["a_smooth"] != 1.0:
            e["sor_iterations_psi_f32"] += len(_blocks(it,
                                                       params["update_lag"]))
        elif sharded:
            e["sor_halfsweep_const_f32"] += 2 * n * it
        else:
            e["sor_iterations_f32"] += len(_blocks(it, params["update_lag"]))
        e["map_coords_f32"] += mult
        e["median5_f32"] += mult * (min(size) > 5)
    e["map_coords_f32"] += 1
    return e


def sharded_step(fixed_t, moving_t, params, devices, use_kernels):
    """One sharded motion-correction step: the flow from
    get_displacement_sharded, then the raw frame's cubic warp."""
    import torch

    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch.parallel.spatial_pyramid import (
        get_displacement_sharded)

    flow, valid = get_displacement_sharded(fixed_t, moving_t,
                                           devices=devices,
                                           use_kernels=use_kernels, **params)
    reg = ft.imregister_wrapper(moving_t, flow[..., 0], flow[..., 1],
                                flow[..., 2], fixed_t, "cubic",
                                device=fixed_t.device,
                                use_kernels=use_kernels)
    torch.cuda.synchronize()
    return flow, reg, bool(valid)


def sharded_graph_against_eager(card, fixed_t, moving_t, params, devices,
                                tag, calls=True):
    """get_displacement_sharded's graph against the eager sharded body
    (``build_sharded_pyramid``) it captures, timed as steps with the raw
    frame's cubic warp (``graph_against_eager``). First, from an empty
    cache, the eager body's peak allocation and peak reservation on each
    card beyond what it started with; after, the bytes of the graph's
    static input and output buffers (all on the first card). Returns
    ``graph_against_eager``'s numbers with those."""
    import torch

    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch.core.pyramid import pyramid_config_key
    from flowreg3d_tpu_torch.parallel import executors as tex
    from flowreg3d_tpu_torch.parallel import spatial_pyramid as tsp

    f, m = ((x[..., None] if x.dim() == 3 else x) for x in (fixed_t,
                                                           moving_t))
    shape, C = tuple(f.shape[:3]), f.shape[-1]
    body = tsp.build_sharded_pyramid(
        pyramid_config_key(shape, C, **params), devices)
    zeros = torch.zeros(shape + (3,), device=f.device)
    vec = torch.full((C,), 1.0 / C, device=f.device)

    def warp(out):
        flow = out[0]
        return ft.imregister_wrapper(moving_t, flow[..., 0], flow[..., 1],
                                     flow[..., 2], fixed_t, "cubic",
                                     device=fixed_t.device)

    devs = list(dict.fromkeys(devices))
    tex.clear_frame_graphs()
    sync(devs)
    torch.cuda.empty_cache()
    start = {d: (torch.cuda.memory_allocated(d),
                 torch.cuda.memory_reserved(d)) for d in devs}
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    out = body(f, m, zeros, vec)
    sync(devs)
    peak = {str(d): round((torch.cuda.max_memory_allocated(d) - start[d][0])
                          / 2**30, 3) for d in devs}
    peak_reserved = {str(d): round((torch.cuda.max_memory_reserved(d)
                                    - start[d][1]) / 2**30, 3) for d in devs}
    del out
    timed = graph_against_eager(
        tag, card,
        lambda: tsp.get_displacement_sharded(fixed_t, moving_t,
                                             devices=devices, **params),
        lambda: body(f, m, zeros, vec), "sharded", devices,
        finish=warp, n=3, calls=calls)
    (graph,) = tex.graphs("sharded")
    static = sum(x.nbytes for x in list(graph.inputs) + list(graph.outputs))
    timed.update(eager_peak_gib=peak, static_gib=round(static / 2**30, 3))
    log(f"  {tag}: the eager body's peak allocation {peak} GiB a card, peak "
        f"reservation {peak_reserved} GiB; the graph holds {timed['held_gib']} GiB reserved a card, of which its "
        f"static input and output buffers {timed['static_gib']} GiB on "
        f"{devices[0]}; card {card}")
    return timed


# input scalings by one ulp either way: the single-device path on them
# shows the spread rounding alone gives in a regime
SCALES = (1.0 + 2.0 ** -22, 1.0 - 2.0 ** -23)
# the least agreement in dB a sharded registration may reach against the
# single-device one, whatever the spread, set for SHAPE: a registration that
# failed (the unregistered volume, logged beside it) stays below
AGREEMENT_FLOOR_DB = 28.5
# the largest EPE of the convergent pair's sharded flow, whatever the spread
# (its zero flow is logged beside it)
CONVERGENT_EPE_CAP = 0.5
# the largest mean EPE (voxels) of the sharded flow against the
# single-device flow when every level runs one tick block (iterations =
# update_lag), the accuracy gate's EPE: the data term is linearised once a
# level, so rounding is barely amplified, and a wrong exchange or slab
# parity moves the flow by voxels
ONE_BLOCK_EPE = 0.25


def agreement_bar(spread_db):
    """The agreement in dB a sharded result must reach against the
    single-device one: the accuracy gate's 40 dB, or, where the
    single-device path itself moves further than that when its input is
    scaled by one of ``SCALES`` (an a_smooth 1 regime amplifying rounding;
    ``spread_db`` the least agreement of those), that spread less 1 dB, and
    never below ``AGREEMENT_FLOOR_DB``."""
    return max(AGREEMENT_FLOOR_DB, min(40.0, spread_db - 1.0))


def one_block_epe(fixed_t, moving_t, params, devices):
    """The canonical pair with every level at one tick block: mean EPE of
    the sharded flow against the single-device flow, and of the
    single-device flow on the input scaled by ``SCALES[0]`` (the spread)."""
    import torch

    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch.parallel.spatial_pyramid import (
        get_displacement_sharded)

    one = dict(params, iterations=params["update_lag"])
    flow_s = ft.get_displacement(fixed_t, moving_t, device=fixed_t.device,
                                 **one)
    flow_e = ft.get_displacement(fixed_t * SCALES[0], moving_t * SCALES[0],
                                 device=fixed_t.device, **one)
    flow_k, _ = get_displacement_sharded(fixed_t, moving_t, devices=devices,
                                         **one)

    def epe(f):
        return float(torch.linalg.vector_norm(f - flow_s, dim=-1).mean())

    return epe(flow_k), epe(flow_e)


def phase_spatial_step(card, dev, devices, tag, params, fixed_t, moving_t):
    """10c: get_displacement_sharded + the raw warp on the canonical pair
    over ``devices``: kernels against plain bit-identical, valid, the
    registered volume against the single-device step's at the bar of
    ``agreement_bar`` (the spread: the single-device step on the input
    scaled by ``SCALES``, its flow warping the same moving volume); with
    one tick block a level, the flow within ``ONE_BLOCK_EPE`` of the
    single-device flow; launches, exchange copies, warm ms and peak memory
    beside the single-device step's; the sharded graph against its eager
    body (``sharded_graph_against_eager``, also at C = 2 at a_smooth 0.5).
    Returns (host launches, launches replayed, warm graph ms)."""
    import torch

    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch.parallel import executors as tex
    from flowreg3d_tpu_torch.parallel.mesh import peer_copy

    layout = [str(d) for d in devices]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    flow_s, reg_s = run_step(fixed_t, moving_t, params, True)
    mem_single = torch.cuda.max_memory_allocated(dev) - base_mem
    spreads = []
    for scale in SCALES:
        flow_e, _ = run_step(fixed_t * scale, moving_t * scale, params, True)
        reg_e = ft.imregister_wrapper(moving_t, flow_e[..., 0],
                                      flow_e[..., 1], flow_e[..., 2],
                                      fixed_t, "cubic", device=dev)
        spreads.append(psnr(reg_s.cpu().numpy(), reg_e.cpu().numpy()))
    spread = min(spreads)
    del flow_s, flow_e, reg_e
    tex.clear_frame_graphs()
    expected = spatial_expected(params, len(devices), SHAPE)
    reset_counts()
    copies = peer_copy.copies
    t = time.perf_counter()
    flow_k, reg_k, valid_k = sharded_step(fixed_t, moving_t, params, devices,
                                          True)
    first_s = time.perf_counter() - t
    launches = read_counts()
    copies = peer_copy.copies - copies
    # the host launches are the capture's warm eager run and the raw warp;
    # the flow came from one replay of the sharded graph
    (graph,) = tex.graphs("sharded")
    want = {k: v - (k == "map_coords_f32") for k, v in expected.items()}
    want = {k: v for k, v in want.items() if v}
    check(graph.replays == 1 and graph.launches == want and graph.copies
          == copies, f"10c {tag}: the graph holds {graph.launches} and "
          f"{graph.copies} copies and ran {graph.replays} replays; want "
          f"{want}, {copies}, 1")
    del graph
    t = time.perf_counter()
    flow_p, reg_p, valid_p = sharded_step(fixed_t, moving_t, params, devices,
                                          False)
    plain_s = time.perf_counter() - t
    same = bool(torch.equal(flow_k, flow_p) and torch.equal(reg_k, reg_p))
    agree = psnr(reg_s.cpu().numpy(), reg_k.cpu().numpy())
    del flow_p, reg_p
    runs = {}
    for C in ((1, 2) if params["a_smooth"] != 1.0 else (1,)):
        f, m = ((fixed_t, moving_t) if C == 1
                else (two_channels(fixed_t), two_channels(moving_t)))
        runs[C] = sharded_graph_against_eager(card, f, m, params, devices,
                                              f"10c {tag} C={C} over "
                                              f"{layout}", calls=C == 1)
        del f, m
    ms = runs[1]["graph_ms"]
    bar = agreement_bar(spread)
    unregistered = psnr(reg_s.cpu().numpy(), moving_t.cpu().numpy())
    epe_1, epe_1e = one_block_epe(fixed_t, moving_t, params, devices)
    log(f"  10c {tag} over {layout}: valid {valid_k}/{valid_p}; kernels vs "
        f"plain bit-identical {same}; registered vs the single-device step "
        f"{agree:.2f} dB (>= {bar:.2f}; the single-device step on input "
        f"scaled by {SCALES}: {[round(x, 2) for x in spreads]} dB; the "
        f"unregistered volume {unregistered:.2f} dB); one tick block a "
        f"level: flow EPE against the single-device flow {epe_1:.4f} (<= "
        f"{ONE_BLOCK_EPE}; the single-device flow on input scaled by "
        f"{SCALES[0]}: {epe_1e:.4f}); "
        f"launches {launches} "
        f"(expected "
        f"{expected}); exchange copies {copies}; first call {first_s:.2f} "
        f"s, plain {plain_s:.2f} s, warm {ms:.1f} ms a frame replayed "
        f"against {runs[1]['eager_ms']:.1f} eager; peak memory a card of "
        f"the eager sharded body {runs[1]['eager_peak_gib']} GiB, the graph "
        f"holds {runs[1]['held_gib']} GiB reserved, against "
        f"{mem_single / 2**30:.2f} GiB on {dev} for the single-device step"
        + (" (all slabs on this one card)"
           if len(set(devices)) == 1 else "") + f"; card {card}")
    check(valid_k and valid_p, f"10c {tag}: valid {valid_k} {valid_p}")
    check(same, f"10c {tag}: kernels vs plain not bit-identical")
    check(agree >= bar, f"10c {tag}: {agree} dB against the single-device "
          f"step, bar {bar} (spread {spread} dB)")
    check(epe_1 <= ONE_BLOCK_EPE, f"10c {tag}: one tick block a level, flow "
          f"EPE {epe_1} against the single-device flow beyond "
          f"{ONE_BLOCK_EPE}")
    check(launches == expected, f"10c {tag}: launches {launches} != "
          f"{expected}")
    return launches, runs[1]["replayed"], ms


def phase_spatial_convergent(card, dev, devices):
    """10c: the convergent pair of phase 4, sharded against the
    single-device flow, on the accuracy gate (EPE <= 0.25, >= 40 dB), or,
    where the single-device step on input scaled by ``SCALES`` moves
    further than the gate, within that spread (EPE 1.25 times, 1 dB), at
    most ``CONVERGENT_EPE_CAP`` and at least ``AGREEMENT_FLOOR_DB``; the
    sharded graph against its eager body."""
    import torch

    import flowreg3d_tpu_torch as ft

    fixed, moving = make_pair(CONV_SHAPE, n_blobs=3000, seed=2,
                              shift=CONV_SHIFT)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev) for a in (fixed, moving))
    flow_s, reg_s = run_step(fixed_t, moving_t, CONVERGENT, True)
    flow_k, reg_k, valid = sharded_step(fixed_t, moving_t, CONVERGENT,
                                        devices, True)
    b = CONV_SHAPE[0] // 4
    crop = (slice(b, -b),) * 3

    def epe_db(flow, reg):
        return (float(torch.linalg.vector_norm(flow[crop] - flow_s[crop],
                                               dim=-1).mean()),
                psnr(reg_s[crop].cpu().numpy(), reg[crop].cpu().numpy()))

    epe, agree = epe_db(flow_k, reg_k)
    # the replayed flow against the eager sharded body, bit for bit
    sharded_graph_against_eager(
        card, fixed_t, moving_t, CONVERGENT, devices,
        f"10c convergent {CONV_SHAPE} over {[str(d) for d in devices]}",
        calls=False)
    spreads = []
    for scale in SCALES:
        flow_e, _ = run_step(fixed_t * scale, moving_t * scale, CONVERGENT,
                             True)
        spreads.append(epe_db(flow_e, ft.imregister_wrapper(
            moving_t, flow_e[..., 0], flow_e[..., 1], flow_e[..., 2],
            fixed_t, "cubic", device=dev)))
    epe_e = max(e for e, _ in spreads)
    spread = min(d for _, d in spreads)
    epe_bar = min(CONVERGENT_EPE_CAP, max(0.25, 1.25 * epe_e))
    bar = agreement_bar(spread)
    zero = epe_db(torch.zeros_like(flow_s), moving_t)
    log(f"  10c convergent {CONV_SHAPE} over {[str(d) for d in devices]}: "
        f"valid {valid}; sharded vs single-device flow EPE {epe:.4f} (<= "
        f"{epe_bar:.4f}), registered {agree:.2f} dB (>= {bar:.2f}); the "
        f"single-device step on input scaled by {SCALES}: (EPE, dB) "
        f"{[(round(e, 4), round(d, 2)) for e, d in spreads]}; zero flow "
        f"(EPE, dB) ({zero[0]:.4f}, {zero[1]:.2f})")
    check(valid and epe <= epe_bar and agree >= bar,
          f"10c convergent: valid {valid}, EPE {epe} (bar {epe_bar}), "
          f"{agree} dB (bar {bar})")


def phase_multi_pipelines(card, dev, fixed, mesh_devices, spatial_devices):
    """10d: compensate_arr_3D at OFOptions() defaults through the mesh
    executor (phase 6b's T=4 recording; resident and host-staged; bit-
    identical to the batched executor) and the spatial executor
    (``phase_spatial_pipeline``). Returns (mesh host launches, mesh
    replays, spatial host launches, spatial replays)."""
    from flowreg3d_tpu_torch.parallel import executors as tex

    frames = recording(fixed, PIPELINE_T)
    tex.clear_frame_graphs()
    # batched named: on several cards the default config is the mesh
    batched = dict(parallelization="batched")
    reg_b, flows_b, _, _ = run_pipeline(frames, fixed, True, dev, True,
                                        **batched)
    mesh_cfg = dict(parallelization="mesh", devices=mesh_devices)
    tex.clear_frame_graphs()
    reset_counts()
    reg_m, flows_m, first_s, info = run_pipeline(frames, fixed, True, dev,
                                                 True, **mesh_cfg)
    launches = read_counts()
    graphs = tex.frame_graphs()
    reps = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for g in graphs:
        for k, v in replayed(g).items():
            reps[k] += v
    same = bool(np.array_equal(reg_m, reg_b)
                and np.array_equal(flows_m, flows_b))
    reg_h, flows_h, _, info_h = run_pipeline(frames, fixed, True, dev, True,
                                             device_resident=False,
                                             **mesh_cfg)
    same_h = bool(np.array_equal(reg_h, reg_b)
                  and np.array_equal(flows_h, flows_b))
    _, _, warm_s, _ = run_pipeline(frames, fixed, True, dev, True,
                                   **mesh_cfg)
    layout = sorted({str(g.device) for g in graphs})
    log(f"  10d mesh pipeline over {mesh_devices or 'every card'} "
        f"(graphs on {layout}), T={PIPELINE_T} at OFOptions() defaults: ran "
        f"{info}, host-staged ran {info_h}; bit-identical to batched: "
        f"resident {same}, host-staged {same_h}; host launches {launches}, "
        f"replays ran {reps}; first {first_s:.2f} s, warm {warm_s:.3f} s, "
        f"{PIPELINE_T / warm_s:.4f} volumes/s; card {card}")
    check(info == dict(resident=True, executor="mesh")
          and info_h == dict(resident=False, executor="mesh"),
          f"10d mesh ran {info} / {info_h}")
    check(same and same_h, "10d: the mesh pipeline is not bit-identical to "
          "batched")
    tex.clear_frame_graphs()
    return (launches, reps) + phase_spatial_pipeline(card, dev, fixed,
                                                     spatial_devices)


def phase_spatial_pipeline(card, dev, fixed, spatial_devices):
    """10d: compensate_arr_3D at OFOptions() defaults through the spatial
    executor over ``spatial_devices`` on the first T=2 frames of phase 6b's
    recording: registered volumes against batched at ``agreement_bar`` of
    batched on the frames scaled by ``SCALES``, the frames solved on one
    device counted, one replay of its frame graph a frame. Returns (host
    launches, replays)."""
    from flowreg3d_tpu_torch.parallel import executors as tex

    batched = dict(parallelization="batched")
    t2 = recording(fixed, PIPELINE_T)[:2]
    reg_b2, _, _, _ = run_pipeline(t2, fixed, True, dev, True, **batched)
    spread = min(psnr(a, b) for scale in SCALES for a, b in zip(
        reg_b2, run_pipeline(t2 * np.float32(scale), fixed, True, dev,
                             True, **batched)[0]))
    bar = agreement_bar(spread)
    tex.clear_frame_graphs()
    stats = {}
    reset_counts()
    reg_sp, flows_sp, s_sp, info_sp = run_pipeline(
        t2, fixed, True, dev, True, stats=stats, parallelization="spatial",
        devices=spatial_devices)
    sp_launches = read_counts()
    (graph,) = tex.graphs("sharded")
    sp_reps = replayed(graph)
    # one replay a frame: the initial-w pass's frames and the recording's
    check(graph.replays == 2 * len(t2), f"10d spatial: {graph.replays} "
          f"replays of its frame graph, {len(t2)} frames")
    del graph
    agree = [psnr(a, b) for a, b in zip(reg_b2, reg_sp)]
    single = stats["executor_info"]["single_device_frames"]
    log(f"  10d spatial pipeline over {[str(d) for d in spatial_devices]}, "
        f"T=2 at OFOptions() defaults: ran {info_sp} in {s_sp:.2f} s; "
        f"registered vs batched {[round(a, 2) for a in agree]} dB (>= "
        f"{bar:.2f}; batched on frames scaled by {SCALES}: at least "
        f"{spread:.2f} dB); frames solved on one device {single}; host "
        f"launches {sp_launches} (the capture's warm frame), replays ran "
        f"{sp_reps} (one frame graph replay a frame, the initial-w pass's "
        f"and the recording's)")
    check(info_sp["executor"] == "spatial" and not info_sp["resident"],
          f"10d spatial ran {info_sp}")
    check(min(agree) >= bar, f"10d spatial: {agree} dB against batched, bar "
          f"{bar} (spread {spread} dB)")
    check(np.isfinite(flows_sp).all(), "10d spatial: non-finite flows")
    tex.clear_frame_graphs()
    return sp_launches, sp_reps


def phase_mesh_long(card, dev, fixed, n_frames=24):
    """10e, on more than one card: phase 6c's T=24 u16 recording at
    OFOptions() defaults through the default config (the mesh over every
    card) against the batched executor on one card: bit-identical, warm
    volumes/s of each (the first run of each captures its graphs), and the
    two executors alone. Returns {config: warm volumes/s}."""
    import torch

    from flowreg3d_tpu_torch.parallel import executors as tex
    from flowreg3d_tpu_torch.pipeline import OFOptions
    from flowreg3d_tpu_torch.pipeline.device_pipeline import preprocess

    o = OFOptions()
    frames = np.clip(np.rint(recording(fixed, n_frames, period=PIPELINE_T)
                             * 10000), 0, 65535).astype(np.uint16)
    reference = fixed * 10000.0
    out, vols = {}, {}
    for tag, config in (("batched", dict(parallelization="batched")),
                        ("default", {})):
        tex.clear_frame_graphs()
        reg, _, first_s, info = run_pipeline(frames, reference, True, dev,
                                             options=o, **config)
        times = [run_pipeline(frames, reference, True, dev, options=o,
                              **config)[2] for _ in range(2)]
        out[tag], vols[tag] = (reg, info), n_frames / min(times)
        log(f"  10e T={n_frames} u16 recording, {tag} config: ran {info}; "
            f"first {first_s:.2f} s, warm {[round(t, 3) for t in times]} s, "
            f"{vols[tag]:.4f} volumes/s; card {card}")
        del reg
    # the executors alone on 8 float frames, warm (no upload, download or
    # preprocessing): how far the frames themselves run side by side
    raw = torch.from_numpy(recording(fixed, 8, period=PIPELINE_T)[..., None]
                           ).to(dev)
    ref_raw = torch.from_numpy(fixed[..., None]).to(dev)
    proc, ref_proc = preprocess(raw, o, ref_raw), preprocess(ref_raw, o)
    w_init = torch.zeros(SHAPE + (3,), device=dev)
    ms = {}
    for name in ("batched", "mesh"):
        ex = tex.get_executor(name, device=dev)
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ex.process_batch(raw, proc, ref_raw, ref_proc, w_init,
                             interpolation_method="cubic",
                             flow_params=o.to_dict())
            torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t) / raw.shape[0]
    del raw, proc
    tex.clear_frame_graphs()
    same = bool(np.array_equal(out["batched"][0], out["default"][0]))
    log(f"  10e mesh over every card against batched on {dev}: "
        f"bit-identical {same}; {vols['default'] / vols['batched']:.3f} "
        f"times the volumes/s; the executors alone on 8 frames, warm ms a "
        f"frame {ms}; card {card}")
    check(out["default"][1] == dict(resident=True, executor="mesh"),
          f"10e: the default config ran {out['default'][1]}")
    check(same, "10e: the mesh over every card is not bit-identical to "
          "batched")
    return vols


def _probe_toy(x, d1, copy):
    """The probe's program: a kernel on x's card, a copy to card ``d1``, a
    kernel there, a copy back, a kernel on x's card."""
    import torch

    a = torch.sin(x) * 2.0 + 1.0
    b = copy(torch.empty_like(a, device=d1), a)
    c = torch.cos(b) * b
    back = copy(torch.empty_like(c, device=x.device), c)
    return back + x


def graph_probe(n=1 << 22, n_replays=5):
    """10f, on two cards: whether one CUDA graph can span them, on a toy
    program (``_probe_toy``) replayed ``n_replays`` times on fresh inputs
    against its eager run, with eager tensors allocated on card 1 between
    the capture and the replays (a replay that wrote into blocks the
    allocator handed out again would change them). The graph is
    ``_graph.BodyGraph`` itself: capture on card 0, card 1's work on a
    stream forked from the capture and joined back by events, its
    allocations in a MemPool the graph holds. Fails unless every replay is
    bit-equal and the eager tensors are untouched."""
    import torch

    from flowreg3d_tpu_torch import _graph
    from flowreg3d_tpu_torch.parallel.mesh import peer_copy

    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    gen = torch.Generator(device=d0).manual_seed(11)
    inputs = [torch.randn(n, generator=gen, device=d0)
              for _ in range(n_replays)]
    graph = _graph.BodyGraph(lambda x: (_probe_toy(x, d1, peer_copy),),
                             [((n,), torch.float32)], d0, [d0, d1])
    keep, diffs = None, []
    for x in inputs:
        (got,) = graph.run(x)
        if keep is None:
            keep = [torch.full((n,), 7.0, device=d1) for _ in range(8)]
        sync([d0, d1])
        want = _probe_toy(x, d1, peer_copy)
        diffs.append(float((got - want).abs().max()))
    kept = all(bool((k == 7.0).all()) for k in keep)
    log(f"  10f one graph across two cards (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, peer access "
        f"{torch.cuda.can_device_access_peer(0, 1)}): {graph.replays} "
        f"replays bit-equal {max(diffs) == 0.0} (max|diff| {max(diffs)}), "
        f"eager tensors on card 1 untouched {kept}")
    check(max(diffs) == 0.0 and kept, f"10f: one graph across two cards, "
          f"max|diff| {max(diffs)}, eager tensors untouched {kept}")


def phase_across_cards(card, dev):
    """Phase 10's sharded paths on every card alone (the four-card call):
    the two-card graph probe (10f), then over one shard a card the sharded
    level solve (10b), the sharded step at both option sets (10c: each
    graph against its eager body and the single-device step, the eager
    peak and the graph's memory a card) and the spatial executor's T=2
    pipeline (10d: one frame graph replay a frame, against batched).
    Returns {tag: warm graph ms}."""
    import torch

    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    log(f"phase 10 across cards: {[str(d) for d in devices]}")
    graph_probe()
    phase_level_sharded(card, dev, devices)
    fixed, moving = make_pair(SHAPE)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev) for a in (fixed, moving))
    out = {tag: phase_spatial_step(card, dev, devices, tag, params, fixed_t,
                                   moving_t)[2]
           for tag, params in (("spatial", DIRECT_DEFAULTS),
                               ("spatial_defaults", CANONICAL))}
    phase_spatial_pipeline(card, dev, fixed, devices)
    return out


def phase_multi_gpu(card, dev, fixed):
    """Phase 10: the multi-GPU execution paths. One card: the mesh executor
    over [cuda:0] and the Z-sharded paths over [cuda:0, cuda:0] (two shards
    of one card); more cards: the same, then both over every card, one
    shard each, and the T=24 recording through the mesh (10e). Returns (timing rows of the slab kernels, counts, replays,
    summary)."""
    import torch

    n_cards = torch.cuda.device_count()
    pair = [dev, dev]
    layouts = [(None if n_cards == 1 else [dev], pair)]
    if n_cards > 1:
        layouts.append((None, [torch.device("cuda", i)
                               for i in range(n_cards)]))
    log(f"phase 10: multi-GPU execution on {n_cards} card(s); layouts "
        f"(mesh, spatial): "
        f"{[(m or 'every card', [str(d) for d in s]) for m, s in layouts]}; "
        f"the sharded paths replay one graph a layout, across its cards")
    if n_cards > 1:
        graph_probe()
    timed = phase_slab_kernels(card, dev)
    fixed_np, moving_np = make_pair(SHAPE)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev)
                         for a in (fixed_np, moving_np))
    counts, replays, summary = {}, {}, {}
    for i, (mesh_devices, spatial_devs) in enumerate(layouts):
        sfx = "" if i == 0 else "_all_cards"
        phase_level_sharded(card, dev, spatial_devs)
        for tag, params in (("spatial", DIRECT_DEFAULTS),
                            ("spatial_defaults", CANONICAL)):
            (counts[tag + sfx], replays[tag + sfx],
             summary[tag + sfx + "_ms"]) = phase_spatial_step(
                card, dev, spatial_devs, tag, params, fixed_t, moving_t)
        phase_spatial_convergent(card, dev, spatial_devs)
        (counts["mesh" + sfx], replays["mesh" + sfx],
         counts["spatial_pipeline" + sfx],
         replays["spatial_pipeline" + sfx]) = phase_multi_pipelines(
            card, dev, fixed, mesh_devices, spatial_devs)
    if n_cards > 1:
        summary["mesh_T24_volumes_per_s"] = phase_mesh_long(card, dev, fixed)
    return timed, counts, replays, summary


# the reference example harness's flow parameters
# (examples/motion_correct_3d_test.py FLOW_PARAMS)
HARNESS_PARAMS = dict(alpha=(0.25, 0.25, 0.25), iterations=100, a_data=0.45,
                      a_smooth=1.0, levels=50, eta=0.8, update_lag=5,
                      min_level=5, const_assumption="gc")
HARNESS_BOUNDARY = 10
BACKEND_T = 2
SPLAT_CROP = (slice(24, 40), slice(192, 320), slice(192, 320))  # 16x128x128
BACKEND_CROP = (slice(24, 40), slice(192, 256), slice(192, 256))  # 16x64x64
PLANE = (512, 512)
COMPARE_ITERATIONS = 20     # compute_flow card vs CPU, before divergence


def harness_preprocess(f1, f2):
    """The example harness's sigma-0.5 Gaussian, then both normalised by
    f1's range, on the card (the port's Gaussian: scipy's 'reflect')."""
    import torch

    from flowreg3d_tpu_torch.ops.filters import gaussian_filter_3d

    f1, f2 = (gaussian_filter_3d(f, (0.5, 0.5, 0.5)) for f in (f1, f2))
    lo, hi = f1.min(), f1.max()
    rng = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    return (f1 - lo) / rng, (f2 - lo) / rng


def phase_harness(card, dev, fixed):
    """Phase 11a: the reference's example harness at full width: fix_seed,
    the low_disp ground-truth flow (host numpy), the forward splat on the
    card (held to the CPU splat on a crop), a 10-voxel crop, the flow at the
    harness's parameters with kernels and plain, the cubic warp, EPE and
    the improvement ratio. Returns (launches, the displaced volume, the
    ground-truth flow)."""
    import torch

    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.core.solver import _blocks
    from flowreg3d_tpu_torch.motion_generation import (
        evaluate_flow_accuracy, get_low_disp_3d_generator, improvement_ratio,
        warp_volume_splat3d)
    from flowreg3d_tpu_torch.util import fix_seed

    log(f"phase 11a: the example harness (motion_correct_3d_test) at {SHAPE}:"
        " low_disp flow, splat on the card, flow at its FLOW_PARAMS")
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        fix_seed(1)
        t = time.perf_counter()
        flow_gt, invalid = get_low_disp_3d_generator()(
            depth=SHAPE[0], height=SHAPE[1], width=SHAPE[2], rng=1)
        gen_s = time.perf_counter() - t
        t = time.perf_counter()
        displaced = warp_volume_splat3d(fixed, flow_gt, device=dev)
        splat_s = time.perf_counter() - t
        check(displaced.shape == fixed.shape and displaced.dtype == np.float32
              and np.isfinite(displaced).all(), "splat output")
        crop_card = warp_volume_splat3d(fixed[SPLAT_CROP],
                                        flow_gt[SPLAT_CROP], device=dev)
        crop_cpu = warp_volume_splat3d(fixed[SPLAT_CROP], flow_gt[SPLAT_CROP],
                                       device="cpu")
        d_splat = float(np.abs(crop_card - crop_cpu).max())
        log(f"  low_disp flow {gen_s:.2f} s on the host (max |flow| "
            f"{np.abs(flow_gt).max(axis=(0, 1, 2)).tolist()}, invalid "
            f"{invalid.mean():.4f}); splat on the card {splat_s:.2f} s "
            f"(numpy in and out); card vs CPU splat on a 16x128x128 crop: "
            f"max diff {d_splat:.3e} (<= 1e-6)")
        check(d_splat <= 1e-6, f"splat card vs CPU {d_splat}")

        b = HARNESS_BOUNDARY
        sl = (slice(b, -b),) * 3
        original_c, displaced_c, flow_gt_c = (np.ascontiguousarray(a[sl])
                                              for a in (fixed, displaced,
                                                        flow_gt))
        shape = original_c.shape
        orig_t, disp_t = (torch.from_numpy(a).to(dev)
                          for a in (original_c, displaced_c))
        f1, f2 = harness_preprocess(orig_t, disp_t)
        plan, _, _ = level_schedule(shape, HARNESS_PARAMS["eta"],
                                    HARNESS_PARAMS["levels"],
                                    HARNESS_PARAMS["min_level"])
        expected = {
            "sor_iterations_f32": len(plan) * len(_blocks(
                HARNESS_PARAMS["iterations"], HARNESS_PARAMS["update_lag"])),
            "map_coords_f32": len(plan) + 1,
            "median5_f32": sum(min(size) > 5 for _, size, _ in plan),
        }
        out = {}
        for tag, uk in (("kernel", True), ("plain", False)):
            reset_counts()
            t = time.perf_counter()
            flow = ft.get_displacement(f1, f2, device=dev, use_kernels=uk,
                                       **HARNESS_PARAMS)
            corrected = ft.imregister_wrapper(
                disp_t, flow[..., 0], flow[..., 1], flow[..., 2], orig_t,
                "cubic", device=dev, use_kernels=uk)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            launches = read_counts()
            flow_np, corr_np = flow.cpu().numpy(), corrected.cpu().numpy()
            check(flow_np.shape == shape + (3,) and np.isfinite(flow_np).all()
                  and np.isfinite(corr_np).all(), f"{tag}: harness output")
            eval_b = min(8, min(shape) // 4)
            out[tag] = dict(
                seconds=seconds, launches=launches, flow=flow_np,
                corrected=corr_np,
                epe=evaluate_flow_accuracy(flow_np, flow_gt_c,
                                           boundary=eval_b),
                ratio=improvement_ratio(original_c, displaced_c, corr_np),
                psnr=psnr(original_c, corr_np))
        k, p = out["kernel"], out["plain"]
        same = bool(np.array_equal(k["flow"], p["flow"])
                    and np.array_equal(k["corrected"], p["corrected"]))
        log(f"  cropped {shape}, {len(plan)} levels; kernel run "
            f"{k['seconds']:.2f} s, launches {k['launches']} (expected "
            f"{expected}); plain run {p['seconds']:.2f} s; EPE kernel "
            f"{k['epe']:.4f} px, plain {p['epe']:.4f} px; MAE improvement "
            f"ratio kernel {k['ratio']:.4f}x, plain {p['ratio']:.4f}x; PSNR "
            f"{k['psnr']:.3f} / {p['psnr']:.3f} dB; bit-identical {same}; "
            f"card {card}")
        for name, n in expected.items():
            check(k["launches"][name] == n,
                  f"harness {name}: {k['launches'][name]} launches, "
                  f"expected {n}")
        check(same or (abs(k["psnr"] - p["psnr"]) <= 0.5
                       and abs(k["ratio"] - p["ratio"])
                       <= 0.02 * p["ratio"]),
              "harness: kernel and plain differ beyond 0.5 dB / 2%")
        check(k["ratio"] > 1 and p["ratio"] > 1,
              f"harness: no improvement ({k['ratio']}, {p['ratio']})")
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    return k["launches"], displaced, flow_gt


def scripted_conv(path, seed=0):
    """A TorchScript Conv3d(2, 3, 3, padding=1) with seeded weights: a
    stand-in checkpoint with volRAFT's contract (1,2,D,H,W) -> (1,3,D,H,W)."""
    import torch

    conv = torch.nn.Conv3d(2, 3, 3, padding=1)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        conv.weight.copy_(0.1 * torch.randn(conv.weight.shape, generator=gen))
        conv.bias.copy_(0.1 * torch.randn(3, generator=gen))
    torch.jit.script(conv).save(str(path))


def phase_backends(card, dev, fixed):
    """Phase 11b: compensate_arr_3D over T=2 frames of phase 6's recording
    with the flow backends: flow_backend='volraft-mock' (the rigid
    stand-in) and a VolRAFTBackend on a scripted Conv3d loaded through
    load_volraft, each with kernels and plain (bit-identical); each
    backend's card flow held to its CPU flow on a crop. Returns the kernel
    runs' launches by path."""
    import tempfile

    import torch

    from flowreg3d_tpu_torch.backends import (PatchRigidFlowBackend,
                                              VolRAFTBackend, load_volraft)
    from flowreg3d_tpu_torch.pipeline import (OFOptions, RegistrationConfig,
                                              compensate_arr_3D)

    frames = recording(fixed, BACKEND_T)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        scripted_conv(Path(tmp) / "volraft.pt")
        conv = load_volraft(checkpoint_dir=tmp, device=dev)
        check(isinstance(conv, VolRAFTBackend), "load_volraft: no checkpoint")
        cases = (("backend_mock", dict(flow_backend="volraft-mock"), 1e-5),
                 ("backend_volraft", dict(get_displacement_func=conv), 1e-4))
        log(f"phase 11b: flow backends in the pipeline, T={BACKEND_T} frames "
            f"of {SHAPE}: {[c[0] for c in cases]}")
        for name, cfg, tol in cases:
            out = {}
            for tag, uk in (("kernel", True), ("plain", False),
                            ("warm", True)):
                reset_counts()
                t = time.perf_counter()
                reg, flows = compensate_arr_3D(
                    frames, fixed, OFOptions(), device=dev,
                    config=RegistrationConfig(use_kernels=uk, **cfg))
                torch.cuda.synchronize()
                out[tag] = dict(seconds=time.perf_counter() - t, reg=reg,
                                flows=flows, launches=read_counts())
            k, p = out["kernel"], out["plain"]
            check(k["reg"].shape == frames.shape
                  and k["flows"].shape == frames.shape + (3,)
                  and np.isfinite(k["reg"]).all()
                  and np.isfinite(k["flows"]).all(), f"{name}: output")
            same = bool(np.array_equal(k["reg"], p["reg"])
                        and np.array_equal(k["flows"], p["flows"]))
            # per frame: the initial-w pass's warp, the batch's warp and,
            # w_init being nonzero, the harness's order-1 pre-warp
            expected = 3 * BACKEND_T
            counts[name] = k["launches"]
            q = frame_quality(frames, fixed, k["reg"], k["flows"])
            log(f"  {name}: kernel run {k['seconds']:.2f} s, plain "
                f"{p['seconds']:.2f} s, warm {out['warm']['seconds']:.2f} s "
                f"({BACKEND_T / out['warm']['seconds']:.4f} volumes/s); "
                f"launches {k['launches']} (map_coords_f32 expected "
                f"{expected}); registered and flows bit-identical kernel vs "
                f"plain {same}; quality {q}; card {card}")
            check(same, f"{name}: kernel and plain pipelines differ")
            check(k["launches"]["map_coords_f32"] == expected,
                  f"{name}: map_coords_f32 launched "
                  f"{k['launches']['map_coords_f32']} times, expected "
                  f"{expected}")
            check(out["warm"]["launches"] == k["launches"],
                  f"{name}: the warm run launched {out['warm']['launches']}")
            # the backend alone, card against CPU, on a crop
            fc, mc = fixed[BACKEND_CROP], frames[0][BACKEND_CROP]
            uvw = np.full(fc.shape + (3,), 0.3, np.float32)
            if name == "backend_mock":
                card_flow = PatchRigidFlowBackend(device=dev)(fc, mc)
                cpu_flow = PatchRigidFlowBackend(device="cpu")(fc, mc)
            else:
                card_flow = conv(fc, mc, uvw=uvw)
                cpu_flow = VolRAFTBackend(Path(tmp) / "volraft.pt",
                                          device="cpu")(fc, mc, uvw=uvw)
            d = float(np.abs(card_flow - cpu_flow).max())
            log(f"  {name} alone on a 16x64x64 crop: card vs CPU flow max "
                f"diff {d:.3e} (<= {tol:g})")
            check(d <= tol, f"{name}: card vs CPU flow {d}")
        del conv
    return counts


def plane_problem(shift_yx, dtype):
    """The 2D solver's test problem (tests/core/test_solver2d.py) on a
    512x512 plane: a smoothed random image and its shifted copy."""
    from scipy.ndimage import gaussian_filter, shift as ndshift

    rng = np.random.default_rng(3)
    f1 = gaussian_filter(rng.random(PLANE), 2.5)
    f2 = ndshift(f1, shift_yx, order=1, mode="nearest")
    fx = 0.5 * (np.gradient(f1, axis=1) + np.gradient(f2, axis=1))
    fy = 0.5 * (np.gradient(f1, axis=0) + np.gradient(f2, axis=0))
    ft = f2 - f1
    J = [np.pad(j, 1, mode="edge")[..., None].astype(dtype)
         for j in (fx * fx, fy * fy, ft * ft, fx * fy, fx * ft, fy * ft)]
    m, n = PLANE[0] + 2, PLANE[1] + 2
    return (J, np.ones((m, n, 1), dtype), np.zeros((m, n), dtype),
            np.zeros((m, n), dtype))


def phase_extras(card, dev, fixed, displaced, flow_gt):
    """Phase 11c: warp_volume_backward of the splatted volume by its
    ground-truth flow (kernel against plain, bit-equal; closer to the fixed
    volume than the splatted one),
    resize_batch of a T=4 batch to half size (against the CPU), and the 2D
    solver compute_flow on a 512x512 plane (shift recovery; its CUDA graph
    against the eager body, bit for bit, timed in turns; float64, through
    the graph too, against the CPU). Returns the backward warp's
    launches."""
    import torch

    from flowreg3d_tpu_torch.core import compute_flow
    from flowreg3d_tpu_torch.core.solver2d import flow2d_solver
    from flowreg3d_tpu_torch.motion_generation import warp_volume_backward
    from flowreg3d_tpu_torch.ops import resize_batch

    log("phase 11c: warp_volume_backward, resize_batch, compute_flow")
    reset_counts()
    back_k = warp_volume_backward(displaced, flow_gt, device=dev)
    launches = read_counts()
    back_p = warp_volume_backward(displaced, flow_gt, device=dev,
                                  use_kernels=False)
    same = bool(np.array_equal(back_k, back_p))
    ratio = mse(displaced, fixed) / mse(back_k, fixed)
    log(f"  warp_volume_backward (order 1) kernel vs plain bit-identical "
        f"{same}; launches {launches}; MSE to the fixed volume, splatted / "
        f"warped back {ratio:.3f}x")
    check(same and launches["map_coords_f32"] == 1,
          "warp_volume_backward: kernel vs plain or its launch")
    check(ratio > 1, f"warp_volume_backward: no improvement {ratio}")

    batch = recording(fixed, 4)[..., None]
    half = tuple(n // 2 for n in SHAPE)
    batch_t = torch.from_numpy(batch).to(dev)
    out = resize_batch(batch_t, half, device=dev)
    ms = cuda_ms(lambda: resize_batch(batch_t, half, device=dev), n=5, warm=1)
    cpu = resize_batch(batch[:1], half, device="cpu")
    d = float((out[:1].cpu() - cpu).abs().max())
    log(f"  resize_batch {tuple(batch.shape)} -> {tuple(out.shape)}: "
        f"{ms:.3f} ms on the card; frame 0 against the CPU max diff "
        f"{d:.3e} (<= 1e-5); card {card}")
    check(tuple(out.shape) == (4,) + half + (1,) and d <= 1e-5,
          f"resize_batch: shape {tuple(out.shape)} or diff {d}")
    del batch_t, out

    for a_smooth, a_data, shift in ((1.0, 1.0, (0.0, 0.4)),
                                    (0.5, 0.45, (0.4, 0.0))):
        kw = dict(alpha=(0.02, 0.02), iterations=80, update_lag=5,
                  a_data=a_data, a_smooth=a_smooth)
        J, w, u, v = plane_problem(shift, np.float32)
        du, dv = compute_flow(J, w, u, v, device=dev, **kw)
        solve = flow2d_solver(PLANE, 1, kw["alpha"], kw["iterations"],
                              kw["update_lag"], a_data, a_smooth, 1.0, 1.0,
                              torch.float32, dev)
        Jt, wt, ut, vt = (torch.from_numpy(x).to(dev)
                          for x in (np.stack(J), w, u, v))
        timed = graph_against_eager(
            f"11c compute_flow {PLANE} a_smooth {a_smooth}", card,
            lambda: compute_flow(Jt, wt, ut, vt, device=dev, **kw),
            lambda: solve(Jt, wt, ut, vt), "flow2d", [dev], n=3,
            calls=False)
        ms = timed["graph_ms"]
        along, across = ((du, dv) if shift[1] else (dv, du))
        med = (float(along[8:-8, 8:-8].median()),
               float(across[8:-8, 8:-8].median()))
        wild = int((du.abs() > 5).sum() + (dv.abs() > 5).sum())
        # float64 over 20 iterations: at a_smooth 0.5 the solve (JAX's
        # too) diverges locally after ~35 on this plane (|flow| ~2e5 on
        # ~3000 pixels at 80), where rounding then moves it by ~100
        J, w, u, v = plane_problem(shift, np.float64)
        kw64 = dict(kw, iterations=COMPARE_ITERATIONS)
        card64 = compute_flow(J, w, u, v, device=dev, **kw64)
        cpu64 = compute_flow(J, w, u, v, device="cpu", **kw64)
        d = max(float((a.cpu() - b).abs().max())
                for a, b in zip(card64, cpu64))
        log(f"  compute_flow {PLANE} a_smooth {a_smooth}: {ms:.2f} ms "
            f"replayed, {timed['eager_ms']:.2f} eager (float32, 80 "
            f"iterations, warm wall); median flow along / across the "
            f"0.4 shift {med[0]:.4f} / {med[1]:.4f}; {wild} flow values "
            f"above 5; float64 card vs CPU over {COMPARE_ITERATIONS} "
            f"iterations max diff {d:.3e} (<= 1e-9); card {card}")
        check(abs(med[0] - 0.4) < 0.15 and abs(med[1]) < 0.15,
              f"compute_flow a_smooth {a_smooth}: shift not recovered {med}")
        check(d <= 1e-9, f"compute_flow float64 card vs CPU {d}")
    return launches


def phase_motion_and_backends(card, dev, fixed):
    """Phase 11: synthetic motion and the flow backends at full width (the
    port's own modules). Returns launches by path."""
    counts = {}
    counts["harness"], displaced, flow_gt = phase_harness(card, dev, fixed)
    counts.update(phase_backends(card, dev, fixed))
    counts["warp_backward"] = phase_extras(card, dev, fixed, displaced,
                                           flow_gt)
    return counts


def phase_direct_timing(card, fixed_t, moving_t):
    log("phase 5b: warm direct-API step, get_displacement's graph against "
        "the eager pyramid")
    return phase_step_graph(card, fixed_t, moving_t, {}, "direct-API")


def phase_timing(card, fixed_t, moving_t, plain_s):
    log(f"phase 5: warm canonical step, get_displacement's graph against "
        f"the eager pyramid (plain path first step {plain_s:.2f} s)")
    return phase_step_graph(card, fixed_t, moving_t, CANONICAL, "canonical")


def phase_step_graph(card, fixed_t, moving_t, params, tag, n=5):
    """get_displacement's CUDA graph against the eager pyramid it captures,
    at C = 1 and C = 2: the flows bit-equal (max |diff| 0); the first
    call's seconds (warm eager run, capture, replay) and the capture's; the
    card memory the cached graph holds; no kernel wrapper's host launch on
    a warm call, and the runtime's launch and copy calls of one warm call
    both ways; warm wall medians of the step (flow + cubic warp) both ways,
    in turns. Returns the C = 1 graph step's median ms."""
    import torch

    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch.core.pyramid import pyramid_graphs
    from flowreg3d_tpu_torch.parallel import executors as tex

    out = {}
    for C in (2, 1):                # C = 1 stays cached, for --profile
        f, m = ((fixed_t, moving_t) if C == 1
                else (two_channels(fixed_t), two_channels(moving_t)))

        def flow():
            return ft.get_displacement(f, m, device=f.device, **params)

        tex.clear_frame_graphs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        base_alloc = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got = flow()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        (graph,) = pyramid_graphs()
        peak = torch.cuda.max_memory_allocated() - base_alloc
        del got
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() - base
        want = eager_displacement(f, m, params)
        got = flow()
        diff = float((got - want).abs().max())
        check(tuple(got.shape) == tuple(f.shape[:3]) + (3,)
              and bool(torch.isfinite(got).all()),
              f"{tag} C={C}: flow {tuple(got.shape)}, or non-finite")
        check(torch.equal(got, want), f"{tag} C={C}: the graph's flow is "
              f"{diff} from the eager pyramid's")
        del got, want
        reset_counts()
        flow()
        host = read_counts()
        check(not any(host.values()), f"{tag} C={C}: a warm call launched "
              f"{host} from the host")
        calls = {"graph": runtime_calls(flow),
                 "eager": runtime_calls(
                     lambda: eager_displacement(f, m, params))}
        ms = {"graph": [], "eager": []}
        for _ in range(n):
            for way, step in (("graph", run_step), ("eager", eager_step)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if way == "graph":
                    step(f, m, params, True)
                else:
                    step(f, m, params)
                ms[way].append(1e3 * (time.perf_counter() - t))
        med = {k: float(np.median(v)) for k, v in ms.items()}
        log(f"  {tag} C={C}: graph flow against eager max|diff| {diff}; "
            f"first call {first_s:.3f} s (capture {graph.capture_s:.3f} "
            f"s), the graph holds {held / 2**30:.2f} GiB reserved (peak "
            f"{peak / 2**30:.2f} GiB allocated in the first call), "
            f"{graph.launches} kernel launches a replay, {graph.replays} "
            f"replays; warm get_displacement runtime calls: graph "
            f"{calls['graph']}, eager {calls['eager']}")
        log(f"  {tag} step C={C}: graph {med['graph']:.2f} ms, eager "
            f"{med['eager']:.2f} ms median of {n} warm steps in turns "
            f"(graph {[round(x, 2) for x in ms['graph']]}, eager "
            f"{[round(x, 2) for x in ms['eager']]}), "
            f"{1e3 / med['graph']:.3f} against {1e3 / med['eager']:.3f} "
            f"volumes/s; card {card}")
        out[C] = med
        del f, m, graph
    return out[1]["graph"]


def phase_profile(work, tag):
    """torch.profiler over one warm run of ``work``: device busy share and
    the kernels that take the device time (full tables, by device and by
    host time, under chiprun_out/)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    avgs = prof.key_averages()
    (out / f"{tag}_profile.txt").write_text(
        avgs.table(sort_by="cuda_time_total", row_limit=60) + "\n"
        + avgs.table(sort_by="cpu_time_total", row_limit=40))
    kernels = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile of the {tag} (under the profiler): wall {wall * 1e3:.1f} "
        f"ms, device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / 1e6 / wall:.1f}%), "
        f"{sum(e.count for e in kernels)} kernel launches; table in "
        f"chiprun_out/{tag}_profile.txt")
    for e in kernels[:15]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x  "
            f"{e.key[:90]}")


def ab_child(tree):
    """One timing pass of the port found in checkout ``tree``: the warm
    canonical and direct-API steps (15 times each), the warm pipeline at the
    direct API's options and at OFOptions() defaults (twice each; the
    latter is compensate_arr_3D(frames, ref) with the default options and
    config, whatever the checkout's defaults are), and
    kernels by CUDA events around back-to-back calls and device only
    through a CUDA graph: the SOR tick block (sweep_iterations, 5
    iterations) at every canonical level and at (66,514,514), the warp at
    full size for orders 3 and 1, the median and the psi field at two shapes
    each, and the psi tick block (sweep_iterations_psi, 10 iterations) at
    two shapes; one profiled warm direct-API step (device busy ms, kernel
    executions) and phase 7's batched executor at the direct options (warm
    ms a frame); one line 'AB {json}'. Uses only entry points that every
    slice of the port since the fifth has."""
    import torch

    sys.path.insert(0, str(Path(tree).resolve()))
    import flowreg3d_tpu_torch as ft
    from flowreg3d_tpu_torch import _ext
    from flowreg3d_tpu_torch.core import solver_kernel as sk
    from flowreg3d_tpu_torch.core import solver_psi_kernel as spk
    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.ops import median_kernel as mk
    from flowreg3d_tpu_torch.ops import warp as tw
    from flowreg3d_tpu_torch.ops import warp_kernel as wk

    _ext.lib()
    dev = torch.device("cuda")
    fixed, moving = make_pair(SHAPE)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev) for a in (fixed, moving))
    steps = {}
    for tag, params in (("canonical", CANONICAL), ("direct", {})):
        run_step(fixed_t, moving_t, params, True)
        steps[tag] = []
        for _ in range(15):
            t = time.perf_counter()
            run_step(fixed_t, moving_t, params, True)
            steps[tag].append(1e3 * (time.perf_counter() - t))
    frames = recording(fixed, PIPELINE_T)
    pipeline_s = {}
    for tag, defaults in (("direct options", False), ("defaults", True)):
        run_pipeline(frames, fixed, True, dev, defaults)
        pipeline_s[tag] = [run_pipeline(frames, fixed, True, dev,
                                        defaults)[2] for _ in range(2)]
    kernels = {}

    def timed(name, fn, n=50):
        kernels[name] = (cuda_ms(fn, n), graph_ms(fn, min(n, 20)))

    rng = np.random.default_rng(8)
    plan, _, _ = level_schedule(SHAPE, CANONICAL["eta"], CANONICAL["levels"],
                                CANONICAL["min_level"])
    for shape in ([tuple(n + 2 for n in size) for _, size, _ in plan]
                  + [tuple(n + 2 for n in SHAPE)]):
        duvw, sj = sor_inputs(rng, shape, dev)
        timed(f"sor tick block x5 {shape}",
              lambda: sk.sweep_iterations(duvw, sj, 1.0, 1.0, 1.0, 5),
              50 if shape[0] < 60 else 5)
    del duvw, sj
    vol_t = torch.from_numpy(fixed).to(dev)
    coords_t = [torch.from_numpy(c).to(dev)
                for c in smooth_flow_coords(SHAPE, rng)]
    for order in (3, 1):
        coeff = (tw.bspline_prefilter(vol_t) if order == 3
                 else tw._pad_far_edge(vol_t).contiguous())
        timed(f"map_coords order {order} {SHAPE}",
              lambda: wk.map_coords(coeff, *coords_t, order), 20)
    del coeff, coords_t
    gen = torch.Generator(device=dev).manual_seed(7)
    for shape in ((3, 25, 172, 172), (3, 68, 516, 516)):
        xp = torch.randn(shape, generator=gen, device=dev)
        timed(f"median5 xp {shape}", lambda: mk.median5(xp))
    params = spk.psi_params(0.5, 1.0, 1.0, 1.0)
    tick = params + (0.7, 0.9, 1.3)
    for shape in ((23, 170, 170), (66, 514, 514)):
        duvw = 0.1 * torch.randn((3,) + shape, generator=gen, device=dev)
        base = 2.0 * torch.rand((3,) + shape, generator=gen, device=dev)
        sj = 0.1 * torch.rand((9,) + shape, generator=gen, device=dev)
        sj[:3] += 0.5
        psi = torch.empty_like(duvw[0])
        timed(f"psi_field {shape}",
              lambda: spk.psi_field(duvw, base, *params, out=psi))
        timed(f"psi tick block x10 {shape}",
              lambda: spk.sweep_iterations_psi(duvw, base, sj, tick, 10),
              5 if shape[0] > 60 else 20)
    del duvw, base, sj, psi
    direct_busy = profile_direct_step(fixed_t, moving_t)
    executor_ms = executor_direct_ms(fixed, frames, dev)
    print("AB " + json.dumps(dict(
        tree=str(tree), package=ft.__file__, card=card_line(),
        step_ms=steps,
        step_ms_median={k: float(np.median(v)) for k, v in steps.items()},
        pipeline_s=pipeline_s,
        pipeline_volumes_per_s={k: PIPELINE_T / float(np.median(v))
                                for k, v in pipeline_s.items()},
        direct_step_profiled=direct_busy,
        executor_direct_options_ms_a_frame=executor_ms,
        kernels_ms_events_and_graph=kernels)), flush=True)


def profile_direct_step(fixed_t, moving_t):
    """One warm direct-API step under torch.profiler: the device's busy ms
    (kernel time summed) and its kernel executions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step(fixed_t, moving_t, {}, True)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return dict(busy_ms=sum(e.self_device_time_total for e in kern) / 1e3,
                kernels=sum(e.count for e in kern))


def executor_direct_ms(fixed, frames, dev, n=3):
    """Phase 7's batched executor (one CUDA graph a frame) at the direct
    API's options: warm ms a frame, each of ``n`` runs."""
    import torch

    from flowreg3d_tpu_torch.parallel import executors as tex
    from flowreg3d_tpu_torch.pipeline.device_pipeline import preprocess

    o = pipeline_options(False)
    raw = torch.from_numpy(frames[..., None]).to(dev)
    ref_raw = torch.from_numpy(fixed[..., None]).to(dev)
    proc, ref_proc = preprocess(raw, o, ref_raw), preprocess(ref_raw, o)
    w_init = torch.zeros(SHAPE + (3,), device=dev)
    bat = tex.BatchedExecutor3D(device=dev)

    def run():
        bat.process_batch(raw, proc, ref_raw, ref_proc, w_init,
                          interpolation_method="cubic",
                          flow_params=o.to_dict())
        torch.cuda.synchronize()

    tex.clear_frame_graphs()
    run()                                   # captures
    out = []
    for _ in range(n):
        t = time.perf_counter()
        run()
        out.append(1e3 * (time.perf_counter() - t) / len(frames))
    tex.clear_frame_graphs()
    return out


def ab(parent):
    """Parent checkout, this one, this one, parent: a child process each on
    the same card, so host and card are shared by both versions."""
    for tree in (parent, HERE, HERE, parent):
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--ab-child", str(tree)], check=True, timeout=900)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm canonical and one warm "
                    "direct-API step (torch.profiler)")
    ap.add_argument("--ab", metavar="PARENT",
                    help="only time this checkout against the one in PARENT "
                    "(parent, this, this, parent), printing 'AB {json}' lines")
    ap.add_argument("--ab-child", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if args.ab_child:
        ab_child(args.ab_child)
        return 0
    if args.ab:
        ab(args.ab)
        return 0
    sys.path.insert(0, str(HERE))
    import flowreg3d_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    card = card_line()
    phase_build(card)
    rows = phase_kernels(card, dev) + phase_psi_kernels(card, dev)
    counts, replays = {}, {}
    (counts["canonical"], replays["canonical"], fixed_t, moving_t,
     plain_s) = phase_canonical(card, dev)
    phase_convergent(card, dev)
    step_ms = phase_timing(card, fixed_t, moving_t, plain_s)
    if args.profile:
        phase_profile(lambda: run_step(fixed_t, moving_t, CANONICAL, True),
                      "step")
    (counts["direct"], replays["direct"], fixed_t, moving_t,
     _) = phase_direct(card, dev)
    direct_ms = phase_direct_timing(card, fixed_t, moving_t)
    if args.profile:
        phase_profile(lambda: run_step(fixed_t, moving_t, {}, True),
                      "direct_step")
    fixed = fixed_t.cpu().numpy()
    del fixed_t, moving_t
    counts["pipeline"], replays["pipeline"], vols_per_s = phase_pipeline(
        card, dev, fixed)
    (counts["pipeline_defaults"], replays["pipeline_defaults"],
     vols_defaults) = phase_pipeline(card, dev, fixed, defaults=True)
    phase_graphs_together(card, dev, fixed)
    if args.profile:
        frames = recording(fixed, PIPELINE_T)
        for tag, defaults in (("pipeline", False),
                              ("pipeline_defaults", True)):
            run_pipeline(frames, fixed, True, dev, defaults)   # captures
            phase_profile(lambda: run_pipeline(frames, fixed, True, dev,
                                               defaults), tag)
        del frames
    executors = phase_executors(card, dev, fixed)
    (counts["pipeline_T24"], replays["pipeline_T24"],
     t24) = phase_pipeline_long(card, dev, fixed, profile=args.profile)
    vols_t24 = t24["volumes_per_s"]
    counts["pipeline_cc"], replays["pipeline_cc"], vols_cc = phase_cc(
        card, dev, fixed)
    (counts["pipeline_file"], replays["pipeline_file"],
     vols_file) = phase_file_pipeline(card, dev, t24, profile=args.profile)
    del t24
    slab_rows, multi_counts, multi_replays, multi = phase_multi_gpu(
        card, dev, fixed)
    counts.update(multi_counts)
    replays.update(multi_replays)
    counts.update(phase_motion_and_backends(card, dev, fixed))
    del fixed

    kernels = []
    for row in rows:
        path = row.pop("path")
        row.pop("shape")
        row["launches"] = counts[path][row["name"]] if path in counts else 0
        row["launches_by_path"] = {k: c[row["name"]]
                                   for k, c in counts.items()}
        if row["name"] in slab_rows:
            row["slab"] = {k: (list(v) if k == "shape" else v)
                           for k, v in slab_rows[row["name"]].items()}
        row["replayed_by_path"] = {k: c[row["name"]]
                                   for k, c in replays.items()}
        kernels.append(row)
    log(f"all phases passed; canonical step {step_ms:.1f} ms, direct-API "
        f"step {direct_ms:.1f} ms, pipeline T={PIPELINE_T} {vols_per_s:.4f} "
        f"volumes/s (OFOptions() defaults {vols_defaults:.4f}, T=24 u16 "
        f"{vols_t24:.4f}, cc {vols_cc:.4f}; the file pipeline T=24 "
        f"{vols_file['default']:.4f}, without prefetch and the async writer "
        f"{vols_file['plain']:.4f}); batched against sequential "
        f"bit-identical { {k: v['same'] for k, v in executors.items()} }, "
        f"warm ms a frame { {k: v['ms'] for k, v in executors.items()} }; "
        f"sharded steps warm ms {multi} on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
