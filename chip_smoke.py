#!/usr/bin/env python3
"""Drive flowreg3d_tpu_torch on one CUDA card and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --profile    # also torch.profiler breakdowns of
                                       # one warm canonical and one warm
                                       # direct-API step, written under
                                       # chiprun_out/

Phases:
  1. build the CUDA kernels of flowreg3d_tpu_torch/csrc (one nvcc call);
  2. each kernel against its plain version on the card, at the shapes of
     the canonical step, and the warp against scipy on a crop; 2b. the
     flow-driven-diffusivity kernels (psi field, psi and constant-weight
     half-sweeps) at a mid level and at the full 514^2 plane;
  3. the canonical motion-correction step (64x512x512, bench.py's pair and
     flow parameters) through get_displacement + imregister_wrapper, with
     the kernels' launch counts, against the same step on the plain path;
     3b. the direct API, get_displacement(fixed, moving) with its own
     defaults (a_smooth 0.5, min_level 0: 10 levels up to 64x512x512), the
     same way;
  4. the convergent regime (alpha=1.5, min_level=0) on a shifted 32x128x128
     pair, kernel path against plain path, on the accuracy gate;
  5. timings: per kernel launch, plain version, library call, full step;
     5b. the warm direct-API step;
  6. the in-memory pipeline, compensate_arr_3D over a drifting T=4
     recording with the direct API's flow defaults, kernels against the
     plain pipeline (use_kernels=False), with launch counts, then its warm
     volumes/s.
Then one JSON line of kernels, the card's name and power limit, and the
last line {"ok": true, "device": {...}}. Any failed check raises, so the
script exits non-zero; it also exits non-zero without CUDA or without the
package beside it.
"""

import argparse
import json
import math
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

# H100 SXM published peaks (dense): HBM bytes/s and fp32 (non-tensor) ops/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNEL_TOL = 2e-5                  # tests/core/test_solver_pallas.py:62,157
SCIPY_TOL = 2e-4                   # tests/ops/test_warp_pallas.py:58


def log(msg):
    print(f"[chip_smoke {time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


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
    for line in _ext.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  nvcc: {line.strip()}")


def phase_kernels(card, dev):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from scipy.ndimage import map_coordinates

    from flowreg3d_tpu_torch.core import solver_kernel as sk
    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.ops import median_kernel as mk
    from flowreg3d_tpu_torch.ops import warp as tw
    from flowreg3d_tpu_torch.ops import warp_kernel as wk

    log("phase 2: kernels against their plain versions on the card")
    rng = np.random.default_rng(1)
    rows = []

    # --- SOR half-sweep, at the finest canonical level and a 514^2 plane
    plan, _, _ = level_schedule(SHAPE, CANONICAL["eta"], CANONICAL["levels"],
                                CANONICAL["min_level"])
    _, size5, (hz, hy, hx) = plan[-1]
    ax, ay, az = (float(np.float32(0.25) / (np.float32(h) * np.float32(h)))
                  for h in (hx, hy, hz))

    def sor_inputs(shape):
        P, M, N = shape
        duvw = torch.from_numpy(
            (0.1 * rng.standard_normal((3, P, M, N))).astype(np.float32))
        sj = rng.random((9, P, M, N)).astype(np.float32) * 0.1
        sj[:3] += 0.5                     # positive definite data block
        return duvw.to(dev), torch.from_numpy(sj).to(dev)

    err = 0.0
    for shape, n_half in ((tuple(s + 2 for s in size5), 10),
                          ((SHAPE[0] + 2, SHAPE[1] + 2, SHAPE[2] + 2), 1)):
        duvw, sj = sor_inputs(shape)
        a, b = duvw.clone(), duvw.clone()
        for k in range(n_half):
            sk.sor_halfsweep(a, sj, ax, ay, az, k % 2)
            sk.sor_halfsweep_plain(b, sj, ax, ay, az, k % 2)
        torch.cuda.synchronize()
        e = float((a - b).abs().max())
        ring_same = bool(torch.equal(a[:, 0], duvw[:, 0])
                         and torch.equal(a[:, :, :, -1], duvw[:, :, :, -1]))
        log(f"  sor_halfsweep {shape} x{n_half}: max|kernel-plain| = {e:.3e}"
            f", ring untouched {ring_same}")
        check(e <= KERNEL_TOL and ring_same,
              f"sor_halfsweep disagrees at {shape}: {e}")
        err = max(err, e)
    big = tuple(n + 2 for n in SHAPE)      # the plane the y-tiled TPU kernel served
    duvw, sj = sor_inputs(big)
    n_int = SHAPE[0] * SHAPE[1] * SHAPE[2]
    bnd, by = bound_ms(9 * 4 * n_int, 60 * n_int / 2)
    k_ms = cuda_ms(lambda: sk.sor_halfsweep(duvw, sj, ax, ay, az, 0))
    p_ms = cuda_ms(lambda: sk.sor_halfsweep_plain(duvw, sj, ax, ay, az, 0), 5)
    log(f"  sor_halfsweep_f32 at {big}: {k_ms:.4f} ms/launch, plain "
        f"{p_ms:.4f} ms, bound {bnd:.4f} ms ({by}); card {card}")
    sor_big = dict(
        name="sor_halfsweep_f32", route="cuda", path=None,
        source="flowreg3d_tpu_torch/csrc/sor_halfsweep.cu",
        replaces="flowreg3d_tpu/core/solver_pallas.py:844", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None,
        shape=f"duvw (3,{big[0]},{big[1]},{big[2]}) one half-sweep")
    P, M, N = (s + 2 for s in size5)
    duvw, sj = sor_inputs((P, M, N))
    n_int = (P - 2) * (M - 2) * (N - 2)
    bnd, by = bound_ms(9 * 4 * n_int, 60 * n_int / 2)
    rows.append(dict(
        name="sor_halfsweep_f32", route="cuda", path="canonical",
        source="flowreg3d_tpu_torch/csrc/sor_halfsweep.cu",
        replaces="flowreg3d_tpu/core/solver_pallas.py:952",
        max_abs_err=err,
        ms=cuda_ms(lambda: sk.sor_halfsweep(duvw, sj, ax, ay, az, 0), 200),
        plain_ms=cuda_ms(
            lambda: sk.sor_halfsweep_plain(duvw, sj, ax, ay, az, 0), 20),
        bound_ms=bnd, bound_by=by, library_ms=None,
        shape=f"duvw (3,{P},{M},{N}) one half-sweep"))
    rows.append(sor_big)

    # --- B-spline sampling at the full-size output warp
    vol, _ = make_pair(SHAPE)
    Z, Y, X = SHAPE
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 2 * np.pi, n, dtype=np.float32)
                               for n in SHAPE), indexing="ij")
    amp, ph = rng.uniform(2.0, 4.0, 3), rng.uniform(0.0, 2 * np.pi, 3)
    flow = (amp[0] * np.sin(xx + 0.5 * yy + ph[0]),        # smooth, random
            amp[1] * np.cos(yy - zz + ph[1]),
            0.5 * amp[2] * np.sin(zz + xx + ph[2]))
    grids = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in SHAPE),
                        indexing="ij")
    coords = [np.clip(g + f, 0, n - 1).astype(np.float32) for g, f, n in
              zip(grids, (flow[2], flow[1], flow[0]), SHAPE)]
    vol_t = torch.from_numpy(vol).to(dev)
    cz, cy, cx = (torch.from_numpy(c).to(dev) for c in coords)
    err = 0.0
    crop = tuple(slice(n // 2 - c // 2, n // 2 + c // 2)
                 for n, c in zip(SHAPE, (8, 64, 64)))
    for order, coeff in ((3, tw.bspline_prefilter(vol_t)),
                         (1, tw._pad_far_edge(vol_t).contiguous())):
        got = wk.map_coords(coeff, cz, cy, cx, order)
        want = wk.map_coords_plain(coeff, cz, cy, cx, order)
        e = float((got - want).abs().max())
        ref = map_coordinates(vol.astype(np.float64),
                              [c[crop] for c in coords], order=order,
                              mode="nearest")
        e_scipy = float(np.abs(got[crop].cpu().numpy() - ref).max())
        log(f"  map_coords order {order} {SHAPE}: max|kernel-plain| = "
            f"{e:.3e}; max|kernel-scipy| on a {ref.shape} crop = "
            f"{e_scipy:.3e}")
        check(e <= KERNEL_TOL, f"map_coords order {order} disagrees: {e}")
        check(e_scipy <= SCIPY_TOL,
              f"map_coords order {order} vs scipy: {e_scipy}")
        err = max(err, e)
    coeff = tw.bspline_prefilter(vol_t)
    n = Z * Y * X
    bnd, by = bound_ms(coeff.numel() * 4 + 4 * n * 4, 210 * n)
    rows.append(dict(
        name="map_coords_f32", route="cuda", path="direct",
        source="flowreg3d_tpu_torch/csrc/map_coords.cu",
        replaces="flowreg3d_tpu/ops/warp_pallas.py:131",
        max_abs_err=err,
        ms=cuda_ms(lambda: wk.map_coords(coeff, cz, cy, cx, 3)),
        plain_ms=cuda_ms(lambda: wk.map_coords_plain(coeff, cz, cy, cx, 3),
                         3, 1),
        bound_ms=bnd, bound_by=by, library_ms=None,
        shape=f"order 3, coeff {tuple(coeff.shape)}, out {SHAPE}"))
    del cz, cy, cx, coeff

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
    for r in rows:
        log(f"  {r['name']} [{r['shape']}]: {r['ms']:.4f} ms/launch, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']} ms; card {card}")
    return rows


def counters():
    from flowreg3d_tpu_torch.core import solver_kernel, solver_psi_kernel
    from flowreg3d_tpu_torch.ops import median_kernel, warp_kernel

    return {"sor_halfsweep_f32": solver_kernel.sor_halfsweep,
            "map_coords_f32": warp_kernel.map_coords,
            "median5_f32": median_kernel.median5,
            "psi_field_f32": solver_psi_kernel.psi_field,
            "sor_halfsweep_psi_f32": solver_psi_kernel.halfsweep_psi,
            "sor_halfsweep_const_f32": solver_psi_kernel.halfsweep}


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


def phase_canonical(card, dev):
    import torch

    from flowreg3d_tpu_torch.core.pyramid import level_schedule

    log(f"phase 3: canonical step {SHAPE} through get_displacement + "
        "imregister_wrapper")
    fixed, moving = make_pair(SHAPE)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev) for a in (fixed, moving))

    plan, _, _ = level_schedule(SHAPE, CANONICAL["eta"], CANONICAL["levels"],
                                CANONICAL["min_level"])
    expected = {
        "sor_halfsweep_f32": len(plan) * 2 * CANONICAL["iterations"],
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
    return launches, fixed_t, moving_t, plain_s


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
    mid level and at the full 514^2 plane, and their timings."""
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
        for name, e in (("psi_field", max(e_psi, e_psi75)),
                        ("sor_halfsweep_psi", e_sweep),
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
            log(f"  {name} at ({P},{M},{N}): {row['ms']:.4f} ms/launch, "
                f"plain {row['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by})"
                f"; card {card}")
        del duvw, base, sj, psi_k, psi_p, a, b

    # One psi_field kernel serves every plane, so rows 6 and 7 both carry
    # its launches counted over the direct-API step.
    rows = [
        dict(out[("psi_field_f32", mid)], path="direct",
             replaces="flowreg3d_tpu/core/solver_pallas.py:247"),
        dict(out[("psi_field_f32", 0)], path="direct",
             replaces="flowreg3d_tpu/core/solver_pallas.py:435"),
        dict(out[("sor_halfsweep_const_f32", 0)], path=None,
             replaces="flowreg3d_tpu/core/solver_pallas.py:33"),
        dict(out[("sor_halfsweep_psi_f32", 0)], path="direct",
             replaces="flowreg3d_tpu/core/solver_pallas.py:148"),
    ]
    return rows


def step_bounds(plan, d):
    """ms: each kernel's bound (as phase 2b counts it) summed over one
    direct-API step's launches at every level's shape."""
    psi = sweep = med = 0.0
    for _, (z, y, x), _ in plan:
        cells = (z + 2) * (y + 2) * (x + 2)
        psi += d["iterations"] * bound_ms(28 * cells, 70 * cells)[0]
        sweep += 2 * d["iterations"] * bound_ms(70 * cells, 60 * cells)[0]
        n = 3 * z * y * x
        med += bound_ms((3 * (z + 4) * (y + 4) * (x + 4) + n) * 4, 250 * n)[0]
    return {"psi_field_f32": round(psi, 4),
            "sor_halfsweep_psi_f32": round(sweep, 4),
            "median5_f32": round(med, 4)}


def phase_direct(card, dev):
    """The direct API with its own defaults (a_smooth 0.5, min_level 0) on
    bench.py's pair, kernels against the plain path."""
    import torch

    from flowreg3d_tpu_torch.core.pyramid import level_schedule

    d = direct_defaults()
    plan, _, _ = level_schedule(SHAPE, d["eta"], d["levels"], d["min_level"])
    log(f"phase 3b: direct API get_displacement(fixed, moving) with its "
        f"defaults {d} on {SHAPE}, {len(plan)} levels "
        f"{[size for _, size, _ in plan]}")
    fixed, moving = make_pair(SHAPE)
    fixed_t, moving_t = (torch.from_numpy(a).to(dev) for a in (fixed, moving))
    expected = {
        "psi_field_f32": len(plan) * d["iterations"],
        "sor_halfsweep_psi_f32": 2 * len(plan) * d["iterations"],
        "map_coords_f32": len(plan) + 1,
        "median5_f32": sum(min(size) > 5 for _, size, _ in plan),
        "sor_halfsweep_f32": 0,
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
    return launches, fixed_t, moving_t, plain_s


def recording(fixed, n_frames, seed=4):
    """T frames of the fixed volume under an integer drift (frame t rolled
    by ((t+1) % 2, 2(t+1), -(t+1)), so every frame moved) plus Gaussian
    noise of sigma 0.01; (T, Z, Y, X) float32."""
    rng = np.random.default_rng(seed)
    frames = [np.roll(fixed, ((t + 1) % 2, 2 * (t + 1), -(t + 1)),
                      axis=(0, 1, 2))
              + rng.normal(0.0, 0.01, fixed.shape).astype(np.float32)
              for t in range(n_frames)]
    return np.stack(frames).astype(np.float32)


def run_pipeline(frames, reference, use_kernels, dev):
    """compensate_arr_3D over the recording with get_displacement's flow
    defaults; returns (registered, flows, seconds)."""
    from flowreg3d_tpu_torch.pipeline import (OFOptions, RegistrationConfig,
                                              compensate_arr_3D)

    opts = OFOptions(alpha=2.0, iterations=20, update_lag=10, levels=50,
                     eta=0.8, min_level=0, a_smooth=0.5, a_data=0.45)
    t = time.perf_counter()
    reg, flows = compensate_arr_3D(
        frames, reference, opts,
        config=RegistrationConfig(use_kernels=use_kernels), device=dev)
    return reg, flows, time.perf_counter() - t


def phase_pipeline(card, dev, fixed):
    """The in-memory pipeline over a drifting recording, kernels against
    the plain path, then its warm throughput."""
    from flowreg3d_tpu_torch.core.pyramid import level_schedule
    from flowreg3d_tpu_torch.pipeline import flow_statistics

    d = direct_defaults()
    plan, _, _ = level_schedule(SHAPE, d["eta"], d["levels"], d["min_level"])
    frames = recording(fixed, PIPELINE_T)
    log(f"phase 6: pipeline compensate_arr_3D over T={PIPELINE_T} frames of "
        f"{SHAPE} (initial w pass + batch: {2 * PIPELINE_T} flow solves)")
    solves = 2 * PIPELINE_T
    expected = {
        "psi_field_f32": solves * len(plan) * d["iterations"],
        "sor_halfsweep_psi_f32": 2 * solves * len(plan) * d["iterations"],
        "map_coords_f32": solves * (len(plan) + 1),
        "median5_f32": solves * sum(min(size) > 5 for _, size, _ in plan),
        "sor_halfsweep_f32": 0,
        "sor_halfsweep_const_f32": 0,
    }
    reset_counts()
    reg_k, flows_k, first_s = run_pipeline(frames, fixed, True, dev)
    launches = read_counts()
    log(f"  kernel run ({first_s:.2f} s): launches {launches}, expected "
        f"{expected}")
    check(launches == expected, f"pipeline launches {launches} != {expected}")
    reg_p, flows_p, plain_s = run_pipeline(frames, fixed, False, dev)

    def per_frame(reg, flows):
        check(reg.shape == frames.shape and flows.shape == frames.shape + (3,)
              and np.isfinite(reg).all() and np.isfinite(flows).all(),
              f"pipeline output {reg.shape} {flows.shape} or non-finite")
        return dict(
            psnr=[psnr(fixed, r) for r in reg],
            improvement=[mse(f, fixed) / mse(r, fixed)
                         for f, r in zip(frames, reg)],
            mean_disp=flow_statistics(flows)["mean_disp"])

    k, p = per_frame(reg_k, flows_k), per_frame(reg_p, flows_p)
    log(f"  plain run {plain_s:.2f} s; kernel {k}; plain {p}; max|registered"
        f" diff| {float(np.abs(reg_k - reg_p).max()):.3e}, max|flow diff| "
        f"{float(np.abs(flows_k - flows_p).max()):.3e}")
    for t in range(PIPELINE_T):
        check(abs(k["psnr"][t] - p["psnr"][t]) <= 0.5,
              f"frame {t}: PSNR {k['psnr'][t]} vs {p['psnr'][t]}")
        check(abs(k["improvement"][t] - p["improvement"][t])
              <= 0.02 * p["improvement"][t],
              f"frame {t}: improvement {k['improvement'][t]} vs "
              f"{p['improvement'][t]}")
        check(k["improvement"][t] > 1 and p["improvement"][t] > 1,
              f"frame {t}: no improvement")
        check(abs(k["mean_disp"][t] - p["mean_disp"][t])
              <= 0.02 * abs(p["mean_disp"][t]),
              f"frame {t}: mean_disp {k['mean_disp'][t]} vs "
              f"{p['mean_disp'][t]}")
    _, _, warm_s = run_pipeline(frames, fixed, True, dev)
    log(f"  pipeline warm run: {warm_s:.3f} s for {PIPELINE_T} volumes, "
        f"{PIPELINE_T / warm_s:.4f} volumes/s ({solves} flow solves); card "
        f"{card}")
    return launches, PIPELINE_T / warm_s


def phase_direct_timing(card, fixed_t, moving_t, n=3):
    import torch

    log("phase 5b: warm direct-API step timing")
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_step(fixed_t, moving_t, {}, True)
        times.append(time.perf_counter() - t)
    ms = 1e3 * float(np.median(times))
    log(f"  direct-API step {SHAPE}: {ms:.1f} ms median of {n} warm steps "
        f"({[round(1e3 * s, 1) for s in times]}), {1e3 / ms:.3f} volumes/s;"
        f" card {card}")
    return ms


def phase_timing(card, fixed_t, moving_t, plain_s, n=3):
    import torch

    import flowreg3d_tpu_torch as ft

    log("phase 5: warm full-step timing")
    times, pyr = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        flow = ft.get_displacement(fixed_t, moving_t, device=fixed_t.device,
                                   **CANONICAL)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ft.imregister_wrapper(moving_t, flow[..., 0], flow[..., 1],
                              flow[..., 2], fixed_t, device=fixed_t.device)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        pyr.append(t1 - t)
    ms = 1e3 * float(np.median(times))
    log(f"  step {SHAPE}: {ms:.1f} ms median of {n} warm steps "
        f"({[round(1e3 * s, 1) for s in times]}), pyramid "
        f"{1e3 * float(np.median(pyr)):.1f} ms, {1e3 / ms:.3f} volumes/s; "
        f"plain path first step {plain_s:.2f} s; card {card}")
    return ms


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one warm canonical and one warm "
                    "direct-API step (torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import flowreg3d_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    card = card_line()
    phase_build(card)
    rows = phase_kernels(card, dev) + phase_psi_kernels(card, dev)
    counts = {}
    counts["canonical"], fixed_t, moving_t, plain_s = phase_canonical(card,
                                                                      dev)
    phase_convergent(card, dev)
    step_ms = phase_timing(card, fixed_t, moving_t, plain_s)
    if args.profile:
        phase_profile(lambda: run_step(fixed_t, moving_t, CANONICAL, True),
                      "step")
    counts["direct"], fixed_t, moving_t, _ = phase_direct(card, dev)
    direct_ms = phase_direct_timing(card, fixed_t, moving_t)
    if args.profile:
        phase_profile(lambda: run_step(fixed_t, moving_t, {}, True),
                      "direct_step")
    fixed = fixed_t.cpu().numpy()
    counts["pipeline"], vols_per_s = phase_pipeline(card, dev, fixed)
    if args.profile:
        frames = recording(fixed, PIPELINE_T)
        phase_profile(lambda: run_pipeline(frames, fixed, True, dev),
                      "pipeline")

    kernels = []
    for row in rows:
        path = row.pop("path")
        row.pop("shape")
        row["launches"] = counts[path][row["name"]] if path in counts else 0
        row["launches_by_path"] = {k: c[row["name"]]
                                   for k, c in counts.items()}
        kernels.append(row)
    log(f"all phases passed; canonical step {step_ms:.1f} ms, direct-API "
        f"step {direct_ms:.1f} ms, pipeline {vols_per_s:.4f} volumes/s on "
        f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
