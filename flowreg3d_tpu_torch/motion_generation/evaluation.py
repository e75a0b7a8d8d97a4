"""Flow / correction quality metrics: mean End-Point Error, the MAE
improvement ratio and PSNR, host numpy.

Counterpart of ``flowreg3d_tpu/motion_generation/evaluation.py`` (the same
code): the reference's EPE harness (examples/motion_correct_3d_test.py).
"""

import numpy as np


def _crop(a, boundary):
    if boundary > 0:
        return a[boundary:-boundary, boundary:-boundary, boundary:-boundary]
    return a


def evaluate_flow_accuracy(flow_est, flow_gt, boundary=25):
    """Mean End-Point Error ||flow_est - flow_gt|| over the cropped interior."""
    fe = _crop(np.asarray(flow_est), boundary)
    fg = _crop(np.asarray(flow_gt), boundary)
    return float(np.mean(np.linalg.norm(fe - fg, axis=-1)))


def improvement_ratio(original, displaced, corrected, boundary=0):
    """MAE(original, displaced) / MAE(original, corrected) (ref :736-745)."""
    o = _crop(np.asarray(original, np.float64), boundary)
    d = _crop(np.asarray(displaced, np.float64), boundary)
    c = _crop(np.asarray(corrected, np.float64), boundary)
    mae_d = np.mean(np.abs(o - d))
    mae_c = np.mean(np.abs(o - c))
    return float(mae_d / mae_c) if mae_c > 0 else float("inf")


def psnr(reference, test, data_range=None):
    """Peak signal-to-noise ratio in dB."""
    r = np.asarray(reference, np.float64)
    t = np.asarray(test, np.float64)
    if data_range is None:
        data_range = r.max() - r.min()
    mse = np.mean((r - t) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(data_range) - 10.0 * np.log10(mse))
