"""The numbers that decide ``correct``: what the timed path produced against the
plain reference, each with its limit.

Per registered item (a pair, or a sampled frame of a recording):

- ``flow_epe``: the mean over voxels of the end-point distance between the
  program's flow and the reference's, in voxels;
- ``reg_rel_rms``: the root mean square of the program's registered volume
  minus the reference's, over the root mean square of the reference's about its
  mean.

Values that agree exactly, infinities and NaNs included, differ by 0. Each
number is the worst over the items; a number passes when it is at most its
limit.
"""

import torch


def _diff(a, b):
    """a - b in float64, 0 where the two agree exactly (NaN with NaN)."""
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return torch.where(same, torch.zeros_like(a), a - b)


def item_numbers(flow_p, reg_p, flow_r, reg_r):
    """The per-item numbers of one registration against the reference's."""
    epe = torch.linalg.vector_norm(_diff(flow_p, flow_r), dim=-1)
    centred = reg_r.double() - reg_r.double().mean()
    rms_ref = float(centred.pow(2).mean().sqrt())
    return {
        "flow_epe": float(epe.mean()),
        "reg_rel_rms": float(_diff(reg_p, reg_r).pow(2).mean().sqrt())
        / rms_ref,
    }


def worst(per_item):
    """The worst value of each number over the items (NaN if any is)."""
    out = {}
    for numbers in per_item:
        for k, v in numbers.items():
            if k not in out or v != v or (out[k] == out[k] and v > out[k]):
                out[k] = v
    return out


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every limited number at most its
    limit; a number with no value fails."""
    rows = [(k, numbers.get(k), limits[k]) for k in sorted(limits)]
    ok = all(v is not None and v == v and v <= lim for _, v, lim in rows)
    return ok, rows
