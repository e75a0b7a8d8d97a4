"""Per-frame flow statistics, computed on the flows' device.

Counterpart of ``flowreg3d_tpu/pipeline/stats.py``: mean and max
displacement magnitude, mean divergence (du/dx + dv/dy + dw/dz with
np.gradient semantics) and the magnitude of the mean translation, per frame.
"""

import torch

from flowreg3d_tpu_torch.ops.gradients import divergence


def flow_statistics_tensor(flows):
    """(T, 4) float32 tensor on the flows' device: per frame [mean_disp,
    max_disp, mean_div, mean_translation] of a (T,Z,Y,X,3) tensor."""
    flows = flows.to(torch.float32)
    mag = torch.linalg.vector_norm(flows, dim=-1)            # (T,Z,Y,X)
    div = torch.stack([divergence(f).mean() for f in flows])
    t_mean = flows.mean(dim=(1, 2, 3))                        # (T,3)
    return torch.stack([mag.mean(dim=(1, 2, 3)), mag.amax(dim=(1, 2, 3)),
                        div, torch.linalg.vector_norm(t_mean, dim=-1)],
                       dim=1)


def flow_statistics(flows):
    """dict of per-frame lists for a (T,Z,Y,X,3) flow stack (tensor or
    array; computed in float32 where it lies)."""
    md, xd, dv, mt = flow_statistics_tensor(
        torch.as_tensor(flows)).T.cpu().tolist()
    return {"mean_disp": md, "max_disp": xd, "mean_div": dv,
            "mean_translation": mt}
