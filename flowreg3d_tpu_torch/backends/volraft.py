"""volRAFT-style sliding-window deep-flow backends.

Counterpart of ``flowreg3d_tpu/backends/volraft.py``: the reference runs
VolRAFT (a 3D RAFT-family CNN) by tiling the volume into overlapping
patches, running the network per patch pair and blending the patch flows
back into a dense field with a raised-cosine window.

- ``PatchInferenceHarness``: the tiling and blending, model-agnostic. The
  pair is uploaded once to ``device`` (None means 'cuda'), an initial
  ``uvw`` pre-warps the moving volume (trilinear, mode 'nearest': the
  port's ``map_coordinates_linear`` on coordinates clamped to the grid),
  patches are slices of the uploaded pair, and the flows are blended in
  float64 on the device, patch by patch in the JAX package's order;
  float32 numpy out;
- ``VolRAFTBackend``: a TorchScript checkpoint mapping a ``(1, 2, D, H, W)``
  fixed/moving patch pair to ``(1, 3, D, H, W)`` flow (dx, dy, dz, voxel
  units), one patch pair per call, as the checkpoint's contract says;
- ``PatchRigidFlowBackend``: the dependency-free stand-in, one subpixel
  rigid shift per patch by 3D phase correlation (``torch.fft`` in
  complex128), every patch of a volume in batches bounded in memory, and
  its constant-per-patch flows blended as three separable contractions;
- ``load_volraft``: checkpoint discovery honouring
  ``VOLRAFT_CHECKPOINT_DIR``, falling back to the stand-in.
"""

import os

import numpy as np
import torch

from flowreg3d_tpu_torch._device import resolve_device
from flowreg3d_tpu_torch.ops.warp import map_coordinates_linear

# voxels of the patches whose phase correlation runs in one batch (about
# 2.4 GB of float64 / complex128 work buffers)
_PATCH_BATCH_VOXELS = 2 ** 25


def _cosine_axis(n):
    t = (np.arange(n) + 0.5) / n
    return 0.05 + 0.95 * np.sin(np.pi * t) ** 2


def _cosine_window(shape):
    """Separable raised-cosine blending weights, strictly positive."""
    ws = [_cosine_axis(n) for n in shape]
    return ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]


class PatchInferenceHarness:
    """Tile a volume pair into overlapping patches, infer, blend flows.

    ``infer_patch(fixed_patch, moving_patch) -> (pz, py, px, 3)`` is
    supplied by the concrete backend; the patches are float32 tensors on
    ``device``. ``use_kernels`` selects the CUDA warp kernel (True) or its
    plain version for the ``uvw`` pre-warp.
    """

    def __init__(self, patch_size=(16, 32, 32), overlap=0.67, device=None,
                 use_kernels=True):
        self.patch_size = tuple(int(p) for p in patch_size)
        self.overlap = float(overlap)
        self.device = resolve_device(device)
        self.use_kernels = bool(use_kernels)

    def _starts(self, dim, patch):
        if dim <= patch:
            return [0]
        step = max(1, int(round(patch * (1.0 - self.overlap))))
        starts = list(range(0, dim - patch + 1, step))
        if starts[-1] != dim - patch:
            starts.append(dim - patch)
        return starts

    def infer_patch(self, fixed_patch, moving_patch):
        raise NotImplementedError

    def _upload(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    def _prewarp(self, moving, base):
        """``moving`` sampled at x + base(x), trilinear, mode 'nearest'."""
        Z, Y, X = moving.shape

        def coord(n, shape, d):
            grid = torch.arange(n, dtype=torch.float32, device=self.device)
            return (grid.reshape(shape) + d).clamp(0, n - 1).contiguous()

        return map_coordinates_linear(
            moving.contiguous(), coord(Z, (Z, 1, 1), base[..., 2]),
            coord(Y, (1, Y, 1), base[..., 1]),
            coord(X, (1, 1, X), base[..., 0]), self.use_kernels)

    def __call__(self, fixed, moving, uvw=None, **params):
        fixed = self._upload(fixed)
        moving = self._upload(moving)
        if fixed.dim() == 4:  # collapse channels for flow estimation
            fixed = fixed.mean(dim=-1)
            moving = moving.mean(dim=-1)
        # uvw is an INITIAL GUESS (get_displacement semantics): pre-warp
        # moving by it, estimate the residual, return the total
        base = None
        if uvw is not None:
            base = self._upload(uvw)
            if bool(base.any()):
                moving = self._prewarp(moving, base)
            else:
                base = None
        Z, Y, X = fixed.shape
        patch = (min(self.patch_size[0], Z), min(self.patch_size[1], Y),
                 min(self.patch_size[2], X))
        starts = [self._starts(n, p) for n, p in zip((Z, Y, X), patch)]
        acc, wsum = self._blend(fixed, moving, starts, patch)
        out = (acc / wsum).to(torch.float32)
        if base is not None:
            out = out + base
        return out.cpu().numpy()

    def _blend(self, fixed, moving, starts, patch):
        """Window-weighted flow sum (Z,Y,X,3) and weight sum (Z,Y,X,1),
        float64, one patch at a time in the JAX package's order."""
        Z, Y, X = fixed.shape
        acc = torch.zeros((Z, Y, X, 3), dtype=torch.float64,
                          device=self.device)
        wsum = torch.zeros((Z, Y, X, 1), dtype=torch.float64,
                           device=self.device)
        win = torch.from_numpy(_cosine_window(patch)[..., None]).to(
            self.device)
        pz, py, px = patch
        for z0 in starts[0]:
            for y0 in starts[1]:
                for x0 in starts[2]:
                    sl = (slice(z0, z0 + pz), slice(y0, y0 + py),
                          slice(x0, x0 + px))
                    flow = torch.as_tensor(
                        self.infer_patch(fixed[sl], moving[sl])).to(
                            device=self.device, dtype=torch.float64)
                    acc[sl] += flow * win
                    wsum[sl] += win
        return acc, wsum


def _phase_shifts(a, b):
    """Subpixel 3D phase correlation of each patch pair of the float32
    batches ``a``, ``b`` (B, pz, py, px): the content shift s (B, 3) as
    (sz, sy, sx), float64, with ``moving(p) ~= fixed(p - s)``; the
    backward flow equals s."""
    B = a.shape[0]
    shape = tuple(a.shape[1:])
    dims = (1, 2, 3)

    def prepared(v):
        # the mean in float32 (as numpy's), then the Hann window per axis
        v = (v - v.double().mean(dim=dims, keepdim=True).float()).double()
        for ax, n in enumerate(shape):
            w = torch.from_numpy(np.hanning(n)).to(v.device)
            view = [1, 1, 1, 1]
            view[ax + 1] = n
            v = v * w.reshape(view)
        return v

    R = (torch.fft.fftn(prepared(a), dim=dims)
         * torch.conj(torch.fft.fftn(prepared(b), dim=dims)))
    R = R / torch.clamp(R.abs(), min=1e-12)
    r = torch.fft.ifftn(R, dim=dims).real
    flat = r.reshape(B, -1).argmax(dim=1)        # the first maximum
    idx = []
    for n in reversed(shape):
        idx.append(flat % n)
        flat = flat // n
    idx = idx[::-1]                              # (iz, iy, ix), each (B,)
    batch = torch.arange(B, device=a.device)
    c0 = r[batch, idx[0], idx[1], idx[2]]
    out = []
    for ax, n in enumerate(shape):
        nb = list(idx)
        nb[ax] = (idx[ax] - 1) % n
        cm = r[batch, nb[0], nb[1], nb[2]]
        nb[ax] = (idx[ax] + 1) % n
        cp = r[batch, nb[0], nb[1], nb[2]]
        denom = 2.0 * c0 - cm - cp
        delta = torch.where(denom.abs() > 1e-12, 0.5 * (cp - cm) / denom,
                            torch.zeros_like(denom))
        p = idx[ax].double() + delta.clamp(-1.0, 1.0)
        p = torch.where(p > n / 2, p - n, p)
        # the correlation peaks at MINUS the content shift
        out.append(-p)
    return torch.stack(out, dim=1)


class PatchRigidFlowBackend(PatchInferenceHarness):
    """Mock volRAFT: one subpixel rigid shift per patch, blended dense.

    Every patch has one shape (the last start is clamped), so the phase
    correlations run in batches; a constant flow per patch makes the
    blend separable: three contractions with the per-axis windows.
    """

    def infer_patch(self, fixed_patch, moving_patch):
        s = _phase_shifts(self._upload(fixed_patch)[None],
                          self._upload(moving_patch)[None])[0]
        flow = s.flip(0).to(torch.float32)       # (dx, dy, dz)
        return flow.expand(tuple(fixed_patch.shape) + (3,))

    def patch_shifts(self, fixed, moving, starts, patch):
        """(nz, ny, nx, 3) content shifts (sz, sy, sx) of every patch."""
        grids = [torch.as_tensor(s, device=self.device)[:, None]
                 + torch.arange(p, device=self.device)
                 for s, p in zip(starts, patch)]           # (n_a, p_a)
        counts = [len(s) for s in starts]
        n = counts[0] * counts[1] * counts[2]
        chunk = max(1, _PATCH_BATCH_VOXELS // (patch[0] * patch[1]
                                               * patch[2]))
        shifts = []
        for lo in range(0, n, chunk):
            k = torch.arange(lo, min(n, lo + chunk), device=self.device)
            iz = grids[0][k // (counts[1] * counts[2])][:, :, None, None]
            iy = grids[1][(k // counts[2]) % counts[1]][:, None, :, None]
            ix = grids[2][k % counts[2]][:, None, None, :]
            shifts.append(_phase_shifts(fixed[iz, iy, ix],
                                        moving[iz, iy, ix]))
        return torch.cat(shifts).reshape(*counts, 3)

    def _blend(self, fixed, moving, starts, patch):
        S = self.patch_shifts(fixed, moving, starts, patch).flip(-1)
        mats = []
        for s, p, n in zip(starts, patch, fixed.shape):
            # rows: the window of the patch starting at s[i], placed
            m = torch.zeros((len(s), n), dtype=torch.float64)
            w = torch.from_numpy(_cosine_axis(p))
            for i, s0 in enumerate(s):
                m[i, s0:s0 + p] = w
            mats.append(m.to(self.device))
        mz, my, mx = mats
        acc = torch.einsum("ijkc,kx->ijxc", S, mx)
        acc = torch.einsum("ijxc,jy->iyxc", acc, my)
        acc = torch.einsum("iyxc,iz->zyxc", acc, mz)
        wsum = (mz.sum(0)[:, None, None] * my.sum(0)[None, :, None]
                * mx.sum(0)[None, None, :])[..., None]
        return acc, wsum


class VolRAFTBackend(PatchInferenceHarness):
    """TorchScript volRAFT checkpoint on ``device`` (None means 'cuda').

    The checkpoint must be a scripted module taking ``(1, 2, D, H, W)``
    float32 (fixed, moving stacked on channel) and returning
    ``(1, 3, D, H, W)`` flow in (dx, dy, dz) voxel units. It is the user's
    own network, run one patch pair per call.
    """

    def __init__(self, checkpoint_path, patch_size=(16, 64, 64),
                 overlap=0.5, device=None, use_kernels=True):
        super().__init__(patch_size, overlap, device, use_kernels)
        self.model = torch.jit.load(str(checkpoint_path),
                                    map_location=self.device)
        self.model.eval()

    def infer_patch(self, fixed_patch, moving_patch):
        with torch.no_grad():
            pair = torch.stack([fixed_patch, moving_patch])[None]
            flow = self.model(pair)[0]  # (3, D, H, W)
        return flow.movedim(0, -1)


def load_volraft(checkpoint_dir=None, **kwargs):
    """Load a VolRAFT checkpoint (env ``VOLRAFT_CHECKPOINT_DIR`` honoured);
    falls back to the rigid stand-in when no checkpoint exists."""
    checkpoint_dir = checkpoint_dir or os.environ.get(
        "VOLRAFT_CHECKPOINT_DIR")
    if checkpoint_dir:
        for name in ("volraft.pt", "volraft_scripted.pt", "model.pt"):
            p = os.path.join(checkpoint_dir, name)
            if os.path.isfile(p):
                return VolRAFTBackend(p, **kwargs)
    return PatchRigidFlowBackend(**kwargs)


def _register():
    from flowreg3d_tpu_torch.runtime import register_flow_backend

    register_flow_backend("volraft", load_volraft)
    register_flow_backend("volraft-mock", PatchRigidFlowBackend)


_register()
