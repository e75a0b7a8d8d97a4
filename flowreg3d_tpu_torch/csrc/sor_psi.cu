// The flow-driven-diffusivity (a_smooth != 1) SOR solver, fp32, one launch
// a phase: the diffusivity field and the red/black half-sweeps on the
// unfolded base flow. The whole-volume tick block runs as one cooperative
// launch (csrc/sor_psi_iterations.cu); these kernels serve the Z-sharded
// solver (parallel/spatial.py), which exchanges ghost rows between phases.
// The per-cell code is csrc/sor_psi_cell.cuh, shared with that kernel.
//
// Replaces:
//   flowreg3d_tpu/core/solver_pallas.py _sweep_kernel_psi (:247): one TPU
//     launch runs n_iters x (psi phase, red phase, black phase); on a slab,
//     psi_field_f32 is phase 0 and sor_halfsweep_psi_f32 phases 1-2;
//   :148 _kernel_psi (through halfsweep_pallas_psi): one half-sweep given
//     psi -> sor_halfsweep_psi_f32;
//   :33 _kernel (through halfsweep_pallas): one a_smooth == 1 half-sweep on
//     the unfolded base -> sor_halfsweep_const_f32, the same kernel with
//     the constant weights a_dir in place of the psi weights.
//
// psi_field_f32, for every cell (z, y, x) of the full (P, M, N) grid, ring
// included:
//   tot_c(q) = base_c(q) + inc_c(clamp(q_z, 1, P-2), clamp(q_y, 1, M-2),
//                                clamp(q_x, 1, N-2))
//   d = (tot_c(q+e) - tot_c(q-e)) * (0.5 / h_e), neighbour indices clamped
//       to the grid (central differences, one-sided at the faces)
//   g = sum over c in (u, v, w), e in (z, y, x) of d * d
//   psi = a * (g + 1e-5)^(a - 1), as a * rsqrt(g + 1e-5) when a == 0.5
// The independent per-axis clamp of the increment is exactly what
// set_boundary_3d's sequence of plane copies produces, so no kernel ever
// has to write the increments' ring.
//
// sor_halfsweep_{psi,const}_f32, for every interior cell with
// (z + y + x) % 2 == parity, per component (u, v, w):
//   w_dir = 0.5 (psi_c + psi_nbr) a_dir    (psi form)  or  a_dir (const)
//   n_u = -(SJ14 + SJ12 dv + SJ13 dw) + sum_dir w_dir (tot_nbr - u_c)
//   du' = (1 - omega) du + omega n_u / (SJ11 + sum_dir w_dir)
// where tot_nbr = u_nbr + du_nbr, and across a Neumann face
// tot_nbr = u_ghost + du_c (the base ring plus the centre increment: the
// value set_boundary_3d would have copied into the increment's ring).
//
// Slab mode (the Z-sharded solver, parallel/spatial.py): a shard holds a
// slab of z-rows with one ghost row on each side, which its neighbours'
// edge rows fill, and three integers place it in the volume:
//   z_off  the global z of its local row 0, so that the red-black parity
//          stays the volume's: (z + z_off + y + x) % 2 == parity;
//   z_lo   the local row of the volume's low Neumann face: 1 when the slab
//          starts the volume, 0 (none) otherwise, when row 0 is a ghost;
//   z_hi   the volume's last interior row in local terms. Rows past it are
//          inert (shard padding), and the high face applies at z_hi.
// psi_field clamps the increment's z to [z_lo, z_hi] (not to [1, P-2]) and
// its z-neighbours to [0, z_hi + 1]; a half-sweep updates rows 1..z_hi and
// takes the face rule at z == z_lo and z == z_hi. The whole volume is the
// slab (0, 1, P-2), and then both kernels do exactly what they did before.
//
// Numerics: each expression is written operation for operation like the
// plain PyTorch versions in core/solver_psi_kernel.py, in the same order,
// and the library is built with --fmad=false, so kernel and plain version
// round alike (csrc/sor_psi_cell.cuh).
//
// Bound: bytes. psi_field reads base and increments (6 fields) and writes
// psi (1): 28 B a cell, 488 MB at (66, 514, 514), 0.146 ms at 3.35 TB/s.
// The psi half-sweep reads increments, base, SJ and psi at the cells it
// touches (16 fields) and writes the active half of the increments:
// about 70 B an interior cell, 0.364 ms at (66, 514, 514); the constant
// form reads no psi, 0.344 ms. Flops (~120 an active cell) are far below
// the fp32 rate.
//
// Design: psi_field_f32 uses 2.5-D blocking (sor_psi::psi_walk): a
// block walks z over a 32 x 8 (x, y) tile and keeps each plane's tot_c in
// shared memory, so base and increments leave device memory about once
// (the one-cell halo rereads mostly hit L2); a small level cuts z into
// chunks, each with its own two-plane prologue, to give the card enough
// blocks (see psi_field_f32). The half-sweeps run one thread per
// active-parity interior cell (x walks pairs, as in
// sor_halfsweep.cu); neighbour reads go through L1/L2. In place on the
// increments is safe: a half-sweep reads only opposite-parity increments,
// which it never writes. The TPU kernel's slab DMAs, (8, 128) padding,
// in-order grid aliasing and psi seed buffer solved VMEM problems this
// card does not have.

#include <cuda_runtime.h>

#include "sor_psi_cell.cuh"

namespace {

using namespace sor_psi;

__global__ void __launch_bounds__(PSI_THREADS)
    psi_field_kernel(const float* __restrict__ duvw,
                     const float* __restrict__ base, float* __restrict__ psi,
                     int P, int M, int N, float a, float expo, float ihx,
                     float ihy, float ihz, int zc, int i_lo, int i_hi,
                     int g_hi) {
  __shared__ float tot[SLOTS][3][HCELLS];
  const int z0 = blockIdx.z * zc;
  psi_walk(tot, duvw, base, psi, P, M, N, a, expo, ihx, ihy, ihz,
           blockIdx.x * PTX, blockIdx.y * PTY, z0, min(z0 + zc, P), i_lo, i_hi,
           g_hi);
}

// blocks of psi_field_kernel resident on the current device, cached
cudaError_t psi_field_slots(int* slots) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, psi_field_kernel, PSI_THREADS, 0);
    if (e != cudaSuccess) return e;
    if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
    cached[dev] = sms * per_sm;
  }
  *slots = cached[dev];
  return cudaSuccess;
}

template <bool kPsi>
__global__ void halfsweep_kernel(float* __restrict__ duvw,
                                 const float* __restrict__ base,
                                 const float* __restrict__ sj,
                                 const float* __restrict__ psi, int P, int M,
                                 int N, float ax, float ay, float az,
                                 int parity, int z_off, int z_lo, int z_hi) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (y > M - 2 || z > z_hi) return;
  const int x = 1 + ((parity + z + z_off + y + 1) & 1) + 2 * k;
  if (x > N - 2) return;
  halfsweep_cell<kPsi>(duvw, base, sj, psi, P, M, N, ax, ay, az, z, y, x,
                       z_lo, z_hi);
}

dim3 sweep_grid(int P, int M, int N, dim3 block) {
  const int nk = (N - 1) / 2;  // ceil((N - 2) / 2) active x per row
  return dim3((nk + block.x - 1) / block.x, (M - 2 + block.y - 1) / block.y,
              P - 2);
}

}  // namespace

extern "C" int psi_field_f32(const void* duvw, const void* base, void* psi,
                             int P, int M, int N, float a, float expo,
                             float ihx, float ihy, float ihz, int z_lo,
                             int z_hi, void* stream) {
  // Chunks of z: a block's time is about its planes (two of prologue and
  // zc walked) times a latency-bound step, so take the chunk count that
  // minimises rounds of resident blocks x (zc + 2); a large level walks
  // all of z in one chunk, a small one splits z to fill the card.
  if ((long long)M * N > 2147483647LL) return (int)cudaErrorInvalidValue;
  int slots = 0;
  const cudaError_t e = psi_field_slots(&slots);
  if (e != cudaSuccess) return (int)e;
  const dim3 block(PTX, PTY, 1);
  const int tiles_x = (N + PTX - 1) / PTX, tiles_y = (M + PTY - 1) / PTY;
  const long long tiles = (long long)tiles_x * tiles_y;
  int zc = P;
  long long best = -1;
  for (int chunks = 1; chunks <= P; ++chunks) {
    const int c = (P + chunks - 1) / chunks;
    const long long blocks = tiles * ((P + c - 1) / c);
    const long long cost = (blocks + slots - 1) / slots * (c + 2);
    if (best < 0 || cost < best) best = cost, zc = c;
  }
  const dim3 grid(tiles_x, tiles_y, (P + zc - 1) / zc);
  // the slab's clamps, kept inside the grid whatever the slab (a shard
  // wholly past the volume's end has z_hi < 0: its rows are inert)
  const int i_lo = z_lo == 1 ? 1 : 0;
  const int i_hi = z_hi < i_lo ? i_lo : (z_hi > P - 1 ? P - 1 : z_hi);
  const int g_hi = z_hi + 1 < 0 ? 0 : (z_hi + 1 > P - 1 ? P - 1 : z_hi + 1);
  psi_field_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)duvw, (const float*)base, (float*)psi, P, M, N, a, expo,
      ihx, ihy, ihz, zc, i_lo, i_hi, g_hi);
  return (int)cudaGetLastError();
}

extern "C" int sor_halfsweep_psi_f32(void* duvw, const void* base,
                                     const void* sj, const void* psi, int P,
                                     int M, int N, float ax, float ay,
                                     float az, int parity, int z_off,
                                     int z_lo, int z_hi, void* stream) {
  const dim3 block(32, 8, 1);
  halfsweep_kernel<true><<<sweep_grid(P, M, N, block), block, 0,
                           (cudaStream_t)stream>>>(
      (float*)duvw, (const float*)base, (const float*)sj, (const float*)psi,
      P, M, N, ax, ay, az, parity & 1, z_off & 1, z_lo, z_hi);
  return (int)cudaGetLastError();
}

extern "C" int sor_halfsweep_const_f32(void* duvw, const void* base,
                                       const void* sj, int P, int M, int N,
                                       float ax, float ay, float az,
                                       int parity, int z_off, int z_lo,
                                       int z_hi, void* stream) {
  const dim3 block(32, 8, 1);
  halfsweep_kernel<false><<<sweep_grid(P, M, N, block), block, 0,
                            (cudaStream_t)stream>>>(
      (float*)duvw, (const float*)base, (const float*)sj, nullptr, P, M, N,
      ax, ay, az, parity & 1, z_off & 1, z_lo, z_hi);
  return (int)cudaGetLastError();
}
