// The flow-driven-diffusivity (a_smooth != 1) SOR solver, fp32: the
// diffusivity field and the red/black half-sweeps on the unfolded base flow.
//
// Replaces:
//   flowreg3d_tpu/core/solver_pallas.py _sweep_kernel_psi (:247, through
//     sweep_iterations_pallas_psi) and its y-tiled twin _sweep_kernel_psi_ty
//     (:435, through _sweep_iterations_psi_ty): one TPU launch runs n_iters
//     x (psi phase, red phase, black phase); here psi_field_f32 is phase 0
//     and sor_halfsweep_psi_f32 phases 1-2, one launch each, and one kernel
//     serves every plane size;
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
// Numerics: each expression is written operation for operation like the
// plain PyTorch versions in core/solver_psi_kernel.py, in the same order,
// and the library is built with --fmad=false, so kernel and plain version
// round alike (PyTorch rounds a Python scalar operand to float first, as
// the constants below are).
//
// Bound: bytes. psi_field reads base and increments (6 fields) and writes
// psi (1): 28 B a cell, 488 MB at (66, 514, 514), 0.146 ms at 3.35 TB/s.
// The psi half-sweep reads increments, base, SJ and psi at the cells it
// touches (16 fields) and writes the active half of the increments:
// about 70 B an interior cell, 0.364 ms at (66, 514, 514); the constant
// form reads no psi, 0.344 ms. Flops (~120 an active cell) are far below
// the fp32 rate.
//
// Design: one thread per cell (psi) or per active-parity interior cell
// (half-sweeps; x walks pairs, as in sor_halfsweep.cu); neighbour reads go
// through L1/L2. In place on the increments is safe: a half-sweep reads
// only opposite-parity increments, which it never writes. The TPU kernel's
// slab DMAs, (8, 128) padding, in-order grid aliasing and psi seed buffer
// solved VMEM problems this card does not have.

#include <cuda_runtime.h>

namespace {

constexpr float kOmega = 1.95f;
// rounded from double, as the plain version rounds its Python scalars
constexpr float kOneMinusOmega = (float)(1.0 - 1.95);
constexpr float kEpsSmooth = (float)1e-5;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void psi_field_kernel(const float* __restrict__ duvw,
                                 const float* __restrict__ base,
                                 float* __restrict__ psi, int P, int M, int N,
                                 float a, float expo, float ihx, float ihy,
                                 float ihz) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= N || y >= M) return;

  const long long plane = (long long)M * N;
  const long long vol = plane * P;
  // grid neighbours, clamped to the grid (the gradient's clamp)
  const int zm = z > 0 ? z - 1 : 0, zp = z < P - 1 ? z + 1 : P - 1;
  const int ym = y > 0 ? y - 1 : 0, yp = y < M - 1 ? y + 1 : M - 1;
  const int xm = x > 0 ? x - 1 : 0, xp = x < N - 1 ? x + 1 : N - 1;

  auto tot = [&](const float* b, const float* d, int qz, int qy, int qx) {
    const long long q = ((long long)qz * M + qy) * N + qx;
    const long long r = ((long long)clampi(qz, 1, P - 2) * M +
                         clampi(qy, 1, M - 2)) * N + clampi(qx, 1, N - 2);
    return b[q] + d[r];
  };

  float g = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float* b = base + c * vol;
    const float* d = duvw + c * vol;
    const float gz = (tot(b, d, zp, y, x) - tot(b, d, zm, y, x)) * ihz;
    g = g + gz * gz;
    const float gy = (tot(b, d, z, yp, x) - tot(b, d, z, ym, x)) * ihy;
    g = g + gy * gy;
    const float gx = (tot(b, d, z, y, xp) - tot(b, d, z, y, xm)) * ihx;
    g = g + gx * gx;
  }
  const float s = g + kEpsSmooth;
  const float p = (expo == -0.5f) ? rsqrtf(s) : powf(s, expo);
  psi[((long long)z * M + y) * N + x] = a * p;
}

template <bool kPsi>
__global__ void halfsweep_kernel(float* __restrict__ duvw,
                                 const float* __restrict__ base,
                                 const float* __restrict__ sj,
                                 const float* __restrict__ psi, int P, int M,
                                 int N, float ax, float ay, float az,
                                 int parity) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (y > M - 2) return;
  const int x = 1 + ((parity + z + y + 1) & 1) + 2 * k;
  if (x > N - 2) return;

  const long long plane = (long long)M * N;
  const long long vol = plane * P;
  const long long c = ((long long)z * M + y) * N + x;
  const long long off[6] = {-1, 1, -(long long)N, (long long)N, -plane, plane};
  const bool ghost[6] = {x == 1, x == N - 2, y == 1, y == M - 2, z == 1,
                         z == P - 2};

  float wt[6];
  if (kPsi) {
    const float pc = psi[c];
    const float a_dir[6] = {ax, ax, ay, ay, az, az};
    for (int d = 0; d < 6; ++d) wt[d] = 0.5f * (pc + psi[c + off[d]]) * a_dir[d];
  } else {
    wt[0] = ax; wt[1] = ax; wt[2] = ay; wt[3] = ay; wt[4] = az; wt[5] = az;
  }
  const float sw_sum = wt[0] + wt[1] + wt[2] + wt[3] + wt[4] + wt[5];

  float* du = duvw;
  float* dv = duvw + vol;
  float* dw = duvw + 2 * vol;
  const float u0 = du[c], v0 = dv[c], w0 = dw[c];
  const float s11 = sj[c], s22 = sj[vol + c], s33 = sj[2 * vol + c];
  const float s12 = sj[3 * vol + c], s13 = sj[4 * vol + c];
  const float s23 = sj[5 * vol + c], s14 = sj[6 * vol + c];
  const float s24 = sj[7 * vol + c], s34 = sj[8 * vol + c];

  const float nd[3] = {-(s14 + s12 * v0 + s13 * w0),
                       -(s24 + s12 * u0 + s23 * w0),
                       -(s34 + s13 * u0 + s23 * v0)};
  const float den_data[3] = {s11, s22, s33};
  const float old[3] = {u0, v0, w0};

  float out[3];
  for (int comp = 0; comp < 3; ++comp) {
    const float* b = base + comp * vol;
    const float* inc = duvw + comp * vol;
    const float bc = b[c];
    const float ic = old[comp];
    float num = nd[comp];
    for (int d = 0; d < 6; ++d) {
      const long long q = c + off[d];
      const float t = b[q] + (ghost[d] ? ic : inc[q]);
      num = num + wt[d] * (t - bc);
    }
    const float den = den_data[comp] + sw_sum;
    const float frac = (den != 0.0f) ? num / den : 0.0f;
    out[comp] = kOneMinusOmega * ic + kOmega * frac;
  }
  du[c] = out[0];
  dv[c] = out[1];
  dw[c] = out[2];
}

dim3 sweep_grid(int P, int M, int N, dim3 block) {
  const int nk = (N - 1) / 2;  // ceil((N - 2) / 2) active x per row
  return dim3((nk + block.x - 1) / block.x, (M - 2 + block.y - 1) / block.y,
              P - 2);
}

}  // namespace

extern "C" int psi_field_f32(const void* duvw, const void* base, void* psi,
                             int P, int M, int N, float a, float expo,
                             float ihx, float ihy, float ihz, void* stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid((N + block.x - 1) / block.x, (M + block.y - 1) / block.y, P);
  psi_field_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)duvw, (const float*)base, (float*)psi, P, M, N, a, expo,
      ihx, ihy, ihz);
  return (int)cudaGetLastError();
}

extern "C" int sor_halfsweep_psi_f32(void* duvw, const void* base,
                                     const void* sj, const void* psi, int P,
                                     int M, int N, float ax, float ay,
                                     float az, int parity, void* stream) {
  const dim3 block(32, 8, 1);
  halfsweep_kernel<true><<<sweep_grid(P, M, N, block), block, 0,
                           (cudaStream_t)stream>>>(
      (float*)duvw, (const float*)base, (const float*)sj, (const float*)psi,
      P, M, N, ax, ay, az, parity & 1);
  return (int)cudaGetLastError();
}

extern "C" int sor_halfsweep_const_f32(void* duvw, const void* base,
                                       const void* sj, int P, int M, int N,
                                       float ax, float ay, float az,
                                       int parity, void* stream) {
  const dim3 block(32, 8, 1);
  halfsweep_kernel<false><<<sweep_grid(P, M, N, block), block, 0,
                            (cudaStream_t)stream>>>(
      (float*)duvw, (const float*)base, (const float*)sj, nullptr, P, M, N,
      ax, ay, az, parity & 1);
  return (int)cudaGetLastError();
}
