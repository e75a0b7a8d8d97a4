// One red or black half-sweep of the constant-diffusivity (a_smooth == 1)
// SOR solver, fp32, in place on the stacked increments duvw (3, P, M, N).
//
// Replaces: flowreg3d_tpu/core/solver_pallas.py _sweep_kernel (:952,
// through sweep_iterations_pallas) and its y-tiled twin _sweep_kernel_ty
// (:844, through _sweep_iterations_ty). Both compute the same function;
// on this card one kernel serves every plane size.
//
// Function: for every interior cell (z, y, x) with (z + y + x) % 2 == parity
//   n_u  = -(SJ14 + SJ12 dv + SJ13 dw) + sum_dir a_dir * du_nbr
//   du' = (1 - omega) du + omega n_u / (SJ11 + 2 (ax + ay + az))
// and likewise for dv, dw. The base flow's weighted Laplacian is already
// folded into SJ14/24/34 by the host (core/solver_kernel.py). Neighbours
// across a Neumann face read the centre value (clamp). Ring cells are never
// written; the caller applies set_boundary_3d after the last sweep.
//
// Bound: bytes. Per call it reads duvw over the interior (3 fields), SJ at
// the active half (9 fields / 2), and writes the active half of duvw
// (3 fields / 2): 9 x 4 B per interior cell, 21 MB at the (23,170,170)
// level-5 shape, about 6.4 us at 3.35 TB/s; the ~60 flops per active cell
// are far below the fp32 rate. The working set fits the 50 MB L2.
//
// Design: one thread per active-parity interior cell; x runs over pairs so
// no thread idles on the inactive parity. The TPU kernel fuses all
// n_iters x 2 half-sweeps in one launch because its grid runs in order;
// CUDA blocks do not, so the host launches once per half-sweep. In place
// is safe: a half-sweep reads only opposite-parity neighbours, which it
// never writes, and each active cell is read and written by one thread.

#include <cuda_runtime.h>

namespace {

constexpr float kOmega = 1.95f;
// rounded from double, as the plain version and the JAX reference do:
// 1.0f - 1.95f would round differently in the last bit
constexpr float kOneMinusOmega = (float)(1.0 - 1.95);

__global__ void sor_halfsweep_kernel(float* __restrict__ duvw,
                                     const float* __restrict__ sj, int P,
                                     int M, int N, float ax, float ay,
                                     float az, int parity) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y + 1;
  const int z = blockIdx.z + 1;
  if (y > M - 2) return;
  const int x = 1 + ((parity + z + y + 1) & 1) + 2 * k;
  if (x > N - 2) return;

  const long long plane = (long long)M * N;
  const long long vol = plane * P;
  const long long c = ((long long)z * M + y) * N + x;
  const long long oxm = (x == 1) ? 0 : -1;
  const long long oxp = (x == N - 2) ? 0 : 1;
  const long long oym = (y == 1) ? 0 : -(long long)N;
  const long long oyp = (y == M - 2) ? 0 : (long long)N;
  const long long ozm = (z == 1) ? 0 : -plane;
  const long long ozp = (z == P - 2) ? 0 : plane;

  float* du = duvw;
  float* dv = duvw + vol;
  float* dw = duvw + 2 * vol;
  auto nbr_sum = [&](const float* f) {
    return ax * (f[c + oxm] + f[c + oxp]) + ay * (f[c + oym] + f[c + oyp]) +
           az * (f[c + ozm] + f[c + ozp]);
  };

  const float u = du[c], v = dv[c], w = dw[c];
  const float s11 = sj[c], s22 = sj[vol + c], s33 = sj[2 * vol + c];
  const float s12 = sj[3 * vol + c], s13 = sj[4 * vol + c];
  const float s23 = sj[5 * vol + c], s14 = sj[6 * vol + c];
  const float s24 = sj[7 * vol + c], s34 = sj[8 * vol + c];
  const float sw = 2.0f * (ax + ay + az);

  const float nu = -(s14 + s12 * v + s13 * w) + nbr_sum(du);
  const float nv = -(s24 + s12 * u + s23 * w) + nbr_sum(dv);
  const float nw = -(s34 + s13 * u + s23 * v) + nbr_sum(dw);

  du[c] = kOneMinusOmega * u + kOmega * nu / (s11 + sw);
  dv[c] = kOneMinusOmega * v + kOmega * nv / (s22 + sw);
  dw[c] = kOneMinusOmega * w + kOmega * nw / (s33 + sw);
}

}  // namespace

extern "C" int sor_halfsweep_f32(void* duvw, const void* sj, int P, int M,
                                 int N, float ax, float ay, float az,
                                 int parity, void* stream) {
  const int nk = (N - 1) / 2;  // ceil((N - 2) / 2) active x per row
  const dim3 block(32, 8, 1);
  const dim3 grid((nk + block.x - 1) / block.x, (M - 2 + block.y - 1) / block.y,
                  P - 2);
  sor_halfsweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (float*)duvw, (const float*)sj, P, M, N, ax, ay, az, parity & 1);
  return (int)cudaGetLastError();
}
