// Per-cell code of the flow-driven-diffusivity SOR, fp32, shared by
// csrc/sor_psi.cu (one launch a phase) and csrc/sor_psi_iterations.cu
// (one cooperative launch a tick block): the psi field's walk of one tile
// and the update of one active cell of a half-sweep. Each expression is
// written operation for operation like the plain PyTorch versions in
// core/solver_psi_kernel.py, in the same order, and the library is built
// with --fmad=false, so kernel and plain version round alike (PyTorch
// rounds a Python scalar operand to float first, as the constants below
// are).
#pragma once

#include <cuda_runtime.h>

namespace sor_psi {

constexpr float kOmega = 1.95f;
// rounded from double, as the plain version rounds its Python scalars
constexpr float kOneMinusOmega = (float)(1.0 - 1.95);
constexpr float kEpsSmooth = (float)1e-5;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// psi_walk: a block of PTX x PTY threads owns a PTY x PTX tile of (y, x)
// at (y0, x0) and walks planes [z0, z1). Each plane's tot_c = base_c +
// inc_c(clamped), for u, v and w, is computed once per cell into a ring of
// shared-memory planes with a one-cell halo (clamped to the grid, which is
// the gradient's clamp); the z-gradient reads the planes above and below,
// the y- and x-gradients the halo of the current one. Each thread holds the
// next two planes' base and increments for its halo cells in registers, so
// the loads of plane z + 3 are in flight while plane z is computed; one
// barrier a plane.
constexpr int PTX = 32, PTY = 8;           // cells of a tile
constexpr int HX = PTX + 2, HY = PTY + 2;  // with the halo
constexpr int HCELLS = HX * HY;
constexpr int PSI_THREADS = PTX * PTY;
constexpr int FETCH = (HCELLS + PSI_THREADS - 1) / PSI_THREADS;
constexpr int SLOTS = 4;  // planes z-1, z, z+1 read while z+2 is stored

// psi of the tile's cells of planes [z0, z1) into psi (P, M, N); the
// increments' z clamped to [i_lo, i_hi], the grid's to [0, g_hi] (the
// whole volume: 1, P-2, P-1). Leaves tot in use: a block that walks again
// synchronises first.
__device__ __forceinline__ void psi_walk(
    float (&tot)[SLOTS][3][HCELLS], const float* duvw, const float* base,
    float* psi, int P, int M, int N, float a, float expo, float ihx,
    float ihy, float ihz, int x0, int y0, int z0, int z1, int i_lo,
    int i_hi, int g_hi) {
  const int tid = threadIdx.y * PTX + threadIdx.x;
  const long long plane = (long long)M * N;
  const long long vol = plane * P;

  // this thread's halo cells: base offset q and clamped increment offset r
  // within a plane (the launcher checks that a plane's offsets fit an int)
  int qo[FETCH], ro[FETCH];
  bool on[FETCH];
#pragma unroll
  for (int l = 0; l < FETCH; ++l) {
    const int i = tid + l * PSI_THREADS;
    on[l] = i < HCELLS;
    const int y = clampi(y0 + i / HX - 1, 0, M - 1);
    const int x = clampi(x0 + i % HX - 1, 0, N - 1);
    qo[l] = y * N + x;
    ro[l] = clampi(y, 1, M - 2) * N + clampi(x, 1, N - 2);
  }
  float b0[FETCH][3], d0[FETCH][3], b1[FETCH][3], d1[FETCH][3];
  auto fetch = [&](int q, float (&b)[FETCH][3], float (&d)[FETCH][3]) {
    // plane q, clamped to the grid (to z_hi + 1 in a slab past the volume's
    // high face); its increment's z clamped to [z_lo, z_hi]
    const int zq = clampi(q, 0, g_hi);
    const long long bo = zq * plane, io = clampi(zq, i_lo, i_hi) * plane;
#pragma unroll
    for (int l = 0; l < FETCH; ++l)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (on[l]) {
          b[l][c] = base[c * vol + bo + qo[l]];
          d[l][c] = duvw[c * vol + io + ro[l]];
        }
  };
  auto store = [&](int q, const float (&b)[FETCH][3],
                   const float (&d)[FETCH][3]) {  // q >= -1
    const int s = (q + SLOTS) % SLOTS;
#pragma unroll
    for (int l = 0; l < FETCH; ++l)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (on[l]) tot[s][c][tid + l * PSI_THREADS] = b[l][c] + d[l][c];
  };
  const int y = y0 + threadIdx.y, x = x0 + threadIdx.x;
  const int own = (threadIdx.y + 1) * HX + threadIdx.x + 1;
  auto compute = [&](int z) {
    const int sm = (z + SLOTS - 1) % SLOTS, s0 = z % SLOTS,
              sp = (z + 1) % SLOTS;
    float g = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gz = (tot[sp][c][own] - tot[sm][c][own]) * ihz;
      g = g + gz * gz;
      const float gy = (tot[s0][c][own + HX] - tot[s0][c][own - HX]) * ihy;
      g = g + gy * gy;
      const float gx = (tot[s0][c][own + 1] - tot[s0][c][own - 1]) * ihx;
      g = g + gx * gx;
    }
    if (y < M && x < N) {
      const float s = g + kEpsSmooth;
      const float p = (expo == -0.5f) ? rsqrtf(s) : powf(s, expo);
      psi[((long long)z * M + y) * N + x] = a * p;
    }
  };

  fetch(z0 - 1, b0, d0);
  store(z0 - 1, b0, d0);
  fetch(z0, b0, d0);
  store(z0, b0, d0);
  fetch(z0 + 1, b0, d0);
  fetch(z0 + 2, b1, d1);
  for (int z = z0; z < z1; z += 2) {  // b0/d0 hold plane z+1, b1/d1 z+2
    store(z + 1, b0, d0);
    __syncthreads();
    if (z + 2 < z1) fetch(z + 3, b0, d0);
    compute(z);
    if (z + 1 < z1) {
      store(z + 2, b1, d1);
      __syncthreads();
      if (z + 3 < z1) fetch(z + 4, b1, d1);
      compute(z + 1);
    }
  }
}

// One active cell (z, y, x) of a half-sweep, in place on duvw:
//   w_dir = 0.5 (psi_c + psi_nbr) a_dir    (kPsi)  or  a_dir
//   n_u = -(SJ14 + SJ12 dv + SJ13 dw) + sum_dir w_dir (tot_nbr - u_c)
//   du' = (1 - omega) du + omega n_u / (SJ11 + sum_dir w_dir)
// with tot_nbr = u_nbr + du_nbr, and across a Neumann face (x or y at the
// ring's edge, z at z_lo or z_hi) u_ghost + du_c. The pointers carry no
// __restrict__: a cooperative kernel reads here what other blocks wrote
// before its last grid.sync(), which the non-coherent read path may not
// see.
template <bool kPsi>
__device__ __forceinline__ void halfsweep_cell(
    float* duvw, const float* base, const float* sj, const float* psi, int P,
    int M, int N, float ax, float ay, float az, int z, int y, int x, int z_lo,
    int z_hi) {
  const long long plane = (long long)M * N;
  const long long vol = plane * P;
  const long long c = ((long long)z * M + y) * N + x;
  const long long off[6] = {-1, 1, -(long long)N, (long long)N, -plane, plane};
  const bool ghost[6] = {x == 1, x == N - 2, y == 1, y == M - 2, z == z_lo,
                         z == z_hi};

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

}  // namespace sor_psi
