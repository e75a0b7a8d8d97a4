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
// Design: psi_field_f32 uses 2.5-D blocking (see psi_field_kernel): a
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

namespace {

constexpr float kOmega = 1.95f;
// rounded from double, as the plain version rounds its Python scalars
constexpr float kOneMinusOmega = (float)(1.0 - 1.95);
constexpr float kEpsSmooth = (float)1e-5;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// psi_field_kernel: a block owns a PTY x PTX tile of (y, x) and walks a
// chunk of z. Each plane's tot_c = base_c + inc_c(clamped), for u, v and w,
// is computed once per cell into a ring of shared-memory planes with a
// one-cell halo (clamped to the grid, which is the gradient's clamp); the
// z-gradient reads the planes above and below, the y- and x-gradients the
// halo of the current one. Each thread holds the next two planes' base and
// increments for its halo cells in registers, so the loads of plane z + 3
// are in flight while plane z is computed; one barrier a plane.
constexpr int PTX = 32, PTY = 8;           // cells of a tile
constexpr int HX = PTX + 2, HY = PTY + 2;  // with the halo
constexpr int HCELLS = HX * HY;
constexpr int PSI_THREADS = PTX * PTY;
constexpr int FETCH = (HCELLS + PSI_THREADS - 1) / PSI_THREADS;
constexpr int SLOTS = 4;  // planes z-1, z, z+1 read while z+2 is stored

__global__ void __launch_bounds__(PSI_THREADS)
    psi_field_kernel(const float* __restrict__ duvw,
                     const float* __restrict__ base, float* __restrict__ psi,
                     int P, int M, int N, float a, float expo, float ihx,
                     float ihy, float ihz, int zc) {
  __shared__ float tot[SLOTS][3][HCELLS];
  const int tid = threadIdx.y * PTX + threadIdx.x;
  const int x0 = blockIdx.x * PTX, y0 = blockIdx.y * PTY;
  const int z0 = blockIdx.z * zc, z1 = min(z0 + zc, P);
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
    const int zq = clampi(q, 0, P - 1);  // plane q, clamped to the grid
    const long long bo = zq * plane, io = clampi(zq, 1, P - 2) * plane;
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
  psi_field_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)duvw, (const float*)base, (float*)psi, P, M, N, a, expo,
      ihx, ihy, ihz, zc);
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
