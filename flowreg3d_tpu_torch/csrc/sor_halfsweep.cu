// A tick block of the constant-diffusivity (a_smooth == 1) SOR solver:
// n_iters red+black iterations, fp32, in place on the stacked increments
// duvw (3, P, M, N), in ONE cooperative launch.
//
// Replaces: flowreg3d_tpu/core/solver_pallas.py _sweep_kernel (:952,
// through sweep_iterations_pallas, "n_iters full red-black iterations in
// ONE pallas_call") and its y-tiled twin _sweep_kernel_ty (:844, through
// _sweep_iterations_ty). Both compute the same function; on this card one
// kernel serves every plane size.
//
// Function: per half-sweep, for every interior cell (z, y, x) with
// (z + y + x) % 2 == parity (red 0, then black 1, n_iters times)
//   n_u  = -(SJ14 + SJ12 dv + SJ13 dw) + sum_dir a_dir * du_nbr
//   du' = (1 - omega) du + omega n_u / (SJ11 + 2 (ax + ay + az))
// and likewise for dv, dw, with SJ (9, P, M, N) in the order [SJ11, SJ22,
// SJ33, SJ12, SJ13, SJ23, SJ14, SJ24, SJ34]. The base flow's weighted
// Laplacian is already folded into SJ14/24/34 by the host
// (core/solver_kernel.py). Neighbours across a Neumann face read the
// centre value (clamp). Ring cells are never written; the caller applies
// set_boundary_3d after the level's last tick block.
//
// Bound: bytes. Per tick block each input is read once and the output
// written once: SJ 36 B plus duvw 12 B read and 12 B written per interior
// cell, 35.6 MB at the (21,168,168) canonical level, about 10.6 us at
// 3.35 TB/s; the ~60 flops per cell and half-sweep stay far below the
// fp32 rate.
//
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel),
// its grid sized by the occupancy calculator so that every block is
// resident; grid.sync() between half-sweeps (2 n_iters - 1 a launch)
// orders the colours as consecutive launches did. In place is safe: a
// half-sweep reads only opposite-parity neighbours, which it never writes,
// and each active cell is read and written by one thread. Two modes,
// chosen by size (plan_sor):
//  (a) SJ on chip: when the SJ of the interior rows fits the resident
//      blocks' shared memory (every canonical level), each block owns a
//      fixed run of rows and copies their SJ there once per launch
//      (cp.async), split by x parity so that a half-sweep's reads are
//      unit-stride; duvw (<= 8 MB at those levels) is read from L2;
//  (b) SJ streamed: larger levels read SJ from device memory at every
//      half-sweep, the blocks walking the volume's tiles in the order one
//      launch per half-sweep dispatched them.
// If the cooperative launch is refused, the error is returned (the
// wrapper raises); nothing falls back to one launch per half-sweep.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr float kOmega = 1.95f;
// rounded from double, as the plain version and the JAX reference do:
// 1.0f - 1.95f would round differently in the last bit
constexpr float kOneMinusOmega = (float)(1.0 - 1.95);
constexpr int kThreads = 512;
// mode (b): blocks an SM; at (66,514,514) one 512-thread block an SM
// streamed faster than two or four (a narrower band of the volume in
// flight)
constexpr int kStreamedPerSM = 1;

enum SorMode { kOnChip = 1, kStreamed = 2 };

struct SorPlan {
  int mode;    // kOnChip or kStreamed
  int grid;    // blocks, all resident
  int rpb;     // interior (z, y) rows per block
  int smem;    // dynamic shared memory per block, bytes
};

// operation for operation the plain version's update of one cell
__device__ __forceinline__ void update_cell(float* duvw, long long vol,
                                            long long c, long long oxm,
                                            long long oxp, long long oym,
                                            long long oyp, long long ozm,
                                            long long ozp, const float s[9],
                                            float ax, float ay, float az,
                                            float sw) {
  float* du = duvw;
  float* dv = duvw + vol;
  float* dw = duvw + 2 * vol;
  auto nbr_sum = [&](const float* f) {
    return ax * (f[c + oxm] + f[c + oxp]) + ay * (f[c + oym] + f[c + oyp]) +
           az * (f[c + ozm] + f[c + ozp]);
  };
  const float u = du[c], v = dv[c], w = dw[c];
  const float nu = -(s[6] + s[3] * v + s[4] * w) + nbr_sum(du);
  const float nv = -(s[7] + s[3] * u + s[5] * w) + nbr_sum(dv);
  const float nw = -(s[8] + s[4] * u + s[5] * v) + nbr_sum(dw);
  du[c] = kOneMinusOmega * u + kOmega * nu / (s[0] + sw);
  dv[c] = kOneMinusOmega * v + kOmega * nv / (s[1] + sw);
  dw[c] = kOneMinusOmega * w + kOmega * nw / (s[2] + sw);
}

// Interior rows r of the (P-2)(M-2) in the volume: z = 1 + r / (M-2),
// y = 1 + r % (M-2). A row holds H = (N-1)/2 slots k; slot k of parity p
// is x = 1 + q + 2k, q = (p + z + y + 1) & 1, skipped when x > N-2.
// Mode (a): block b owns rows [b * rpb, b * rpb + rpb) and strides over
// their slots; field f of local row lr at interior x - 1 = q + 2k sits at
// sj_s[((f * rpb + lr) * 2 + q) * H + k]. Mode (b): the blocks stride
// together over tiles of 32 slots x kThreads/32 rows in the order one launch
// per half-sweep dispatched its blocks, so the cells in flight form one
// band of the volume and a block's y neighbours are mostly its own.
template <bool kOnChipSJ>
__global__ void __launch_bounds__(kThreads)
    sor_iterations_kernel(float* duvw, const float* __restrict__ sj, int P,
                          int M, int N, float ax, float ay, float az,
                          int n_iters, int rpb) {
  extern __shared__ float sj_s[];
  const int Mi = M - 2;
  const int H = (N - 1) / 2;
  const int rows = (P - 2) * Mi;
  const long long plane = (long long)M * N;
  const long long vol = plane * P;
  const int r0 = kOnChipSJ ? blockIdx.x * rpb : 0;
  const int nrows = kOnChipSJ ? min(rpb, rows - r0) : rows;

  if constexpr (kOnChipSJ) {
    // asynchronous copies: a row's loads are all in flight at once
    const int lane = threadIdx.x & 31;
    for (int fr = threadIdx.x >> 5; fr < 9 * nrows; fr += kThreads / 32) {
      const int f = fr / nrows;
      const int lr = fr - f * nrows;
      const int r = r0 + lr;
      const int z = 1 + r / Mi;
      const int y = 1 + r - (z - 1) * Mi;
      const float* src = sj + f * vol + ((long long)z * M + y) * N + 1;
      float* dst = sj_s + (size_t)(f * rpb + lr) * 2 * H;
      for (int xi = lane; xi < N - 2; xi += 32)
        __pipeline_memcpy_async(dst + (xi & 1) * H + (xi >> 1), src + xi, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  const float sw = 2.0f * (ax + ay + az);
  // slot k of local row lr at this parity
  auto relax = [&](int lr, int k, int parity) {
    const int r = r0 + lr;
    const int z = 1 + r / Mi;
    const int y = 1 + r - (z - 1) * Mi;
    const int q = (parity + z + y + 1) & 1;
    const int x = 1 + q + 2 * k;
    if (x > N - 2) return;
    const long long c = ((long long)z * M + y) * N + x;
    float s[9];
    if constexpr (kOnChipSJ) {
      const float* p = sj_s + (size_t)(lr * 2 + q) * H + k;
      const size_t fstride = (size_t)rpb * 2 * H;
#pragma unroll
      for (int f = 0; f < 9; ++f) s[f] = p[f * fstride];
    } else {
#pragma unroll
      for (int f = 0; f < 9; ++f) s[f] = sj[f * vol + c];
    }
    update_cell(duvw, vol, c, (x == 1) ? 0 : -1, (x == N - 2) ? 0 : 1,
                (y == 1) ? 0 : -(long long)N, (y == M - 2) ? 0 : (long long)N,
                (z == 1) ? 0 : -plane, (z == P - 2) ? 0 : plane, s, ax, ay,
                az, sw);
  };

  cg::grid_group grid = cg::this_grid();
  constexpr int kTileRows = kThreads / 32;
  const int tiles_k = (H + 31) / 32;
  const int tiles = tiles_k * ((nrows + kTileRows - 1) / kTileRows);
  for (int half = 0; half < 2 * n_iters; ++half) {
    if (half > 0) grid.sync();
    const int parity = half & 1;
    if constexpr (kOnChipSJ) {
      for (int i = threadIdx.x; i < nrows * H; i += kThreads) {
        const int lr = i / H;
        relax(lr, i - lr * H, parity);
      }
    } else {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int tr = t / tiles_k;
        const int k = (t - tr * tiles_k) * 32 + (threadIdx.x & 31);
        const int lr = tr * kTileRows + (threadIdx.x >> 5);
        if (k < H && lr < nrows) relax(lr, k, parity);
      }
    }
  }
}

template <bool kOnChipSJ>
const void* kernel_ptr() {
  return (const void*)sor_iterations_kernel<kOnChipSJ>;
}

// The size rule. Mode (a) when the rows' SJ, split over b blocks an SM
// (b = 1 .. the occupancy without shared memory), fits a block's shared
// memory with b such blocks resident on every SM; of those b, the least
// that gives the fewest slots a thread must update a half-sweep: every SM
// gets the same number of blocks (the grid sync waits for the busiest SM),
// and fewer blocks make cheaper syncs. Else mode (b), kStreamedPerSM blocks
// an SM (at most one per tile).
cudaError_t plan_sor(int P, int M, int N, SorPlan* plan) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)(P - 2) * (M - 2);
  const long long H = (N - 1) / 2;
  const long long row_bytes = 9LL * 2 * H * (long long)sizeof(float);
  const void* on_chip = kernel_ptr<true>();
  e = cudaFuncSetAttribute(
      on_chip, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  int occ = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, on_chip,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  long long best_passes = 0;
  for (int b = 1; b <= occ; ++b) {
    const long long blocks = (long long)b * sms;
    const long long rpb = (rows + blocks - 1) / blocks;
    const long long smem = rpb * row_bytes;
    if (smem > optin) continue;   // more blocks need less
    int fit = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, on_chip,
                                                      kThreads, (size_t)smem);
    if (e != cudaSuccess) return e;
    const long long grid = (rows + rpb - 1) / rpb;
    if ((long long)fit * sms < grid) continue;
    const long long passes = (rpb * H + kThreads - 1) / kThreads;
    if (best_passes == 0 || passes < best_passes) {
      best_passes = passes;
      *plan = {kOnChip, (int)grid, (int)rpb, (int)smem};
    }
  }
  if (best_passes > 0) return cudaSuccess;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, kernel_ptr<false>(), kThreads, 0);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  long long blocks =
      (long long)(occ < kStreamedPerSM ? occ : kStreamedPerSM) * sms;
  const long long tiles =
      ((H + 31) / 32) * ((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (blocks > tiles) blocks = tiles;
  *plan = {kStreamed, (int)blocks, 0, 0};
  return cudaSuccess;
}

// plans of the shapes seen lately (a pyramid has a handful of levels)
struct PlanCache {
  struct Entry {
    int dev, P, M, N;
    SorPlan plan;
  };
  std::mutex mu;
  Entry entries[16];
  int n = 0, next = 0;
};

cudaError_t cached_plan(int P, int M, int N, SorPlan* plan) {
  static PlanCache cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int i = 0; i < cache.n; ++i) {
    const PlanCache::Entry& c = cache.entries[i];
    if (c.dev == dev && c.P == P && c.M == M && c.N == N) {
      *plan = c.plan;
      return cudaSuccess;
    }
  }
  e = plan_sor(P, M, N, plan);
  if (e != cudaSuccess) return e;
  cache.entries[cache.next] = {dev, P, M, N, *plan};
  cache.next = (cache.next + 1) % 16;
  if (cache.n < 16) ++cache.n;
  return cudaSuccess;
}

cudaError_t launch_sor(const SorPlan& plan, void* duvw, const void* sj,
                       int P, int M, int N, float ax, float ay, float az,
                       int n_iters, cudaStream_t stream) {
  int rpb = plan.rpb;
  void* args[] = {&duvw, (void*)&sj, &P, &M, &N, &ax, &ay, &az,
                  &n_iters, &rpb};
  const bool on_chip = plan.mode == kOnChip;
  return cudaLaunchCooperativeKernel(
      on_chip ? kernel_ptr<true>() : kernel_ptr<false>(),
      dim3(plan.grid), dim3(kThreads), args, (size_t)plan.smem, stream);
}

}  // namespace

extern "C" int sor_iterations_f32(void* duvw, const void* sj, int P, int M,
                                  int N, float ax, float ay, float az,
                                  int n_iters, void* stream) {
  if (n_iters <= 0) return (int)cudaSuccess;
  SorPlan plan;
  cudaError_t e = cached_plan(P, M, N, &plan);
  if (e == cudaSuccess)
    e = launch_sor(plan, duvw, sj, P, M, N, ax, ay, az, n_iters,
                             (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it; the wrapper raises with this code
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// The plan sor_iterations_f32 takes at this shape, for logs and tests:
// out = {mode (1: SJ on chip, 2: SJ streamed), blocks, threads a block,
// rows a block, shared memory bytes a block}.
extern "C" int sor_iterations_plan(int P, int M, int N, int* out) {
  SorPlan plan;
  const cudaError_t e = cached_plan(P, M, N, &plan);
  if (e != cudaSuccess) return (int)e;
  out[0] = plan.mode;
  out[1] = plan.grid;
  out[2] = kThreads;
  out[3] = plan.rpb;
  out[4] = plan.smem;
  return (int)cudaSuccess;
}
