// A tick block of the flow-driven-diffusivity (a_smooth != 1) SOR solver:
// n_iters psi -> red -> black iterations, fp32, on the whole volume, in ONE
// cooperative launch.
//
// Replaces: flowreg3d_tpu/core/solver_pallas.py _sweep_kernel_psi (:247,
// through sweep_iterations_pallas_psi) and its y-tiled twin
// _sweep_kernel_psi_ty (:435, through _sweep_iterations_psi_ty): one TPU
// launch runs n_iters x (psi phase, red phase, black phase). One kernel
// serves every plane size here.
//
// Function: per iteration, with inc the increments duvw (3, P, M, N) and
// base the base flow (3, P, M, N),
//   psi = psi_field_f32(inc, base) over the full grid (csrc/sor_psi.cu),
//   the red half-sweep (parity 0) with that psi, then the black one (1),
//   exactly sor_halfsweep_psi_f32's update (csrc/sor_psi.cu), SJ (9, P, M,
//   N) the data terms. Every per-cell expression is that of psi_field_kernel
//   and halfsweep_kernel<true>, operation for operation, so (with
//   --fmad=false) the result is bit-equal to the three-kernel loop and to
//   its plain version, sweep_iterations_psi(..., use_kernels=False). No
//   cell of the increments' ring is written: the kernel reads the
//   increments at per-axis clamped indices, and the value a sweep reads
//   across a Neumann face, base_ghost + inc_centre, is then base + inc read
//   at the ghost cell, as psi_field reads it.
//
// Bound: read once, a tick block moves 72 B a cell (the increments, base
// flow and SJ read, the increments written: 12 + 12 + 36 + 12), 0.375 ms
// at (66, 514, 514) at 3.35 TB/s, and does about 190 flops a cell an
// iteration (~70 psi, ~120 a half-sweep update), 0.49 ms for 10 iterations
// at 67 TFLOP/s fp32: operations. Streaming the level once an iteration,
// as the streamed mode below does, costs 72 B a cell an iteration, 3.75 ms
// for 10; the three launches an iteration this kernel replaced stream 28 +
// 2 x 70 = 168 B a cell.
//
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel, as
// sor_iterations_f32 in csrc/sor_halfsweep.cu; capturable in a CUDA graph),
// its grid sized by the occupancy calculator so that every block is
// resident, grid.sync() between iterations. Two modes, fixed by the
// level's size (plan_psi), never chosen by a retry:
//  (b) streamed, above kPhasesCells cells (levels 0-1 of a 64 x 512 x 512
//      direct step): one pass over the level an iteration. A work item is
//      a TY x TX tile of interior (y, x) and a chunk of interior z; a block
//      walks the chunk's planes with rolling windows in shared memory:
//        base and increments, loaded with cp.async one plane ahead, at the
//        tile with a 3-cell halo, clamped to the grid as psi_field clamps
//        them, and their sum base + inc, formed once a cell as a plane is
//        first read (the psi phase) and read by every later phase;
//        psi, computed two planes ahead of black on the tile + 2;
//        the red half-sweep, one plane ahead of black on the tile + 1, in
//        place on the increments' window (red reads only black cells), also
//        updating base + inc at the red cells, which black reads;
//        the black half-sweep on the tile, in place on the window, which
//        is then written to device memory once.
//      A neighbouring tile reads this tile's edge as it was before the
//      iteration, so an iteration reads one increment buffer and writes
//      the other (ping-pong with the caller's scratch buffer; the last
//      iteration writes the caller's duvw: an odd n_iters first copies
//      duvw into the scratch). The halo is computed again by each block
//      that needs it. A smaller level cuts z into chunks, each with its own
//      three-plane prologue, to give the card enough work items; the chunk
//      length minimises rounds of resident blocks x (planes + 4). SJ is
//      read straight from device memory at the cells a phase updates, one
//      plane ahead into registers.
//  (a) the phases in turn, up to kPhasesCells cells: psi over the level
//      (psi_field_kernel's blocked walk), grid.sync(), red, grid.sync(),
//      black, one thread an active cell, in place on duvw, psi in the
//      scratch. A streamed step costs a few microseconds whatever the
//      level's size, which small levels cannot amortise.
// If the cooperative launch is refused, the error is returned (the wrapper
// raises); nothing falls back.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <mutex>

#include "sor_psi_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using sor_psi::clampi;
using sor_psi::kEpsSmooth;
using sor_psi::kOmega;
using sor_psi::kOneMinusOmega;

constexpr int TX = 32;                 // interior x cells of a tile
constexpr int TY = 16;                 // interior y cells of a tile
constexpr int kThreads = 512;
constexpr int HALO = 3;                // psi on tile + 2, red on tile + 1
constexpr int RX = TX + 2 * HALO;      // the window's cells in x
constexpr int RY = TY + 2 * HALO;      // and in y
constexpr int CELLS = RX * RY;
// base / increment planes s-1 .. s+3 in use at step s, s+4 loading
constexpr int SLOTS = 6;
constexpr int PSI_SLOTS = 4;           // psi planes s-1 .. s+2
constexpr int T_SLOTS = 5;             // base + inc, planes s-1 .. s+3
constexpr int FETCH = (CELLS + kThreads - 1) / kThreads;
constexpr int RED_ROW = (RX - 4) / 2;  // red cells a row of tile + 1
constexpr int BLACK_ROW = TX / 2;      // black cells a row of the tile
constexpr size_t kSmem =
    (size_t)(2 * 3 * SLOTS + PSI_SLOTS + 3 * T_SLOTS) * CELLS * sizeof(float);
static_assert(TX % 2 == 0 && (RX - 4) % 2 == 0, "even rows");
static_assert(RED_ROW * (RY - 4) <= kThreads, "one red cell a thread");
static_assert(BLACK_ROW * TY <= kThreads, "one black cell a thread");

// mode (a), the phases in turn, up to this many cells (P M N); mode (b),
// streamed, above. Measured on an H100 at the levels of a 64 x 512 x 512
// direct step: streamed is faster at (53, 412, 412), 9.0 M cells, the
// phases at (43, 330, 330), 4.7 M, and below.
constexpr long long kPhasesCells = 6000000;

enum PsiMode { kPhases = 1, kStreamed = 2 };

struct PsiPlan {
  int mode;    // kPhases or kStreamed
  int grid;    // blocks, all resident
  int zc;      // planes a chunk of z: interior (kStreamed), all (kPhases)
  int chunks;  // chunks of z
  int tiles;   // (y, x) tiles of a work item
  int smem;    // dynamic shared memory a block, bytes
};

// window slots of plane z (z >= -12)
__device__ __forceinline__ int slot(int z) { return (z + 12) % SLOTS; }
__device__ __forceinline__ int pslot(int z) { return (z + 12) % PSI_SLOTS; }
__device__ __forceinline__ int tslot(int z) { return (z + 15) % T_SLOTS; }

__global__ void __launch_bounds__(kThreads, 1)
    psi_tick_block_kernel(float* duvw, float* scratch,
                          const float* __restrict__ base,
                          const float* __restrict__ sj, int P, int M, int N,
                          float a, float expo, float ihx, float ihy,
                          float ihz, float ax, float ay, float az,
                          int n_iters, int zc, int tiles_x, int tiles,
                          int items) {
  extern __shared__ float smem[];
  float* Bw = smem;                        // [SLOTS][3][CELLS] base
  float* Rw = Bw + SLOTS * 3 * CELLS;      // [SLOTS][3][CELLS] increments
  float* Pw = Rw + SLOTS * 3 * CELLS;      // [PSI_SLOTS][CELLS] psi
  float* Tw = Pw + PSI_SLOTS * CELLS;      // [T_SLOTS][3][CELLS] base + inc
  const int tid = threadIdx.x;
  const long long plane = (long long)M * N;
  const long long vol = plane * P;
  cg::grid_group grid = cg::this_grid();

  float* in = duvw;
  float* out = scratch;
  if (n_iters & 1) {   // end in duvw: start from a copy in the scratch
    const long long n = 3 * vol;
    for (long long i = (long long)blockIdx.x * kThreads + tid; i < n;
         i += (long long)gridDim.x * kThreads)
      scratch[i] = duvw[i];
    grid.sync();
    in = scratch;
    out = duvw;
  }

  for (int it = 0; it < n_iters; ++it) {
    if (it > 0) {
      grid.sync();
      float* t = in;
      in = out;
      out = t;
    }
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int chunk = item / tiles;
      const int tile = item - chunk * tiles;
      const int y0 = 1 + (tile / tiles_x) * TY;
      const int x0 = 1 + (tile % tiles_x) * TX;
      const int za = 1 + chunk * zc;
      const int zb = min(za + zc, P - 1);  // black planes [za, zb)
      // this thread's window cells: base offset (clamped to the grid) and
      // increment offset (clamped to the interior) within a plane
      int ob[FETCH], oi[FETCH];
#pragma unroll
      for (int l = 0; l < FETCH; ++l) {
        const int i = tid + l * kThreads;
        const int y = y0 - HALO + i / RX, x = x0 - HALO + i % RX;
        ob[l] = clampi(y, 0, M - 1) * N + clampi(x, 0, N - 1);
        oi[l] = clampi(y, 1, M - 2) * N + clampi(x, 1, N - 2);
      }
      auto load = [&](int z) {
        if (z < max(za - 3, -1) || z > min(zb + 2, P)) return;
        const int s = slot(z);
        const long long zbo = clampi(z, 0, P - 1) * plane;
        const long long zio = clampi(z, 1, P - 2) * plane;
#pragma unroll
        for (int l = 0; l < FETCH; ++l) {
          const int i = tid + l * kThreads;
          if (i < CELLS) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              __pipeline_memcpy_async(Bw + (s * 3 + c) * CELLS + i,
                                      base + c * vol + zbo + ob[l], 4);
              __pipeline_memcpy_async(Rw + (s * 3 + c) * CELLS + i,
                                      in + c * vol + zio + oi[l], 4);
            }
          }
        }
      };
      // the tile's cells of plane z from the window to device memory
      auto store = [&](int z) {
        const int s = slot(z);
        for (int e = tid; e < 3 * TY * TX; e += kThreads) {
          const int c = e / (TY * TX);
          const int r = (e / TX) % TY;
          const int xx = e % TX;
          const int y = y0 + r, x = x0 + xx;
          if (y <= M - 2 && x <= N - 2)
            out[c * vol + z * plane + (long long)y * N + x] =
                Rw[(s * 3 + c) * CELLS + (HALO + r) * RX + HALO + xx];
        }
      };
      auto loaded = [&](int z) {
        return z >= max(za - 3, -1) && z <= min(zb + 2, P);
      };
      // tot = base + inc of plane z over the window
      auto tot_phase = [&](int z) {
        const int sb = slot(z), st = tslot(z);
        for (int k = tid; k < CELLS; k += kThreads)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            Tw[(st * 3 + c) * CELLS + k] =
                Bw[(sb * 3 + c) * CELLS + k] + Rw[(sb * 3 + c) * CELLS + k];
      };
      // tot of plane z+1 over the window, and psi of plane z on the tile +
      // 2, as psi_field_kernel computes it
      auto psi_phase = [&](int z) {
        const bool do_tot = loaded(z + 1);
        const bool do_psi = z >= max(za - 2, 0) && z <= min(zb + 1, P - 1);
        const int sb = slot(z + 1), tm = tslot(z - 1), t0 = tslot(z),
                  tp = tslot(z + 1);
        for (int k = tid; k < CELLS; k += kThreads) {
          float up[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            up[c] = Bw[(sb * 3 + c) * CELLS + k] + Rw[(sb * 3 + c) * CELLS + k];
            if (do_tot) Tw[(tp * 3 + c) * CELLS + k] = up[c];
          }
          const int i = k / RX, j = k - i * RX;
          if (!do_psi || i < 1 || i > RY - 2 || j < 1 || j > RX - 2) continue;
          float g = 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float* tmc = Tw + (tm * 3 + c) * CELLS;
            const float* t0c = Tw + (t0 * 3 + c) * CELLS;
            const float gz = (up[c] - tmc[k]) * ihz;
            g = g + gz * gz;
            const float gy = (t0c[k + RX] - t0c[k - RX]) * ihy;
            g = g + gy * gy;
            const float gx = (t0c[k + 1] - t0c[k - 1]) * ihx;
            g = g + gx * gx;
          }
          const float s = g + kEpsSmooth;
          const float p = (expo == -0.5f) ? rsqrtf(s) : powf(s, expo);
          Pw[pslot(z) * CELLS + k] = a * p;
        }
      };
      // One cell of a half-sweep at window cell k of plane z, in place on
      // the window, as halfsweep_kernel<true> updates it. A neighbour
      // across a Neumann face is a window cell holding base_ghost and the
      // clamped increment, the centre's own: base + inc there is the
      // kernel's base_ghost + inc_centre.
      auto relax = [&](int z, int k, const float (&s)[9], bool red) {
        const int sl[3] = {slot(z - 1), slot(z), slot(z + 1)};
        const int tl[3] = {tslot(z - 1), tslot(z), tslot(z + 1)};
        const float* ps0 = Pw + pslot(z) * CELLS;
        const float pc = ps0[k];
        const float pn[6] = {ps0[k - 1], ps0[k + 1], ps0[k - RX], ps0[k + RX],
                             Pw[pslot(z - 1) * CELLS + k],
                             Pw[pslot(z + 1) * CELLS + k]};
        const float a_dir[6] = {ax, ax, ay, ay, az, az};
        float wt[6];
#pragma unroll
        for (int d = 0; d < 6; ++d) wt[d] = 0.5f * (pc + pn[d]) * a_dir[d];
        const float sw_sum = wt[0] + wt[1] + wt[2] + wt[3] + wt[4] + wt[5];
        float* r0 = Rw + sl[1] * 3 * CELLS;
        const float u0 = r0[k], v0 = r0[CELLS + k], w0 = r0[2 * CELLS + k];
        const float nd[3] = {-(s[6] + s[3] * v0 + s[4] * w0),
                             -(s[7] + s[3] * u0 + s[5] * w0),
                             -(s[8] + s[4] * u0 + s[5] * v0)};
        const float den_data[3] = {s[0], s[1], s[2]};
        const float old[3] = {u0, v0, w0};
        const int nb_slot[6] = {tl[1], tl[1], tl[1], tl[1], tl[0], tl[2]};
        const int nb_k[6] = {k - 1, k + 1, k - RX, k + RX, k, k};
        float res[3];
#pragma unroll
        for (int comp = 0; comp < 3; ++comp) {
          const float bc = Bw[(sl[1] * 3 + comp) * CELLS + k];
          const float ic = old[comp];
          float num = nd[comp];
#pragma unroll
          for (int d = 0; d < 6; ++d) {
            const float t = Tw[(nb_slot[d] * 3 + comp) * CELLS + nb_k[d]];
            num = num + wt[d] * (t - bc);
          }
          const float den = den_data[comp] + sw_sum;
          const float frac = (den != 0.0f) ? num / den : 0.0f;
          res[comp] = kOneMinusOmega * ic + kOmega * frac;
          // black reads base + inc at the red cells it neighbours
          if (red) Tw[(tl[1] * 3 + comp) * CELLS + k] = bc + res[comp];
        }
        r0[k] = res[0];
        r0[CELLS + k] = res[1];
        r0[2 * CELLS + k] = res[2];
      };
      // this thread's red cell of plane z (tile + 1) or black cell (tile):
      // window index, or -1 when there is none or it is not interior
      auto red_cell = [&](int z, long long* c) {
        if (tid >= RED_ROW * (RY - 4) || z < max(za - 1, 1) ||
            z > min(zb, P - 2))
          return -1;
        const int i = 2 + tid / RED_ROW;
        const int y = y0 - HALO + i;
        const int q = (z + y + x0 - 1) & 1;
        const int j = 2 + q + 2 * (tid % RED_ROW);
        const int x = x0 - HALO + j;
        if (y < 1 || y > M - 2 || x < 1 || x > N - 2) return -1;
        *c = (long long)z * plane + (long long)y * N + x;
        return i * RX + j;
      };
      auto black_cell = [&](int z, long long* c) {
        if (tid >= BLACK_ROW * TY || z < za || z >= zb) return -1;
        const int r = tid / BLACK_ROW;
        const int y = y0 + r;
        const int q = 1 - ((z + y + x0) & 1);
        const int xx = q + 2 * (tid % BLACK_ROW);
        const int x = x0 + xx;
        if (y > M - 2 || x > N - 2) return -1;
        *c = (long long)z * plane + (long long)y * N + x;
        return (HALO + r) * RX + HALO + xx;
      };
      auto fetch_sj = [&](int k, long long c, float (&s)[9]) {
        if (k >= 0) {
#pragma unroll
          for (int f = 0; f < 9; ++f) s[f] = __ldg(sj + f * vol + c);
        }
      };

      // Step s: psi of plane s+2, red of s+1, black of s; planes s+3 are
      // in the window, s+4 loads meanwhile. Steps za-4 .. zb-1.
      float s_red[9], s_black[9];
      long long c_red = 0, c_black = 0;
      for (int z = za - 3; z < za; ++z) {
        load(z);
        __pipeline_commit();
      }
      __pipeline_wait_prior(1);
      __syncthreads();
      for (int z = za - 3; z < za - 1; ++z)
        if (loaded(z)) tot_phase(z);
      int k_red = red_cell(za - 3, &c_red);
      fetch_sj(k_red, c_red, s_red);
      int k_black = black_cell(za - 4, &c_black);
      fetch_sj(k_black, c_black, s_black);
      for (int s = za - 4; s < zb; ++s) {
        __pipeline_wait_prior(0);
        __syncthreads();
        if (s - 1 >= za) store(s - 1);
        load(s + 4);
        __pipeline_commit();
        psi_phase(s + 2);
        __syncthreads();
        if (k_red >= 0) relax(s + 1, k_red, s_red, true);
        k_red = red_cell(s + 2, &c_red);
        fetch_sj(k_red, c_red, s_red);
        __syncthreads();
        if (k_black >= 0) relax(s, k_black, s_black, false);
        k_black = black_cell(s + 1, &c_black);
        fetch_sj(k_black, c_black, s_black);
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      store(zb - 1);
      __syncthreads();
    }
  }
}

// Mode (a), the phases in turn: psi over the whole level, grid.sync(),
// the red half-sweep, grid.sync(), the black one, grid.sync(); psi in a
// device buffer (the scratch's first component), the half-sweeps in place
// on duvw (a half-sweep reads only opposite-parity increments, which it
// never writes). The psi phase is psi_field_f32's walk (sor_psi::psi_walk:
// a 32 x 8 (x, y) tile of the full grid along a chunk of z), the
// half-sweeps sor_halfsweep_psi_f32's cell (sor_psi::halfsweep_cell), one
// thread an active cell, their neighbours read through L1/L2. Three blocks
// an SM, at most 80 registers a thread: the fastest of 1 to 8 blocks an SM
// at the levels of a 64 x 512 x 512 direct step.
constexpr int kPhPerSM = 3;

__global__ void __launch_bounds__(sor_psi::PSI_THREADS, kPhPerSM)
    psi_tick_phases_kernel(float* duvw, float* psi,
                           const float* __restrict__ base,
                           const float* __restrict__ sj, int P, int M, int N,
                           float a, float expo, float ihx, float ihy,
                           float ihz, float ax, float ay, float az,
                           int n_iters, int zc, int tiles_x, int psi_items) {
  using sor_psi::PTX;
  using sor_psi::PTY;
  __shared__ float tot[sor_psi::SLOTS][3][sor_psi::HCELLS];
  const int tid = threadIdx.y * PTX + threadIdx.x;
  const int H = (N - 1) / 2;  // x slots a row
  const long long slots = (long long)(P - 2) * (M - 2) * H;
  const long long stride = (long long)gridDim.x * sor_psi::PSI_THREADS;
  const long long first = (long long)blockIdx.x * sor_psi::PSI_THREADS + tid;
  const int tiles = tiles_x * ((M + PTY - 1) / PTY);
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < n_iters; ++it) {
    if (it > 0) grid.sync();
    for (int item = blockIdx.x; item < psi_items; item += gridDim.x) {
      const int chunk = item / tiles, t = item - chunk * tiles;
      const int z0 = chunk * zc;
      sor_psi::psi_walk(tot, duvw, base, psi, P, M, N, a, expo, ihx, ihy,
                        ihz, (t % tiles_x) * PTX, (t / tiles_x) * PTY, z0,
                        min(z0 + zc, P), 1, P - 2, P - 1);
      __syncthreads();  // the ring is free for the next item
    }
    for (int parity = 0; parity < 2; ++parity) {
      grid.sync();
      for (long long i = first; i < slots; i += stride) {
        const long long row = i / H;
        const int k = (int)(i - row * H);
        const int z = 1 + (int)(row / (M - 2));
        const int y = 1 + (int)(row - (long long)(z - 1) * (M - 2));
        const int x = 1 + ((parity + z + y + 1) & 1) + 2 * k;
        if (x <= N - 2)
          sor_psi::halfsweep_cell<true>(duvw, base, sj, psi, P, M, N, ax, ay,
                                        az, z, y, x, 1, P - 2);
      }
    }
  }
}

// The size rule: mode (a) up to kPhasesCells cells, else (b); "mode"
// 1 or 2 asks for one (to compare them; 0: by size). Every block resident
// (the occupancy calculator). (a): psi_field_f32's chunk rule for the psi
// walk, the fewest rounds of resident blocks x (planes + 2). (b): of the
// chunk lengths zc, the fewest rounds of resident blocks x (zc + 4) steps,
// the longest on a tie.
cudaError_t plan_psi(int P, int M, int N, int mode, PsiPlan* plan) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (mode == 0) mode = (long long)P * M * N <= kPhasesCells ? kPhases
                                                            : kStreamed;
  if (mode == kPhases) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, psi_tick_phases_kernel, sor_psi::PSI_THREADS, 0);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    const long long blocks = (long long)sms * (occ < kPhPerSM ? occ : kPhPerSM);
    const int tiles = ((N + sor_psi::PTX - 1) / sor_psi::PTX) *
                      ((M + sor_psi::PTY - 1) / sor_psi::PTY);
    int zc = P;
    long long best = -1;
    for (int chunks = 1; chunks <= P; ++chunks) {
      const int c = (P + chunks - 1) / chunks;
      const long long items = (long long)tiles * ((P + c - 1) / c);
      const long long cost = (items + blocks - 1) / blocks * (c + 2);
      if (best < 0 || cost < best) best = cost, zc = c;
    }
    *plan = {kPhases, (int)blocks, zc, (P + zc - 1) / zc, tiles, 0};
    return cudaSuccess;
  }
  if (mode != kStreamed) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(psi_tick_block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, psi_tick_block_kernel, kThreads, kSmem);
  if (e != cudaSuccess) return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long slots = (long long)occ * sms;
  const int tiles_x = (N - 2 + TX - 1) / TX;
  const int tiles = tiles_x * ((M - 2 + TY - 1) / TY);
  const int pin = P - 2;
  long long best = -1;
  for (int chunks = 1; chunks <= pin; ++chunks) {
    const int zc = (pin + chunks - 1) / chunks;
    const long long items = (long long)tiles * ((pin + zc - 1) / zc);
    const long long cost = (items + slots - 1) / slots * (zc + 4);
    if (best < 0 || cost < best) {
      best = cost;
      const long long grid = items < slots ? items : slots;
      *plan = {kStreamed, (int)grid, zc, (pin + zc - 1) / zc, tiles,
               (int)kSmem};
    }
  }
  return cudaSuccess;
}

// plans of the shapes seen lately (a pyramid has a handful of levels)
struct PlanCache {
  struct Entry {
    int dev, P, M, N, mode;
    PsiPlan plan;
  };
  std::mutex mu;
  Entry entries[16];
  int n = 0, next = 0;
};

cudaError_t cached_plan(int P, int M, int N, int mode, PsiPlan* plan) {
  static PlanCache cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int i = 0; i < cache.n; ++i) {
    const PlanCache::Entry& c = cache.entries[i];
    if (c.dev == dev && c.P == P && c.M == M && c.N == N && c.mode == mode) {
      *plan = c.plan;
      return cudaSuccess;
    }
  }
  e = plan_psi(P, M, N, mode, plan);
  if (e != cudaSuccess) return e;
  cache.entries[cache.next] = {dev, P, M, N, mode, *plan};
  cache.next = (cache.next + 1) % 16;
  if (cache.n < 16) ++cache.n;
  return cudaSuccess;
}

}  // namespace

extern "C" int sor_iterations_psi_f32(void* duvw, void* scratch,
                                      const void* base, const void* sj,
                                      int P, int M, int N, float a,
                                      float expo, float ihx, float ihy,
                                      float ihz, float ax, float ay, float az,
                                      int n_iters, int mode, void* stream) {
  if (n_iters <= 0) return (int)cudaSuccess;
  if ((long long)M * N > 2147483647LL) return (int)cudaErrorInvalidValue;
  PsiPlan plan;
  cudaError_t e = cached_plan(P, M, N, mode, &plan);
  if (e == cudaSuccess && plan.mode == kPhases) {
    int zc = plan.zc;
    int tiles_x = (N + sor_psi::PTX - 1) / sor_psi::PTX;
    int items = plan.tiles * plan.chunks;
    void* args[] = {&duvw, &scratch, (void*)&base, (void*)&sj, &P, &M, &N,
                    &a, &expo, &ihx, &ihy, &ihz, &ax, &ay, &az, &n_iters,
                    &zc, &tiles_x, &items};
    e = cudaLaunchCooperativeKernel((const void*)psi_tick_phases_kernel,
                                    dim3(plan.grid),
                                    dim3(sor_psi::PTX, sor_psi::PTY), args, 0,
                                    (cudaStream_t)stream);
  } else if (e == cudaSuccess) {
    int zc = plan.zc;
    int tiles_x = (N - 2 + TX - 1) / TX;
    int tiles = plan.tiles;
    int items = plan.tiles * plan.chunks;
    void* args[] = {&duvw, &scratch, (void*)&base, (void*)&sj, &P, &M, &N,
                    &a, &expo, &ihx, &ihy, &ihz, &ax, &ay, &az, &n_iters,
                    &zc, &tiles_x, &tiles, &items};
    e = cudaLaunchCooperativeKernel((const void*)psi_tick_block_kernel,
                                    dim3(plan.grid), dim3(kThreads), args,
                                    kSmem, (cudaStream_t)stream);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it; the wrapper raises with this code
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// The plan sor_iterations_psi_f32 takes at this shape and requested mode
// (0: by size), for logs and tests: out = {mode (1: the phases in turn, 2:
// streamed), blocks, threads a block, planes a chunk of z, chunks, tiles,
// dynamic shared memory bytes a block}.
extern "C" int sor_iterations_psi_plan(int P, int M, int N, int mode,
                                       int* out) {
  PsiPlan plan;
  const cudaError_t e = cached_plan(P, M, N, mode, &plan);
  if (e != cudaSuccess) return (int)e;
  out[0] = plan.mode;
  out[1] = plan.grid;
  out[2] = plan.mode == kPhases ? sor_psi::PSI_THREADS : kThreads;
  out[3] = plan.zc;
  out[4] = plan.chunks;
  out[5] = plan.tiles;
  out[6] = plan.smem;
  return (int)cudaSuccess;
}
