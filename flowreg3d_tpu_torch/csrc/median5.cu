// Exact 5x5x5 median (rank 62 of 125), fp32, of a batch of mirror-padded
// volumes: xp (B, Z+4, Y+4, X+4) -> out (B, Z, Y, X).
//
// Replaces: flowreg3d_tpu/ops/median_pallas.py _kernel_batched (:110,
// through median_filter_5x5x5_pallas_batched) and _kernel (:97, through
// median_filter_5x5x5_pallas), which is the same function with B = 1.
//
// Function: out[b, z, y, x] is the 63rd smallest of the 125 values
// xp[b, z..z+4, y..y+4, x..x+4]. The caller pads with mirror ('reflect')
// boundaries. The result is one of the inputs, so any exact selection is
// bit-equal to it (scipy, torch.median).
//
// Bound: operations. An exact median of 125 values needs at least ~2n = 250
// comparisons an output (6.6 us at (3, 21, 168, 168) at 67 TFLOP/s); the
// bytes (the padded input once, the output once) take 4.8 us at 3.35 TB/s.
// Compare-exchanges are min/max pairs, so the count of them sets the time.
//
// Design: separable sorting networks (Adams, "Fast Median Filters Using
// Separable Sorting Networks", ACM TOG 40(4), 2021): neighbouring outputs
// share 100 of their 125 values, so the sorting is shared between them.
// A block of 128 threads computes a tile of TY = 8 rows x TX = 28 columns
// of outputs at one z, through shared memory:
//   1. every (y, x) of the tile and its 4-voxel halo (12 x 32) sorts its
//      5-long z-column once (sort5);
//   2. each thread merges six neighbouring sorted columns along y into the
//      sorted 5x5 (z, y) planes of two rows: the four columns they share
//      are merged once (merge_5_5, merge_10_10), then each row adds its own
//      fifth (merge_20_5); 4 row pairs x 32 columns, one thread each;
//   3. the planes at odd x are merged with their right neighbour into
//      sorted pairs of planes, 50 values (merge_25_25);
//   4. each thread takes two outputs of a row, x = 2k and 2k + 1. Their
//      windows share the four planes 2k+1..2k+4, the merge of two plane
//      pairs; of those 100 values only ranks 37..62 can be the median of a
//      window that adds 25 more, so the merge is pruned to them
//      (merge_50_50_keep, forgetful selection). Each output is then rank 25
//      of those 26 and its own fifth plane (rank_of_two: 25 max, 25 min).
// Amortised over the tile that is 271.1 compare-exchanges an output
// (z-columns 15.4, planes 87.4, plane pairs 63.8, selection 104.5, a min or a
// max of rank_of_two counted as half of one), against 1184 when each thread
// ran the pruned 125-input network alone; tile_compare_exchanges() in
// ops/median_kernel.py counts them. The networks are Batcher's odd-even
// merges pruned by what the inputs' order already fixes and by the cone of
// the ranks kept; ops/median_kernel.py generates them (network_source) and
// a CPU test holds the functions below to it and emulates the whole tile.
// Compare-exchanges are exact under ties, and so is rank_of_two. Tiles at
// the ragged edge load clamped indices and write only the outputs inside.

#include <cuda_runtime.h>

namespace {

#define CE(i, j)                                 \
  {                                              \
    const float lo_ = fminf(v[i], v[j]);         \
    v[j] = fmaxf(v[i], v[j]);                    \
    v[i] = lo_;                                  \
  }
#define O(r, i) o[r] = v[i];

// sort5: 9 compare-exchanges, generated by ops/median_kernel.py
__device__ __forceinline__ void sort5(
    float (&v)[5], float (&o)[5]) {
  CE(0, 1); CE(2, 3); CE(0, 2); CE(1, 3); CE(1, 2); CE(0, 4); CE(2, 4);
  CE(1, 2); CE(3, 4);
  O(0, 0); O(1, 1); O(2, 2); O(3, 3); O(4, 4);
}

// merge_5_5: 13 compare-exchanges, generated by ops/median_kernel.py
__device__ __forceinline__ void merge_5_5(
    float (&v)[10], float (&o)[10]) {
  CE(0, 5); CE(4, 9); CE(4, 5); CE(2, 7); CE(2, 4); CE(7, 5); CE(1, 6);
  CE(3, 8); CE(3, 6); CE(1, 2); CE(3, 4); CE(6, 7); CE(8, 5);
  O(0, 0); O(1, 1); O(2, 2); O(3, 3); O(4, 4); O(5, 6); O(6, 7); O(7, 8);
  O(8, 5); O(9, 9);
}

// merge_10_10: 35 compare-exchanges, generated by ops/median_kernel.py
__device__ __forceinline__ void merge_10_10(
    float (&v)[20], float (&o)[20]) {
  CE(0, 10); CE(8, 18); CE(8, 10); CE(4, 14); CE(4, 8); CE(14, 10); CE(2, 12);
  CE(6, 16); CE(6, 12); CE(2, 4); CE(6, 8); CE(12, 14); CE(16, 10); CE(1, 11);
  CE(9, 19); CE(9, 11); CE(5, 15); CE(5, 9); CE(15, 11); CE(3, 13); CE(7, 17);
  CE(7, 13); CE(3, 5); CE(7, 9); CE(13, 15); CE(17, 11); CE(1, 2); CE(3, 4);
  CE(5, 6); CE(7, 8); CE(9, 12); CE(13, 14); CE(15, 16); CE(17, 10);
  CE(11, 18);
  O(0, 0); O(1, 1); O(2, 2); O(3, 3); O(4, 4); O(5, 5); O(6, 6); O(7, 7);
  O(8, 8); O(9, 9); O(10, 12); O(11, 13); O(12, 14); O(13, 15); O(14, 16);
  O(15, 17); O(16, 10); O(17, 11); O(18, 18); O(19, 19);
}

// merge_20_5: 46 compare-exchanges, generated by ops/median_kernel.py
__device__ __forceinline__ void merge_20_5(
    float (&v)[25], float (&o)[25]) {
  CE(0, 20); CE(16, 20); CE(8, 16); CE(4, 24); CE(12, 24); CE(4, 8);
  CE(12, 16); CE(24, 20); CE(2, 22); CE(18, 22); CE(10, 18); CE(6, 10);
  CE(14, 18); CE(2, 4); CE(6, 8); CE(10, 12); CE(14, 16); CE(18, 24);
  CE(22, 20); CE(1, 21); CE(17, 21); CE(9, 17); CE(5, 9); CE(13, 17);
  CE(3, 23); CE(19, 23); CE(11, 19); CE(7, 11); CE(15, 19); CE(3, 5); CE(7, 9);
  CE(11, 13); CE(15, 17); CE(19, 21); CE(1, 2); CE(3, 4); CE(5, 6); CE(7, 8);
  CE(9, 10); CE(11, 12); CE(13, 14); CE(15, 16); CE(17, 18); CE(19, 24);
  CE(21, 22); CE(23, 20);
  O(0, 0); O(1, 1); O(2, 2); O(3, 3); O(4, 4); O(5, 5); O(6, 6); O(7, 7);
  O(8, 8); O(9, 9); O(10, 10); O(11, 11); O(12, 12); O(13, 13); O(14, 14);
  O(15, 15); O(16, 16); O(17, 17); O(18, 18); O(19, 19); O(20, 24); O(21, 21);
  O(22, 22); O(23, 23); O(24, 20);
}

// merge_25_25: 119 compare-exchanges, generated by ops/median_kernel.py
__device__ __forceinline__ void merge_25_25(
    float (&v)[50], float (&o)[50]) {
  CE(0, 25); CE(16, 41); CE(16, 25); CE(8, 33); CE(24, 49); CE(24, 33);
  CE(8, 16); CE(24, 25); CE(33, 41); CE(4, 29); CE(20, 45); CE(20, 29);
  CE(12, 37); CE(12, 20); CE(37, 29); CE(4, 8); CE(12, 16); CE(20, 24);
  CE(37, 25); CE(29, 33); CE(45, 41); CE(2, 27); CE(18, 43); CE(18, 27);
  CE(10, 35); CE(10, 18); CE(35, 27); CE(6, 31); CE(22, 47); CE(22, 31);
  CE(14, 39); CE(14, 22); CE(39, 31); CE(6, 10); CE(14, 18); CE(22, 35);
  CE(39, 27); CE(31, 43); CE(2, 4); CE(6, 8); CE(10, 12); CE(14, 16);
  CE(18, 20); CE(22, 24); CE(35, 37); CE(39, 25); CE(27, 29); CE(31, 33);
  CE(43, 45); CE(47, 41); CE(1, 26); CE(17, 42); CE(17, 26); CE(9, 34);
  CE(9, 17); CE(34, 26); CE(5, 30); CE(21, 46); CE(21, 30); CE(13, 38);
  CE(13, 21); CE(38, 30); CE(5, 9); CE(13, 17); CE(21, 34); CE(38, 26);
  CE(30, 42); CE(3, 28); CE(19, 44); CE(19, 28); CE(11, 36); CE(11, 19);
  CE(36, 28); CE(7, 32); CE(23, 48); CE(23, 32); CE(15, 40); CE(15, 23);
  CE(40, 32); CE(7, 11); CE(15, 19); CE(23, 36); CE(40, 28); CE(32, 44);
  CE(3, 5); CE(7, 9); CE(11, 13); CE(15, 17); CE(19, 21); CE(23, 34);
  CE(36, 38); CE(40, 26); CE(28, 30); CE(32, 42); CE(44, 46); CE(1, 2);
  CE(3, 4); CE(5, 6); CE(7, 8); CE(9, 10); CE(11, 12); CE(13, 14); CE(15, 16);
  CE(17, 18); CE(19, 20); CE(21, 22); CE(23, 24); CE(34, 35); CE(36, 37);
  CE(38, 39); CE(40, 25); CE(26, 27); CE(28, 29); CE(30, 31); CE(32, 33);
  CE(42, 43); CE(44, 45); CE(46, 47); CE(48, 41);
  O(0, 0); O(1, 1); O(2, 2); O(3, 3); O(4, 4); O(5, 5); O(6, 6); O(7, 7);
  O(8, 8); O(9, 9); O(10, 10); O(11, 11); O(12, 12); O(13, 13); O(14, 14);
  O(15, 15); O(16, 16); O(17, 17); O(18, 18); O(19, 19); O(20, 20); O(21, 21);
  O(22, 22); O(23, 23); O(24, 24); O(25, 34); O(26, 35); O(27, 36); O(28, 37);
  O(29, 38); O(30, 39); O(31, 40); O(32, 25); O(33, 26); O(34, 27); O(35, 28);
  O(36, 29); O(37, 30); O(38, 31); O(39, 32); O(40, 33); O(41, 42); O(42, 43);
  O(43, 44); O(44, 45); O(45, 46); O(46, 47); O(47, 48); O(48, 41); O(49, 49);
}

// merge_50_50_keep: 159 compare-exchanges, generated by ops/median_kernel.py
__device__ __forceinline__ void merge_50_50_keep(
    float (&v)[100], float (&o)[26]) {
  CE(0, 50); CE(32, 82); CE(32, 50); CE(16, 66); CE(48, 98); CE(48, 66);
  CE(48, 50); CE(8, 58); CE(40, 90); CE(40, 58); CE(24, 74); CE(24, 40);
  CE(74, 58); CE(40, 48); CE(74, 50); CE(4, 54); CE(36, 86); CE(36, 54);
  CE(20, 70); CE(20, 36); CE(70, 54); CE(12, 62); CE(44, 94); CE(44, 62);
  CE(28, 78); CE(28, 44); CE(78, 62); CE(28, 36); CE(44, 70); CE(78, 54);
  CE(36, 40); CE(44, 48); CE(70, 74); CE(78, 50); CE(2, 52); CE(34, 84);
  CE(34, 52); CE(18, 68); CE(68, 52); CE(10, 60); CE(42, 92); CE(42, 60);
  CE(26, 76); CE(26, 42); CE(76, 60); CE(42, 68); CE(76, 52); CE(6, 56);
  CE(38, 88); CE(38, 56); CE(22, 72); CE(22, 38); CE(72, 56); CE(14, 64);
  CE(46, 96); CE(46, 64); CE(30, 80); CE(30, 46); CE(80, 64); CE(30, 38);
  CE(46, 72); CE(80, 56); CE(38, 42); CE(46, 68); CE(72, 76); CE(80, 52);
  CE(38, 40); CE(42, 44); CE(46, 48); CE(68, 70); CE(72, 74); CE(76, 78);
  CE(80, 50); CE(1, 51); CE(33, 83); CE(33, 51); CE(17, 67); CE(49, 99);
  CE(49, 67); CE(49, 51); CE(9, 59); CE(41, 91); CE(41, 59); CE(25, 75);
  CE(25, 41); CE(75, 59); CE(41, 49); CE(75, 51); CE(5, 55); CE(37, 87);
  CE(37, 55); CE(21, 71); CE(21, 37); CE(71, 55); CE(13, 63); CE(45, 95);
  CE(45, 63); CE(29, 79); CE(29, 45); CE(79, 63); CE(29, 37); CE(45, 71);
  CE(79, 55); CE(37, 41); CE(45, 49); CE(71, 75); CE(79, 51); CE(3, 53);
  CE(35, 85); CE(35, 53); CE(19, 69); CE(19, 35); CE(69, 53); CE(11, 61);
  CE(43, 93); CE(43, 61); CE(27, 77); CE(27, 43); CE(77, 61); CE(27, 35);
  CE(43, 69); CE(77, 53); CE(7, 57); CE(39, 89); CE(39, 57); CE(23, 73);
  CE(23, 39); CE(73, 57); CE(15, 65); CE(47, 97); CE(47, 65); CE(31, 81);
  CE(31, 47); CE(31, 39); CE(47, 73); CE(31, 35); CE(39, 43); CE(47, 69);
  CE(73, 77); CE(35, 37); CE(39, 41); CE(43, 45); CE(47, 49); CE(69, 71);
  CE(73, 75); CE(77, 79); CE(37, 38); CE(39, 40); CE(41, 42); CE(43, 44);
  CE(45, 46); CE(47, 48); CE(49, 68); CE(69, 70); CE(71, 72); CE(73, 74);
  CE(75, 76); CE(77, 78); CE(79, 80);
  O(0, 37); O(1, 38); O(2, 39); O(3, 40); O(4, 41); O(5, 42); O(6, 43);
  O(7, 44); O(8, 45); O(9, 46); O(10, 47); O(11, 48); O(12, 49); O(13, 68);
  O(14, 69); O(15, 70); O(16, 71); O(17, 72); O(18, 73); O(19, 74); O(20, 75);
  O(21, 76); O(22, 77); O(23, 78); O(24, 79); O(25, 80);
}

#undef CE
#undef O

constexpr int TX = 28, TY = 8;             // outputs of a block
constexpr int CX = TX + 4, CY = TY + 4;    // with the halo
constexpr int NM2 = TX / 2 + 1;            // plane pairs at x = 1, 3, ..
constexpr int THREADS = 128;
constexpr int PL = 25;                     // floats of a plane
constexpr int M2S = 51;                    // floats of a plane pair (odd)
constexpr int SM_PLANES = TY * CX * PL;
constexpr int SM_COLS = 5 * CY * CX;
constexpr int SM_M2 = TY * NM2 * M2S;
constexpr int SM_BYTES =
    4 * (SM_PLANES + (SM_COLS > SM_M2 ? SM_COLS : SM_M2));
static_assert((CY * CX) % THREADS == 0, "stage 1: whole rounds");
static_assert((TY / 2) * CX == THREADS, "stage 2: a thread a row pair");
static_assert(TY * NM2 <= THREADS && TY * (TX / 2) <= THREADS, "stages 3-4");

// rank 25 of the union of sorted k (26) and sorted p (25): the minimum over
// i of max(p[i-1], k[25-i]), each a bound on the 26 lowest; a tree of mins.
__device__ __forceinline__ float rank_of_two(const float (&k)[26],
                                             const float* p) {
  float t[26];
  t[0] = k[25];
#pragma unroll
  for (int i = 1; i <= 25; ++i) t[i] = fmaxf(p[i - 1], k[25 - i]);
#pragma unroll
  for (int w = 1; w < 26; w *= 2)
#pragma unroll
    for (int i = 0; i + w < 26; i += 2 * w) t[i] = fminf(t[i], t[i + w]);
  return t[0];
}

__global__ void __launch_bounds__(THREADS)
    median5_kernel(const float* __restrict__ xp, float* __restrict__ out,
                   int Z, int Y, int X) {
  extern __shared__ float smem[];
  float* planes = smem;                    // [TY][CX][PL]
  float* cols = smem + SM_PLANES;          // [5][CY][CX], stages 1-2
  float* m2 = smem + SM_PLANES;            // [TY][NM2][M2S], stages 3-4
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int bz = blockIdx.z;               // b * Z + z
  const int z = bz % Z, b = bz / Z;
  const int Yp = Y + 4, Xp = X + 4;
  const long long plane = (long long)Yp * Xp;
  const float* src = xp + ((long long)b * (Z + 4) + z) * plane;

  // 1. sorted z-columns of the tile and its halo (clamped at ragged edges)
#pragma unroll
  for (int r = 0; r < CY * CX / THREADS; ++r) {
    const int q = tid + r * THREADS;
    const int yy = q / CX, xx = q % CX;
    const float* s = src + (long long)min(y0 + yy, Yp - 1) * Xp +
                     min(x0 + xx, Xp - 1);
    float v[5], o[5];
#pragma unroll
    for (int d = 0; d < 5; ++d) v[d] = s[d * plane];
    sort5(v, o);
#pragma unroll
    for (int k = 0; k < 5; ++k) cols[(k * CY + yy) * CX + xx] = o[k];
  }
  __syncthreads();

  // 2. sorted (z, y) planes of rows 2j and 2j+1 at column xx
  {
    const int j = tid / CX, xx = tid % CX;
    float c[6][5];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int k = 0; k < 5; ++k)
        c[i][k] = cols[(k * CY + 2 * j + i) * CX + xx];
    float v10[10], a[10], a2[10], v20[20], core[20], v25[25], p[25];
#pragma unroll
    for (int k = 0; k < 5; ++k) { v10[k] = c[1][k]; v10[5 + k] = c[2][k]; }
    merge_5_5(v10, a);
#pragma unroll
    for (int k = 0; k < 5; ++k) { v10[k] = c[3][k]; v10[5 + k] = c[4][k]; }
    merge_5_5(v10, a2);
#pragma unroll
    for (int k = 0; k < 10; ++k) { v20[k] = a[k]; v20[10 + k] = a2[k]; }
    merge_10_10(v20, core);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int k = 0; k < 20; ++k) v25[k] = core[k];
#pragma unroll
      for (int k = 0; k < 5; ++k) v25[20 + k] = c[e ? 5 : 0][k];
      merge_20_5(v25, p);
      float* dst = planes + ((2 * j + e) * CX + xx) * PL;
#pragma unroll
      for (int k = 0; k < PL; ++k) dst[k] = p[k];
    }
  }
  __syncthreads();

  // 3. sorted pairs of planes (2k+1, 2k+2); the columns are dead by now
  if (tid < TY * NM2) {
    const int r = tid / NM2, k = tid % NM2;
    const float* s = planes + (r * CX + 2 * k + 1) * PL;
    float v[50], o[50];
#pragma unroll
    for (int i = 0; i < 50; ++i) v[i] = s[i];
    merge_25_25(v, o);
    float* dst = m2 + (r * NM2 + k) * M2S;
#pragma unroll
    for (int i = 0; i < 50; ++i) dst[i] = o[i];
  }
  __syncthreads();

  // 4. outputs x0 + 2k and x0 + 2k + 1 of row y0 + r
  if (tid < TY * (TX / 2)) {
    const int r = tid / (TX / 2), k = tid % (TX / 2);
    const float* s = m2 + (r * NM2 + k) * M2S;
    float v[100], kept[26];
#pragma unroll
    for (int i = 0; i < 50; ++i) {
      v[i] = s[i];
      v[50 + i] = s[M2S + i];
    }
    merge_50_50_keep(v, kept);
    const float* pl = planes + (r * CX + 2 * k) * PL;
    const int y = y0 + r, x = x0 + 2 * k;
    if (y < Y) {
      float* dst = out + ((long long)bz * Y + y) * X + x;
      if (x < X) dst[0] = rank_of_two(kept, pl);
      if (x + 1 < X) dst[1] = rank_of_two(kept, pl + 5 * PL);
    }
  }
}

}  // namespace

extern "C" int median5_f32(const void* xp, void* out, int B, int Z, int Y,
                           int X, void* stream) {
  const long long bz = (long long)B * Z;
  if (bz > 65535 || (Y + TY - 1) / TY > 65535)
    return (int)cudaErrorInvalidValue;
  static bool opted_in[64];  // the shared-memory opt-in, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(median5_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SM_BYTES);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  const dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, (unsigned)bz);
  median5_kernel<<<grid, THREADS, SM_BYTES, (cudaStream_t)stream>>>(
      (const float*)xp, (float*)out, Z, Y, X);
  return (int)cudaGetLastError();
}
