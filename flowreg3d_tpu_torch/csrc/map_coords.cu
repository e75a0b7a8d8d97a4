// Tricubic B-spline (order 3) or trilinear (order 1) sampling, fp32, of a
// coefficient volume at clipped coordinates, scipy map_coordinates
// mode='nearest' semantics for in-range coordinates.
//
// Replaces: flowreg3d_tpu/ops/warp_pallas.py _kernel (:131, through
// map_coordinates_windowed), used by every pyramid-level warp and by the
// full-resolution output warp.
//
// Function: coeff is (Z+3, Y+3, X+3) B-spline coefficients with tap i at
// index i+1 (order 3; ops/warp.py:bspline_prefilter), or the volume padded
// by one edge sample at the far faces, (Z+1, Y+1, X+1) (order 1). For each
// output voxel of the (Oz, Oy, Ox) coordinate volumes the coordinates are
// clamped to [0, n-1]; with i0 = floor and t = c - i0, order 3 sums 4^3
// taps at coeff[i0 + 0..3] with the cubic B-spline weights of
// ops/warp.py:_bspline_weights, order 1 sums 2^3 taps at coeff[i0 + 0..1]
// with weights (1 - t, t). Separable accumulation: x within a row, then y,
// then z, in fp32.
//
// Bound: bytes. The coefficient volume and three coordinate volumes are
// read once and the output written once: about 340 MB at the 64x512x512
// output warp, 0.10 ms at 3.35 TB/s; ~150 flops a voxel stay under the
// fp32 rate.
//
// Design: one thread per output, no shared memory; a block takes a tile of
// 32 x 8 outputs of one output plane (a warp per output row), so the
// neighbouring rows' taps, which overlap in y and z, come from one SM's
// L1. Offsets are 32-bit (the wrapper checks that they fit) and the kernel
// is held to 32 registers, so that 8 blocks of 256 threads fill an SM:
// the kernel is bound by issuing its few hundred instructions an output
// (the fp32 products and sums stay unfused for bit-equality), and the
// full occupancy hides the gathers' latency. A shared-memory tap box per tile
// (copied by cp.async, the TPU kernel's window tiers,
// ops/warp_pallas.py:321-330) was slower in every variant tried on the
// H100: L1 already holds a tile's taps, a warp's 32 taps of one row span
// more than 32 banks under a stretching flow, and the block barriers
// exposed the copy's latency.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;   // a warp per output row
constexpr int kTileY = 8;    // output rows of a block
constexpr int kMinBlocks = 8;  // resident blocks an SM: <= 32 registers

// operation for operation the plain version's arithmetic (built with
// --fmad=false, so each product and sum rounds on its own)
__device__ __forceinline__ void cubic_weights(float t, float w[4]) {
  constexpr float kSixth = (float)(1.0 / 6.0);
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = (1.0f - 3.0f * t + 3.0f * t2 - t3) * kSixth;
  w[1] = (4.0f - 6.0f * t2 + 3.0f * t3) * kSixth;
  w[2] = (1.0f + 3.0f * t + 3.0f * t2 - 3.0f * t3) * kSixth;
  w[3] = t3 * kSixth;
}

// clamp to [0, n-1] (NaN goes to 0), then split into base index + fraction
__device__ __forceinline__ int split(float c, int n, float* t) {
  c = fminf(fmaxf(c, 0.0f), (float)(n - 1));
  const float f = floorf(c);
  *t = c - f;
  return (int)f;
}

template <int K>
__global__ void __launch_bounds__(kTileX * kTileY, kMinBlocks)
    map_coords_kernel(const float* __restrict__ coeff, int Ye, int Xe,
                      const float* __restrict__ cz,
                      const float* __restrict__ cy,
                      const float* __restrict__ cx, float* __restrict__ out,
                      int Oy, int Ox, int Z, int Y, int X) {
  const int ox = blockIdx.x * kTileX + threadIdx.x;
  const int oy = blockIdx.y * kTileY + threadIdx.y;
  if (ox >= Ox || oy >= Oy) return;
  const int i = (blockIdx.z * Oy + oy) * Ox + ox;
  float tz, ty, tx;
  const int z0 = split(cz[i], Z, &tz);
  const int y0 = split(cy[i], Y, &ty);
  const int x0 = split(cx[i], X, &tx);
  float wz[K], wy[K], wx[K];
  if constexpr (K == 4) {
    cubic_weights(tz, wz);
    cubic_weights(ty, wy);
    cubic_weights(tx, wx);
  } else {
    wz[0] = 1.0f - tz; wz[K - 1] = tz;
    wy[0] = 1.0f - ty; wy[K - 1] = ty;
    wx[0] = 1.0f - tx; wx[K - 1] = tx;
  }
  const float* p = coeff + (z0 * Ye + y0) * Xe + x0;
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < K; ++a) {
    float acc_y = 0.0f;
#pragma unroll
    for (int b = 0; b < K; ++b) {
      const float* row = p + (a * Ye + b) * Xe;
      float acc_x = 0.0f;
#pragma unroll
      for (int d = 0; d < K; ++d) acc_x += wx[d] * row[d];
      acc_y += wy[b] * acc_x;
    }
    acc += wz[a] * acc_y;
  }
  out[i] = acc;
}

}  // namespace

// coeff (Ze, Ye, Xe); coordinates and out (Oz, Oy, Ox); (Z, Y, X) the
// sampled volume. The caller keeps coeff and out below 2^31 elements.
extern "C" int map_coords_f32(const void* coeff, int Ze, int Ye, int Xe,
                              const void* cz, const void* cy, const void* cx,
                              void* out, int Oz, int Oy, int Ox, int Z, int Y,
                              int X, int order, void* stream) {
  (void)Ze;
  const long long gy = (Oy + kTileY - 1) / kTileY;
  if (gy > 65535 || Oz > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((Ox + kTileX - 1) / kTileX, (unsigned)gy, Oz);
  const dim3 block(kTileX, kTileY);
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)coeff;
  const float *pz = (const float*)cz, *py = (const float*)cy,
              *px = (const float*)cx;
  if (order == 3)
    map_coords_kernel<4><<<grid, block, 0, s>>>(c, Ye, Xe, pz, py, px,
                                                (float*)out, Oy, Ox, Z, Y, X);
  else if (order == 1)
    map_coords_kernel<2><<<grid, block, 0, s>>>(c, Ye, Xe, pz, py, px,
                                                (float*)out, Oy, Ox, Z, Y, X);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
