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
// output voxel the coordinates are clamped to [0, n-1]; with i0 = floor and
// t = c - i0, order 3 sums 4^3 taps at coeff[i0 + 0..3] with the cubic
// B-spline weights of ops/warp.py:_bspline_weights, order 1 sums 2^3 taps
// at coeff[i0 + 0..1] with weights (1 - t, t). Separable accumulation:
// x within a row, then y, then z, in fp32.
//
// Bound: bytes. The coefficient volume and three coordinate volumes are
// read once and the output written once: about 340 MB at the 64x512x512
// output warp, 0.10 ms at 3.35 TB/s; ~150 flops a voxel stay under the
// fp32 rate.
//
// Design: one thread per output voxel, no shared memory. Smooth flows make
// neighbouring threads read neighbouring coefficient rows, so the 64 taps
// come mostly from L1/L2. The TPU kernel's window tiers, one-hot matmuls
// and int8/bf16 limbs served a machine without a fast gather; they go.

#include <cuda_runtime.h>

namespace {

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
__global__ void map_coords_kernel(const float* __restrict__ coeff, int Ye,
                                  int Xe, const float* __restrict__ cz,
                                  const float* __restrict__ cy,
                                  const float* __restrict__ cx,
                                  float* __restrict__ out, long long n_out,
                                  int Z, int Y, int X) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_out; i += (long long)gridDim.x * blockDim.x) {
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
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      float acc_y = 0.0f;
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const float* row =
            coeff + ((long long)(z0 + a) * Ye + (y0 + b)) * Xe + x0;
        float acc_x = 0.0f;
#pragma unroll
        for (int d = 0; d < K; ++d) acc_x += wx[d] * row[d];
        acc_y += wy[b] * acc_x;
      }
      acc += wz[a] * acc_y;
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" int map_coords_f32(const void* coeff, int Ze, int Ye, int Xe,
                              const void* cz, const void* cy, const void* cx,
                              void* out, long long n_out, int Z, int Y, int X,
                              int order, void* stream) {
  const int threads = 256;
  long long blocks = (n_out + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 3) {
    map_coords_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)coeff, Ye, Xe, (const float*)cz, (const float*)cy,
        (const float*)cx, (float*)out, n_out, Z, Y, X);
  } else if (order == 1) {
    map_coords_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)coeff, Ye, Xe, (const float*)cz, (const float*)cy,
        (const float*)cx, (float*)out, n_out, Z, Y, X);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  (void)Ze;
  return (int)cudaGetLastError();
}
