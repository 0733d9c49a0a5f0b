// One-pass row LayerNorm for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel isegprobe_tpu/ops/layernorm.py:_ln_pallas
// (kernel _ln_kernel, pallas_call at :70). Per row of D values:
//     mean = E[x], var = max(0, E[x^2] - mean^2)   (fast variance, f32)
//     y = (x - mean) * rsqrt(var + eps) * gamma + beta, written in x's dtype.
// The statistics cover the first `real` of the D channels (flax's
// LayerNorm(mask=): LoftUp's zero-padded layout, 404 of 512 and 203 of 256);
// every channel is normalised with them. real = D is the plain LayerNorm.
//
// Bound on this card: bytes. Each row is read once and written once
// (2 * rows * D * sizeof(T), plus gamma and beta once), a few operations per
// byte, far below the compute rates.
//
// Design: one warp per row, eight rows per block. Each lane loads its share
// of the row with 16-byte vector loads (4 f32 or 8 bf16 values) into
// registers, accumulates sum and sum of squares in f32 in the same pass, and
// the warp reduces both with shuffles. The normalised row is written from the
// registers, so x is read from device memory exactly once. D <= 1024 (32
// values a lane); the wrapper raises beyond that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kMaxPerLane = 32;  // D <= 32 * kMaxPerLane = 1024

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
          const W* __restrict__ beta, T* __restrict__ y, int rows, int d,
          int real, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (long)row * d;
  T* yr = y + (long)row * d;

  float v[kMaxPerLane];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane / VEC; ++k) {
    const int i = (k * 32 + lane) * VEC;
    if (i < d) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(p.v[e]);
        v[k * VEC + e] = f;
        if (i + e < real) {
          s += f;
          ss = fmaf(f, f, ss);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float inv_d = 1.f / (float)real;
  const float mean = s * inv_d;
  const float var = fmaxf(0.f, ss * inv_d - mean * mean);
  const float rstd = rsqrtf(var + eps);

#pragma unroll
  for (int k = 0; k < kMaxPerLane / VEC; ++k) {
    const int i = (k * 32 + lane) * VEC;
    if (i < d) {
      Pack<T, VEC> p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float g = to_f32(gamma[i + e]);
        const float b = to_f32(beta[i + e]);
        p.v[e] = from_f32<T>((v[k * VEC + e] - mean) * rstd * g + b);
      }
      *reinterpret_cast<Pack<T, VEC>*>(yr + i) = p;
    }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* g, const void* b, void* y,
                   int rows, int d, int real, float eps,
                   cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const bool aligned = d % vec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(g);
  const W* bp = static_cast<const W*>(b);
  T* yp = static_cast<T*>(y);
  if (aligned)
    ln_kernel<T, W, vec><<<grid, block, 0, stream>>>(xp, gp, bp, yp, rows, d,
                                                     real, eps);
  else
    ln_kernel<T, W, 1><<<grid, block, 0, stream>>>(xp, gp, bp, yp, rows, d,
                                                   real, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x and y [rows, d] contiguous of x_dtype; gamma and beta [d] of w_dtype;
// statistics over the first real channels (1 <= real <= d).
// dtypes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
int iseg_layernorm(const void* x, const void* gamma, const void* beta,
                   void* y, int rows, int d, int real, float eps, int x_dtype,
                   int w_dtype, void* stream) {
  if (rows < 1 || d < 1 || d > 32 * kMaxPerLane || real < 1 || real > d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch<float, float>(x, gamma, beta, y, rows, d, real, eps,
                                           s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, rows,
                                                     d, real, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, gamma, beta, y, rows, d, real,
                                                  eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, gamma, beta, y, rows, d, real,
                                                  eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
