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
//
// Backward (iseg_layernorm_bwd): the exact VJP of the forward's function
// (the JAX package's _ln_pallas_ad_bwd, jax.vjp of _ln_jnp at :93-96). With
// a = dy * gamma, S1 = sum a and S2 = sum a (x - mean), both over all D
// channels, and c the clamp's gradient (1 where E[x^2] - mean^2 > 0, 0 where
// it is < 0, 1/2 at a tie, as jnp.maximum's VJP):
//     dx_k = rstd a_k - [k < real] (rstd / real) (S1 + rstd^2 (x_k - mean) c S2)
//     dgamma = sum over rows of dy (x - mean) rstd,  dbeta = sum over rows of dy.
// Bound: bytes, 3 * rows * D * sizeof(T) (x and dy read, dx written once).
// Design: one warp a row, as the forward, with x and dy loaded by 16-byte
// vectors into registers; the row's sum and sum of squares are taken in the
// forward's order and with its expressions, so mean and rstd are the
// forward's bit for bit and the forward saves nothing; S1 and S2 are two
// more shuffle reductions. A lane holds NP packs (the smallest of 256, 512
// or 1024 channels that covers D), so registers follow D. For dx alone a
// block takes 8 rows, one a warp. When gamma or beta needs a gradient the
// grid is fixed (iseg_layernorm_bwd_blocks: as many blocks as the card
// holds at once) and its warps walk the rows, each lane summing dgamma and
// dbeta for its own channels in f32 registers; a block adds its 8 warps
// in order through shared memory into a [grid, D] scratch row, and
// ln_bwd_columns adds the grid's rows of each column in order and casts to
// gamma's dtype: no atomics, so two runs agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// The clamp's gradient: jnp.maximum(0, v) passes 1 above the tie, 0 below
// it and 1/2 at it.
__device__ __forceinline__ float clamp_grad(float raw) {
  return raw > 0.f ? 1.f : (raw == 0.f ? 0.5f : 0.f);
}

// x and dy of the row at `off`, NP packs a lane, kept in their own dtype
// (bf16 halves the registers a lane holds)
template <typename T, int VEC, int NP>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ dy, long off,
                                         int d, int lane,
                                         Pack<T, VEC> (&px)[NP],
                                         Pack<T, VEC> (&pg)[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = (k * 32 + lane) * VEC;
    if (i < d) {
      px[k] = *reinterpret_cast<const Pack<T, VEC>*>(x + off + i);
      pg[k] = *reinterpret_cast<const Pack<T, VEC>*>(dy + off + i);
    }
  }
}

// One row's backward from its x and dy packs: dx written (when dx is not
// null), and with AFFINE this lane's dgamma and dbeta sums added to.
template <typename T, typename W, int VEC, int NP, bool AFFINE>
__device__ __forceinline__ void row_backward(
    const Pack<T, VEC> (&px)[NP], const Pack<T, VEC> (&pg)[NP],
    const W* __restrict__ gamma, T* __restrict__ dxr, int d, int real,
    float eps, int lane, float* acc_g, float* acc_b) {
  // the forward's statistics, in its order
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = (k * 32 + lane) * VEC;
    if (i < d) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(px[k].v[e]);
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
  const float raw = ss * inv_d - mean * mean;
  const float var = fmaxf(0.f, raw);
  const float rstd = rsqrtf(var + eps);

  // S1 = sum a, S2 = sum a (x - mean) over every channel
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = (k * 32 + lane) * VEC;
    if (i < d) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a = to_f32(pg[k].v[e]) * to_f32(gamma[i + e]);
        s1 += a;
        s2 = fmaf(a, to_f32(px[k].v[e]) - mean, s2);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float k1 = rstd * inv_d;
  const float k2 = rstd * rstd * clamp_grad(raw) * s2;

#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int i = (k * 32 + lane) * VEC;
    if (i < d) {
      Pack<T, VEC> p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xc = to_f32(px[k].v[e]) - mean;
        const float dyf = to_f32(pg[k].v[e]);
        const float a = dyf * to_f32(gamma[i + e]);
        float r = rstd * a;
        if (i + e < real) r -= k1 * fmaf(xc, k2, s1);
        p.v[e] = from_f32<T>(r);
        if constexpr (AFFINE) {
          acc_g[k * VEC + e] = fmaf(dyf, xc * rstd, acc_g[k * VEC + e]);
          acc_b[k * VEC + e] += dyf;
        }
      }
      if (dxr != nullptr) *reinterpret_cast<Pack<T, VEC>*>(dxr + i) = p;
    }
  }
}

// One block an SM is enough (a warp keeps its row's loads in flight): the
// bound lets ptxas take the registers a lane's packs need, where it would
// otherwise stop at 64 or 128 and spill.
template <typename T, typename W, int VEC, int NP, bool AFFINE>
__global__ void __launch_bounds__(kRowsPerBlock * 32, 1)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ part, int rows, int d, int real,
              float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int N = NP * VEC;
  float acc_g[AFFINE ? N : 1], acc_b[AFFINE ? N : 1];
  if constexpr (AFFINE) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc_g[j] = acc_b[j] = 0.f;
  }
  // a block for every 8 rows, or with dgamma and dbeta a fixed grid whose
  // warps walk the rows
  const int stride = gridDim.x * kRowsPerBlock;
  int row = blockIdx.x * kRowsPerBlock + warp;
  auto dx_row = [&](int r) {
    return dx == nullptr ? nullptr : dx + (long)r * d;
  };
  for (; row < rows; row += stride) {
    Pack<T, VEC> px[NP], pg[NP];
    load_row(x, dy, (long)row * d, d, lane, px, pg);
    row_backward<T, W, VEC, NP, AFFINE>(px, pg, gamma, dx_row(row), d, real,
                                        eps, lane, acc_g, acc_b);
  }
  if constexpr (AFFINE) {
    // the block's 8 warps in order, dgamma then dbeta, into part[2][grid][d]
    __shared__ float red[kRowsPerBlock][32 * kMaxPerLane];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int i = (k * 32 + lane) * VEC;
        if (i < d) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            red[warp][i + e] = which == 0 ? acc_g[k * VEC + e]
                                          : acc_b[k * VEC + e];
        }
      }
      __syncthreads();
      float* out = part + ((long)which * gridDim.x + blockIdx.x) * d;
      for (int c = threadIdx.x; c < d; c += blockDim.x) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kRowsPerBlock; ++w) t += red[w][c];
        out[c] = t;
      }
      __syncthreads();
    }
  }
}

// dgamma and dbeta: each column of part[2][blocks][d] summed over the blocks
// in order, cast to the weights' dtype
template <typename W>
__global__ void ln_bwd_columns(const float* __restrict__ part,
                               W* __restrict__ dgamma, W* __restrict__ dbeta,
                               int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * d) return;
  const int which = c >= d;
  const int col = c - which * d;
  const float* p = part + (long)which * blocks * d + col;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b) t += p[(long)b * d];
  (which ? dbeta : dgamma)[col] = from_f32<W>(t);
}

template <typename T, typename W>
using BwdKernel = void (*)(const T*, const W*, const T*, T*, float*, int, int,
                           int, float);

// The backward for d: NP packs a lane, the smallest of 256, 512 or 1024
// channels covering d
template <typename T, typename W, int VEC, bool AFFINE>
BwdKernel<T, W> bwd_kernel(int d) {
  constexpr int np256 = 256 / (32 * VEC);
  if (d <= 256) return ln_bwd_kernel<T, W, VEC, np256, AFFINE>;
  if (d <= 512) return ln_bwd_kernel<T, W, VEC, 2 * np256, AFFINE>;
  return ln_bwd_kernel<T, W, VEC, 4 * np256, AFFINE>;
}

// The grid of the backward with dgamma and dbeta (16-byte rows): as many
// blocks as the card holds at once, at most one for every 8 rows. Negative:
// a CUDA error.
template <typename T, typename W>
int affine_blocks(int rows, int d) {
  constexpr int vec = 16 / sizeof(T);
  const BwdKernel<T, W> kernel = d % vec == 0
                                     ? bwd_kernel<T, W, vec, true>(d)
                                     : bwd_kernel<T, W, 1, true>(d);
  // blocks an SM of each kernel, asked at its first call
  static int per_sm[3][2] = {};
  int& fit = per_sm[d <= 256 ? 0 : d <= 512 ? 1 : 2][d % vec == 0];
  cudaError_t err = cudaSuccess;
  if (fit == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        kRowsPerBlock * 32, 0);
    if (err == cudaSuccess && fit < 1) fit = 1;
  }
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  return std::min((rows + kRowsPerBlock - 1) / kRowsPerBlock, fit * sms);
}

// dx alone on a block for every 8 rows; with dgamma and dbeta on `blocks`
// blocks, then ln_bwd_columns
template <typename T, typename W, bool AFFINE>
cudaError_t launch_bwd_affine(const void* x, const void* g, const void* dy,
                              void* dx, float* part, void* dg, void* db,
                              int rows, int d, int real, float eps,
                              int blocks, cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const bool aligned = d % vec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const BwdKernel<T, W> kernel = aligned ? bwd_kernel<T, W, vec, AFFINE>(d)
                                         : bwd_kernel<T, W, 1, AFFINE>(d);
  const int grid =
      AFFINE ? blocks : (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  kernel<<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(g),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, d, real,
      eps);
  if constexpr (AFFINE) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int threads = 256;
    ln_bwd_columns<W><<<(2 * d + threads - 1) / threads, threads, 0,
                        stream>>>(part, static_cast<W*>(dg),
                                  static_cast<W*>(db), blocks, d);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* g, const void* dy, void* dx,
                       float* part, void* dg, void* db, int rows, int d,
                       int real, float eps, int blocks,
                       cudaStream_t stream) {
  if (dg != nullptr)
    return launch_bwd_affine<T, W, true>(x, g, dy, dx, part, dg, db, rows, d,
                                         real, eps, blocks, stream);
  return launch_bwd_affine<T, W, false>(x, g, dy, dx, part, dg, db, rows, d,
                                        real, eps, blocks, stream);
}

// Nothing: the floor of a launch on the forward's grid (a measurement).
__global__ void empty_kernel() {}

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

// The backward: x and dy [rows, d] contiguous of x_dtype, gamma [d] of
// w_dtype. dx (x_dtype, [rows, d]) may be null when x needs no gradient.
// With dgamma and dbeta ([d] of w_dtype; both or neither) it also takes
// their gradients on a grid of `blocks` blocks (iseg_layernorm_bwd_blocks)
// through part, f32 scratch of [2, blocks, d], and launches two kernels;
// else one. Returns cudaGetLastError().
int iseg_layernorm_bwd(const void* x, const void* gamma, const void* dy,
                       void* dx, float* part, void* dgamma, void* dbeta,
                       int rows, int d, int real, float eps, int x_dtype,
                       int w_dtype, int blocks, void* stream) {
  if (rows < 1 || d < 1 || d > 32 * kMaxPerLane || real < 1 || real > d ||
      (dgamma == nullptr) != (dbeta == nullptr) ||
      (dgamma == nullptr && dx == nullptr) ||
      (dgamma != nullptr && (part == nullptr || blocks < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch_bwd<float, float>(x, gamma, dy, dx, part, dgamma,
                                         dbeta, rows, d, real, eps, blocks, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, gamma, dy, dx, part, dgamma, dbeta, rows, d, real, eps, blocks, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch_bwd<__nv_bfloat16, float>(
        x, gamma, dy, dx, part, dgamma, dbeta, rows, d, real, eps, blocks, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)launch_bwd<float, __nv_bfloat16>(
        x, gamma, dy, dx, part, dgamma, dbeta, rows, d, real, eps, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// The grid iseg_layernorm_bwd takes dgamma and dbeta on for rows x d of
// these dtypes, on the current device: at least 1, or minus a CUDA error.
int iseg_layernorm_bwd_blocks(int rows, int d, int x_dtype, int w_dtype) {
  if (rows < 1 || d < 1 || d > 32 * kMaxPerLane)
    return -(int)cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0) return affine_blocks<float, float>(rows, d);
  if (x_dtype == 1 && w_dtype == 1)
    return affine_blocks<__nv_bfloat16, __nv_bfloat16>(rows, d);
  if (x_dtype == 1 && w_dtype == 0)
    return affine_blocks<__nv_bfloat16, float>(rows, d);
  if (x_dtype == 0 && w_dtype == 1)
    return affine_blocks<float, __nv_bfloat16>(rows, d);
  return -(int)cudaErrorInvalidValue;
}

// An empty kernel on the forward's grid for `rows` rows: what a launch of
// that shape costs on this card, for the forward's timings to be read
// against. Returns cudaGetLastError().
int iseg_layernorm_empty(int rows, void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  empty_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock,
                 kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
