// Dynamic W8A8 int8 for Hopper (sm_90a): a row quantizer (kernel H) and an
// s8 tensor-core GEMM with a fused dequantizing epilogue (kernel I).
//
// Replaces no Pallas kernel. The JAX package computes int8_dynamic_matmul
// (isegprobe_tpu/ops/quant.py:44-64) as XLA ops: per-row absmax scales of
// the activations and of the weight's output channels, an int8 x int8 ->
// int32 dot_general, and the f32 rescale. These two kernels are that
// function on the card, with XLA's rounding:
//     s = max(max|x_row| / 127, 1e-8)      true f32 division
//     q = rint(x / s)                       true division, half to even
//     y = (f32(acc) * sx_m) * sw_n (+ b_n)  left to right, no FMA
// written in the output dtype. Every operation is an explicitly rounded
// intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn), which nvcc never contracts
// into an FMA, so both kernels equal their plain PyTorch versions bit for
// bit (the integer sum is exact).
//
// H, iseg_quantize_rows: [R, K] f32 or bf16 -> q int8 [R, K], s f32 [R].
// Bound on this card: bytes, each input read once (2 or 4 B an element),
// q written once (1 B), one scale a row; a handful of operations a byte.
// Design: one warp a row, eight rows a block; each lane loads its share of
// the row with 16-byte loads into registers (K <= 3072: 96 values a lane),
// the warp reduces the absmax with shuffles, and the row is quantized and
// written from the registers, so x is read from device memory once.
//
// I, iseg_int8_gemm: a [M, K] s8 (rows of x) times b [N, K] s8 (rows of the
// weight, the output channels) -> int32 on the tensor cores, then the
// epilogue above in f32, written as f32 or bf16. bias_after_cast adds the
// bias after the cast, in the output dtype (MaskCLIP's packed in_proj,
// isegprobe_tpu/models/featurizers/maskclip.py:63-72). Bound on this card:
// operations at the flagship's widths (2·M·N·K at 1,979 int8 TOP/s against
// M·K + N·K bytes in and M·N·2 out). Design: 128 x 128 output tiles, 8
// warps of 64 x 32, K in steps of 64 staged through shared memory by
// cp.async in two stages (rows padded to 80 bytes: ldmatrix reads them
// without bank conflicts), fragments by ldmatrix.x4, products by
// mma.sync.m16n8k32 s8 with s32 accumulators in registers; the ragged M and
// N edges are zero-filled on load and masked on store. K % 32 == 0 and
// N % 8 == 0 (every width of the three towers is a multiple of 128).
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- kernel H

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int VEC>
struct alignas(VEC) QPack {
  int8_t v[VEC];
};

template <typename T, int VEC, int MAXV>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int rows, int k) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (long)row * k;
  int8_t* qr = q + (long)row * k;

  float v[MAXV];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < MAXV / VEC; ++c) {
    const int i = (c * 32 + lane) * VEC;
    if (i < k) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[c * VEC + e] = to_f32(p.v[e]);
        amax = fmaxf(amax, fabsf(v[c * VEC + e]));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  if (lane == 0) s[row] = scale;

#pragma unroll
  for (int c = 0; c < MAXV / VEC; ++c) {
    const int i = (c * 32 + lane) * VEC;
    if (i < k) {
      QPack<VEC> p;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        p.v[e] = (int8_t)__float2int_rn(__fdiv_rn(v[c * VEC + e], scale));
      *reinterpret_cast<QPack<VEC>*>(qr + i) = p;
    }
  }
}

template <typename T, int VEC>
void launch_rows_vec(const void* x, void* q, void* s, int rows, int k,
                     cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (k <= 32 * 32)
    quantize_rows_kernel<T, VEC, 32><<<grid, block, 0, stream>>>(
        xp, qp, sp, rows, k);
  else
    quantize_rows_kernel<T, VEC, 96><<<grid, block, 0, stream>>>(
        xp, qp, sp, rows, k);
}

template <typename T>
cudaError_t launch_rows(const void* x, void* q, void* s, int rows, int k,
                        cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  const bool aligned = k % vec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % vec == 0;
  if (aligned)
    launch_rows_vec<T, vec>(x, q, s, rows, k, stream);
  else
    launch_rows_vec<T, 1>(x, q, s, rows, k, stream);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- kernel I

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kRowBytes = BK + 16;  // 80: ldmatrix rows hit distinct banks
constexpr int kStages = 2;
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;     // a warp's output tile
constexpr int MT = WM / 16, NT = WN / 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, T a, T b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      __nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// One output value: (f32(acc) * sx) * sw, the bias added in f32 before the
// cast or, with bias_after, rounded to T and added after it, as
// `y.astype(T) + bias.astype(T)`.
template <typename T, typename B>
__device__ __forceinline__ T epilogue(int acc, float sx, float sw,
                                      const B* bias, int n, bool has_bias,
                                      bool bias_after) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  if (!has_bias) return from_f32<T>(y);
  const float b = to_f32(bias[n]);
  if (!bias_after) return from_f32<T>(__fadd_rn(y, b));
  return from_f32<T>(
      __fadd_rn(to_f32(from_f32<T>(y)), to_f32(from_f32<T>(b))));
}

template <typename T, typename B>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const B* __restrict__ bias, T* __restrict__ out, int m,
                 int n, int k, int has_bias, int bias_after) {
  __shared__ __align__(128) int8_t sa[kStages][BM * kRowBytes];
  __shared__ __align__(128) int8_t sb[kStages][BN * kRowBytes];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (k + BK - 1) / BK;

  // each thread copies 2 chunks of 16 bytes of each tile a stage
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, col = (c & 3) * 16;
      const bool kin = k0 + col < k;
      const int gm = m0 + r, gn = n0 + r;
      const bool va = kin && gm < m, vb = kin && gn < n;
      cp_async16(&sa[stage][r * kRowBytes + col],
                 va ? a + (long)gm * k + k0 + col : a, va);
      cp_async16(&sb[stage][r * kRowBytes + col],
                 vb ? b + (long)gn * k + k0 + col : b, vb);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest: stage kt is in
    __syncthreads();
    const int8_t* ta = sa[kt & 1];
    const int8_t* tb = sb[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t fa[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * WM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk + (lane >> 4) * 16;
        ldmatrix_x4(fa[i], ta + r * kRowBytes + c);
      }
      uint32_t fb[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int r = wn * WN + j * 8 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk + ((lane >> 3) & 1) * 16;
        uint32_t t[4];
        ldmatrix_x4(t, tb + r * kRowBytes + c);
        fb[j][0] = t[0];
        fb[j][1] = t[1];
        fb[j + 1][0] = t[2];
        fb[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], fa[i], fb[j][0],
                                            fb[j][1]);
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * WM + i * 16 + g + h * 8;
      if (r >= m) continue;
      const float sxr = sx[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wn * WN + j * 8 + t4 * 2;
        if (c >= n) continue;
        const T y0 = epilogue<T, B>(acc[i][j][2 * h], sxr, sw[c], bias, c,
                                    has_bias, bias_after);
        const T y1 = epilogue<T, B>(acc[i][j][2 * h + 1], sxr, sw[c + 1],
                                    bias, c + 1, has_bias, bias_after);
        store2<T>(out + (long)r * n + c, y0, y1);
      }
    }
  }
}

template <typename T, typename B>
cudaError_t launch_gemm(const void* a, const void* b, const void* sx,
                        const void* sw, const void* bias, void* out, int m,
                        int n, int k, int has_bias, int bias_after,
                        cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_gemm_kernel<T, B><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const B*>(bias), static_cast<T*>(out), m, n, k, has_bias,
      bias_after);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, k] contiguous of x_dtype (0 = float32, 1 = bfloat16), 1 <= k <=
// 3072; q [rows, k] int8 and s [rows] float32. Returns cudaGetLastError().
int iseg_quantize_rows(const void* x, void* q, void* s, int rows, int k,
                       int x_dtype, void* stream) {
  if (rows < 1 || k < 1 || k > 32 * 96) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return (int)launch_rows<float>(x, q, s, rows, k, st);
  if (x_dtype == 1)
    return (int)launch_rows<__nv_bfloat16>(x, q, s, rows, k, st);
  return (int)cudaErrorInvalidValue;
}

// a [m, k] and b [n, k] int8, contiguous, 16-byte aligned; sx [m] and sw [n]
// float32; bias [n] of bias_dtype (read only when has_bias); out [m, n] of
// out_dtype (0 = float32, 1 = bfloat16). k % 32 == 0, n % 8 == 0.
// Returns cudaGetLastError().
int iseg_int8_gemm(const void* a, const void* b, const void* sx,
                   const void* sw, const void* bias, void* out, int m, int n,
                   int k, int out_dtype, int bias_dtype, int has_bias,
                   int bias_after, void* stream) {
  if (m < 1 || n < 8 || k < 32 || k % 32 || n % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0 && bias_dtype == 0)
    return (int)launch_gemm<float, float>(a, b, sx, sw, bias, out, m, n, k,
                                          has_bias, bias_after, st);
  if (out_dtype == 0 && bias_dtype == 1)
    return (int)launch_gemm<float, __nv_bfloat16>(
        a, b, sx, sw, bias, out, m, n, k, has_bias, bias_after, st);
  if (out_dtype == 1 && bias_dtype == 0)
    return (int)launch_gemm<__nv_bfloat16, float>(
        a, b, sx, sw, bias, out, m, n, k, has_bias, bias_after, st);
  if (out_dtype == 1 && bias_dtype == 1)
    return (int)launch_gemm<__nv_bfloat16, __nv_bfloat16>(
        a, b, sx, sw, bias, out, m, n, k, has_bias, bias_after, st);
  return (int)cudaErrorInvalidValue;
}

const char* iseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
